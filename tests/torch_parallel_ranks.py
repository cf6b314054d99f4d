"""The rank side of tests/test_torch_parallel.py: what each rank of the
module's one 2-rank gloo group runs (:func:`rank_checks`), and the runs the
test repeats in one process to compare (the same functions with no mesh).
Imports no JAX: the ranks are fresh processes."""

from __future__ import annotations

import inspect
import os
import pickle
import time

import numpy as np
import torch
import torch.distributed as dist

import minigrid_tpu_torch as mt
from minigrid_tpu_torch.envs.base import _fresh_select
from minigrid_tpu_torch.models import ppo as P
from minigrid_tpu_torch.models.actor_critic import (ActorCritic,
                                                    ActorCriticRNN,
                                                    init_params,
                                                    init_params_rnn)
from minigrid_tpu_torch.models.train import TrainConfig, train
from minigrid_tpu_torch.parallel import mesh as M
from minigrid_tpu_torch.parallel.dryrun import dryrun_multichip
from minigrid_tpu_torch.parallel.rollout import make_rollout

CPU = "cpu"
RANKS = 2
THREADS = 1                 # torch threads a rank (tests/torch_port_utils)
ROLL_ENV = "MiniGrid-DoorKey-5x5-v0"
B, T = 32, 16               # the rollouts' global batch and length
UPDATE_SEED = 7             # the shared generator of the update checks
PAYLOAD = "payload.pkl"     # the test's references' inputs, in its tmp dir
TRAIN_ENV = "MiniGrid-Empty-5x5-v0"
RESET_BUDGET = 10           # max_steps of the regen/fresh rollouts
FRESH_STEP_BUFFER = 12      # the fresh train step's buffer: it overflows
TRAIN_RUNS = {"pooled": dict(resets="pooled"),
              "fresh": dict(resets="fresh"),
              "fresh+RNN": dict(resets="fresh", recurrent=True)}


def tensors(tree):
    """numpy leaves (dicts nested) -> CPU tensors."""
    if isinstance(tree, dict):
        return {k: tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree).copy())


def arrays(tree):
    if isinstance(tree, dict):
        return {k: arrays(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def pooled_rollout(mesh=None):
    """The random-policy pooled rollout of DoorKey-5x5 with a 40-step
    budget (B=32 staggered envs, T=16, a 16-layout pool; ~40% of the
    episodes end): (pool, chunk, final state), of the mesh's data rank or
    of one process."""
    env = mt.make(ROLL_ENV, device=CPU).packed().replace_params(max_steps=40)
    g = env.generator(0)
    pool = env.make_pool(g, 16)
    obs, st = env.reset_staggered(g, B)
    if mesh is not None:
        obs, st = M.shard_batch(mesh, (obs, st))
    rollout = make_rollout(env, None, length=T, pooled=True, mesh=mesh)
    st, obs, chunk = rollout(None, st, obs, env.generator(1), pool)
    return pool, chunk, st


class CountDistCalls:
    """Counts the calls of every public function of ``torch.distributed``
    while in its ``with`` block."""

    def __enter__(self):
        self.calls = 0
        self.saved = {k: f for k, f in vars(dist).items()
                      if inspect.isfunction(f) and not k.startswith("_")}

        def counted(f):
            def wrapper(*a, **kw):
                self.calls += 1
                return f(*a, **kw)
            return wrapper

        for k, f in self.saved.items():
            setattr(dist, k, counted(f))
        return self

    def __exit__(self, *exc):
        for k, f in self.saved.items():
            setattr(dist, k, f)


def reset_rollout(resets: str, mesh=None):
    """The random-policy regen or fresh rollout of DoorKey-5x5 with a
    10-step budget (B=32, T=16): the first half of the envs starts one step
    before its budget ends, the rest at 0, so over 2 data ranks the first
    rank's envs finish at steps 0 and 10 and the second's at step 9 (the
    fresh routing must count the first rank's finishers before the
    second's). The mesh's data rank's part or one process's, as numpy:
    (the chunk and the final state's fields, torch.distributed calls)."""
    env = mt.make(ROLL_ENV, device=CPU).packed().replace_params(
        max_steps=RESET_BUDGET)
    g = env.generator(2)
    obs, st = env.reset(g, B)
    st = st.replace(step_count=torch.where(
        torch.arange(B) < B // 2, RESET_BUDGET - 1, 0).to(torch.int32))
    if mesh is not None:
        obs, st = M.shard_batch(mesh, (obs, st))
    rollout = make_rollout(env, None, length=T, resets=resets, mesh=mesh)
    with CountDistCalls() as calls:
        st, obs, chunk = rollout(None, st, obs, g)
    return arrays({"reward": chunk.reward, "done": chunk.done,
                   "action": chunk.action, "packed": chunk.obs["packed"],
                   "step_count": st.step_count, "grid": st.grid,
                   "agent_pos": st.agent_pos}), calls.calls


def rollouts(mesh) -> dict:
    """The pooled, regen and fresh random-policy rollouts of the data rank,
    each with its count of torch.distributed calls."""
    with CountDistCalls() as calls:
        pool, chunk, st = pooled_rollout(mesh)
    out = {"pooled": arrays({
        "reward": chunk.reward, "action": chunk.action, "done": chunk.done,
        "packed": chunk.obs["packed"], "grid": st.grid,
        "agent_pos": st.agent_pos, "pool_grid": pool.grid,
        "pool_scal": pool.scal})}
    out["dist_calls"] = {"pooled": calls.calls}
    for resets in ("regen", "fresh"):
        out[resets], out["dist_calls"][resets] = reset_rollout(resets, mesh)
    return out


def update(payload: dict, shuffle: str, mesh=None) -> dict:
    """``ppo_update`` of the f32 ``ActorCritic(hidden=32)`` on the exported
    trajectory (the mesh's data rank's block of envs, or all of it), one
    epoch of 4 minibatches: the parameters, the metrics and the shared
    generator's state."""
    model = ActorCritic(hidden=32, dtype=torch.float32, device=CPU)
    model.load_state_dict(tensors(payload["params"]))
    cfg = P.PPOConfig(num_envs=B, rollout_len=T, num_minibatches=4,
                      shuffle=shuffle)
    opt = P.make_optimizer(model, cfg)
    traj, last = tensors(payload["traj"]), tensors(payload["last_obs"])
    if mesh is not None:
        rows = mesh.batch_slice(B)
        traj = {k: ({kk: vv[:, rows] for kk, vv in v.items()}
                    if isinstance(v, dict) else v[:, rows])
                for k, v in traj.items()}
        last = M.shard_batch(mesh, last)
    g = torch.Generator().manual_seed(UPDATE_SEED)
    metrics = P.ppo_update(model, opt, cfg, P.Transition(**traj), last, g,
                           mesh=mesh)
    return {"params": arrays(model.state_dict()),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "generator": g.get_state().numpy()}


def train_step_generators(mesh=None) -> dict:
    """One pooled and one fresh policy-driven train step of the f32
    ``ActorCritic(hidden=32)`` on DoorKey-5x5 with a 10-step budget (B=16
    staggered, T=8: most envs end in each rollout, and the fresh step's
    12-row buffer overflows), on the mesh or in one process: the shared
    generator's state after them, the parameters, the fresh step's
    ``reset_overflow`` and the actions of both rollouts (the data rank's
    block)."""
    env = mt.make(ROLL_ENV, device=CPU).packed().replace_params(
        max_steps=RESET_BUDGET)
    cfg = P.PPOConfig(num_envs=16, rollout_len=8, num_minibatches=2)
    g = env.generator(3)
    model = init_params(ActorCritic(hidden=32, dtype=torch.float32,
                                    device=CPU), env.generator(4))
    opt = P.make_optimizer(model, cfg)
    pool = env.make_pool(g, 16)
    obs, st = env.reset_staggered(g, cfg.num_envs)
    if mesh is not None:
        obs, st = M.shard_batch(mesh, (obs, st))
    actions, rollout = [], P.rollout

    def recorded(*args, **kw):  # the train step's rollout, its actions kept
        out = rollout(*args, **kw)
        actions.append(out[2].action)
        return out

    P.rollout = recorded
    try:
        for resets in ("pooled", "fresh"):
            step = P.make_train_step(env, model, cfg, opt, resets=resets,
                                     fresh_buffer=FRESH_STEP_BUFFER,
                                     mesh=mesh)
            st, obs, m = step(st, obs, g, pool)
    finally:
        P.rollout = rollout
    return {"shared": g.get_state().numpy(),
            "params": arrays(model.state_dict()),
            "reset_overflow": int(m["reset_overflow"]),
            "actions": arrays(torch.stack(actions))}


def train_config(name: str, ckpt: str | None, devices: int = RANKS):
    return TrainConfig(
        devices=devices, total_env_steps=2 * 16 * 8, hidden=32,
        ppo=P.PPOConfig(num_envs=16, rollout_len=8, num_minibatches=2),
        pool_size=16, log_every=1, checkpoint_dir=ckpt, checkpoint_every=1,
        **TRAIN_RUNS[name])


def train_runs(tmp: str, rank: int) -> dict:
    """``train(devices=2)`` inside the group (the ``torchrun`` path), 2
    updates of each run, each rank checkpointing into a directory of its
    own: what each rank logged, wrote and learned."""
    out = {}
    for name in TRAIN_RUNS:
        ckpt = os.path.join(tmp, name, f"rank{rank}")
        os.makedirs(ckpt)
        logged = []
        model, history = train(TRAIN_ENV, train_config(name, ckpt),
                               log_fn=logged.append, device=CPU)
        out[name] = {"logged": len(logged),
                     "history": [{k: v for k, v in m.items()
                                  if k != "env_steps_per_s"}
                                 for m in history],
                     "checkpoints": sorted(os.listdir(ckpt)),
                     "params": arrays(model.state_dict())}
    try:
        train(TRAIN_ENV, train_config("pooled", None, devices=4),
              device=CPU)
    except ValueError as e:
        out["world_mismatch"] = str(e)
    return out


def tensor_parallel(payload: dict) -> dict:
    """On a (1, 2) mesh: the forward of the sharded f32 ``ActorCritic(128)``
    and ``ActorCriticRNN(128)`` on an observation batch, and one rotate
    update of each on its trajectory; the parameters come back as this
    rank's shards."""
    mesh = M.make_mesh(RANKS, model_parallel=RANKS)
    out = {}
    for name, cls in (("mlp", ActorCritic), ("rnn", ActorCriticRNN)):
        p = payload["tp"][name]
        model = cls(hidden=128, dtype=torch.float32, device=CPU)
        model.load_state_dict(tensors(p["params"]))
        M.shard_params(mesh, model)
        obs = tensors(payload["tp"]["obs"])
        with torch.no_grad():
            if name == "rnn":
                (logits, value), h = model(obs, tensors(p["h"]))
                fwd = {"logits": logits, "value": value, "h": h}
            else:
                logits, value = model(obs)
                fwd = {"logits": logits, "value": value}
        cfg = P.PPOConfig(num_envs=16, rollout_len=8, num_minibatches=2)
        traj = tensors(p["traj"])
        metrics = P.ppo_update(
            model, P.make_optimizer(model, cfg), cfg, P.Transition(**traj),
            tensors(p["last_obs"]),
            torch.Generator().manual_seed(UPDATE_SEED),
            h=tensors(p["last_h"]) if name == "rnn" else None, mesh=mesh)
        out[name] = {"forward": arrays(fwd),
                     "shards": arrays(model.state_dict()),
                     "metrics": {k: float(v) for k, v in metrics.items()},
                     "specs": M.param_shardings(mesh, model)}
    out["steps"] = tensor_parallel_steps(mesh)
    return out


TP_STEPS = {"fresh": ("fresh", False), "regen": ("regen", False),
            "fresh+RNN": ("fresh", True)}


def tensor_parallel_steps(mesh) -> dict:
    """On a (1, 2) mesh, whose two model ranks hold the same envs: a fresh
    and a regen policy-driven train step of the sharded ``ActorCritic(128)``
    and a fresh one of ``ActorCriticRNN(128)``, on DoorKey-5x5 with a
    6-step budget (every env ends inside the rollout, so each rank draws
    reset layouts). Per step: the env state, the observations, the metrics
    and the parameters' shards; then the shared generator's state."""
    env = mt.make(ROLL_ENV, device=CPU).packed().replace_params(max_steps=6)
    cfg = P.PPOConfig(num_envs=16, rollout_len=8, num_minibatches=2)
    g = env.generator(5)
    out = {}
    for name, (resets, recurrent) in TP_STEPS.items():
        cls, init = ((ActorCriticRNN, init_params_rnn) if recurrent
                     else (ActorCritic, init_params))
        model = M.shard_params(mesh, init(cls(hidden=128, device=CPU),
                                          env.generator(6)))
        obs, st = M.shard_batch(mesh, env.reset_staggered(g, cfg.num_envs))
        step = P.make_train_step(env, model, cfg, P.make_optimizer(model, cfg),
                                 resets=resets, mesh=mesh)
        if recurrent:
            st, obs, _, m = step(st, obs, model.initial_state(cfg.num_envs),
                                 g)
        else:
            st, obs, m = step(st, obs, g)
        out[name] = {"state": arrays(st.tensors()), "obs": arrays(obs),
                     "metrics": {k: float(v) for k, v in m.items()},
                     "shards": arrays(model.state_dict()),
                     "specs": M.param_shardings(mesh, model)}
    out["generator"] = g.get_state().numpy()
    return out


def fresh_routing(case: dict, mesh) -> dict:
    """JAX's fresh select replayed over the data ranks: the rank's rows of
    the exported DoorKey-8x8 states, the whole exported buffer, and per
    step its rows of the keys and of the done mask, routed with
    ``models/ppo.py::finisher_counts``. Per step, the selected states'
    fields (the rank's rows), the packed observation, the cursor and the
    rank's ``reset_overflow``; and the torch.distributed calls."""
    env = mt.make(case["env_id"], device=CPU).packed()
    rows = mesh.batch_slice(case["done"].shape[1])
    st = case["state"].map(lambda x: x[rows])
    cursor = torch.tensor(case["cursor"], dtype=torch.int32)
    finishers = P.finisher_counts(mesh)
    steps = []
    with CountDistCalls() as calls:
        for keys, done in zip(case["keys"], case["done"]):
            obs, st, info, cursor = _fresh_select(
                env, torch.from_numpy(keys[rows]), st,
                torch.from_numpy(done[rows]), case["buffer"], cursor,
                case["window"], finishers)
            steps.append({"state": arrays(st.tensors()),
                          "packed": arrays(obs["packed"]),
                          "cursor": int(cursor),
                          "reset_overflow": int(info["reset_overflow"])})
    return {"steps": steps, "dist_calls": calls.calls}


def wait_for_payload(tmp: str, timeout: float = 600.0) -> dict:
    """The payload the test writes to ``tmp`` (pickled, then renamed into
    place) while the ranks run what needs none."""
    path = os.path.join(tmp, PAYLOAD)
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"no payload at {path}")
        time.sleep(0.05)
    with open(path, "rb") as f:
        return pickle.load(f)


def rank_checks(tmp: str) -> dict:
    """Every multi-process check of the module on one rank of 2: first what
    needs no payload, then what compares with the test's references."""
    torch.set_num_threads(THREADS)
    rank = dist.get_rank()
    mesh = M.make_mesh(RANKS)
    out = {"rank": rank, "rollouts": rollouts(mesh),
           "generators": train_step_generators(mesh),
           "train": train_runs(tmp, rank),
           "dryrun": dryrun_multichip(RANKS, device=CPU)[0]}
    payload = wait_for_payload(tmp)
    out["update"] = {s: update(payload, s, mesh) for s in P.SHUFFLES}
    out["fresh_routing"] = fresh_routing(payload["fresh_routing"], mesh)
    out["tp"] = tensor_parallel(payload)
    return out


def full_params(specs: dict, shards: list) -> dict:
    """The parameters reassembled from the model ranks' shards (a
    replicated one must be equal on every rank)."""
    out = {}
    for name, spec in specs.items():
        parts = [s[name] for s in shards]
        if M.MODEL_AXIS in spec:
            out[name] = np.concatenate(parts, axis=spec.index(M.MODEL_AXIS))
        else:
            np.testing.assert_array_equal(parts[0], parts[1])
            out[name] = parts[0]
    return out
