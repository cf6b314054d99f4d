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


def rollouts(mesh) -> dict:
    """The pooled rollout, and the regen and fresh ones from envs that all
    end at the first step (so step 1 shows the layouts the rank drew from
    its own generator), with the calls of ``torch.distributed`` counted."""
    out = {}
    with CountDistCalls() as calls:
        pool, chunk, st = pooled_rollout(mesh)
        out["pooled"] = {"reward": chunk.reward, "action": chunk.action,
                         "done": chunk.done, "packed": chunk.obs["packed"],
                         "grid": st.grid, "agent_pos": st.agent_pos,
                         "pool_grid": pool.grid, "pool_scal": pool.scal}
        for resets in ("regen", "fresh"):
            env = mt.make(ROLL_ENV, device=CPU).packed()
            g = env.generator(2)
            obs, st = M.shard_batch(mesh, env.reset(g, B))
            st = st.replace(step_count=torch.full_like(
                st.step_count, env.params.max_steps - 1))
            rollout = make_rollout(env, None, length=T, resets=resets,
                                   mesh=mesh)
            st, obs, chunk = rollout(None, st, obs, g, None,
                                     env.generator(M.rank_seed(100, mesh)))
            out[resets] = {"reward": chunk.reward, "done": chunk.done,
                           "packed": chunk.obs["packed"],
                           "step_count": st.step_count}
    out = arrays(out)
    out["dist_calls"] = calls.calls
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


def train_step_generators(mesh) -> dict:
    """One pooled and one fresh train step (policy-driven) on the mesh:
    the shared and the rank's own generator states after them."""
    env = mt.make(ROLL_ENV, device=CPU).packed()
    cfg = P.PPOConfig(num_envs=16, rollout_len=8, num_minibatches=2)
    g, local = env.generator(3), env.generator(M.rank_seed(200, mesh))
    model = init_params(ActorCritic(hidden=32, device=CPU), env.generator(4))
    opt = P.make_optimizer(model, cfg)
    pool = env.make_pool(g, 16)
    obs, st = M.shard_batch(mesh, env.reset_staggered(g, cfg.num_envs))
    for resets in ("pooled", "fresh"):
        step = P.make_train_step(env, model, cfg, opt, resets=resets,
                                 mesh=mesh)
        st, obs, _ = step(st, obs, g, pool, local)
    return {"shared": g.get_state().numpy(),
            "local": local.get_state().numpy(),
            "params": arrays(model.state_dict())}


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
    layouts from its own generator). Per step: the env state, the
    observations, the metrics and the parameters' shards; then both
    generators' states."""
    env = mt.make(ROLL_ENV, device=CPU).packed().replace_params(max_steps=6)
    cfg = P.PPOConfig(num_envs=16, rollout_len=8, num_minibatches=2)
    g, local = env.generator(5), env.generator(M.rank_seed(5, mesh))
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
                                 g, None, local)
        else:
            st, obs, m = step(st, obs, g, None, local)
        out[name] = {"state": arrays(st.tensors()), "obs": arrays(obs),
                     "metrics": {k: float(v) for k, v in m.items()},
                     "shards": arrays(model.state_dict()),
                     "specs": M.param_shardings(mesh, model)}
    out["generators"] = {"shared": g.get_state().numpy(),
                         "local": local.get_state().numpy()}
    return out


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
