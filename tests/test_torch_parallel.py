"""The multi-rank layer of the port (``minigrid_tpu_torch/parallel/``,
``train(devices > 1)``, the sharded PPO step) against one process and the
JAX package.

One 2-rank gloo group on the CPU per module (the ``ranks`` fixture, started
in a thread while the references are computed here) runs every
multi-process check of ``tests/torch_parallel_ranks.py`` and hands each test
its result; ``test_train_spawns_its_ranks`` lets ``train`` spawn its own.

Tolerances: the sharded pooled, regen and fresh rollouts equal the
one-process rollout bit for bit (every draw is the global batch's, each
rank keeping its block; the fresh routing counts the finishers of the
global batch), and the fresh routing over 2 ranks equals JAX's
``_fresh_select`` on the global batch bit for bit.
The update of a fixed trajectory over 2 ranks is within 1e-5 of one
process and of JAX's update on every f32 parameter and metric (sums over
the ranks and ``sum / count`` round otherwise than ``mean()``; Adam turns
gradients near its eps into steps of order lr, as tests/test_torch_ppo.py
records), and the ranks' parameters are bit-equal. Tensor parallelism on
a (1, 2) mesh: the f32 forward within 1e-5 and the parameters after one
update within 1e-5 of the unsharded model (the split GEMMs sum in other
orders)."""

from __future__ import annotations

import concurrent.futures
import functools
import os
import pickle

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

import minigrid_tpu
from minigrid_tpu.envs.base import _fresh_select as j_fresh_select
from minigrid_tpu.envs.base import make_layout_pool as j_make_layout_pool
from minigrid_tpu.models.actor_critic import ActorCritic as JActorCritic
from minigrid_tpu.models.actor_critic import ActorCriticRNN as JActorCriticRNN
from minigrid_tpu.models.actor_critic import init_params as j_init_params
from minigrid_tpu.models.actor_critic import init_params_rnn as j_init_rnn
from minigrid_tpu.models.ppo import PPOConfig as JPPOConfig
from minigrid_tpu.models.ppo import Transition as JTransition
from minigrid_tpu.models.ppo import make_optimizer as j_make_optimizer
from minigrid_tpu.models.ppo import make_train_step as j_make_train_step
from minigrid_tpu.parallel.mesh import param_spec as j_param_spec

import minigrid_tpu_torch as mt
from minigrid_tpu_torch import wrappers as W
from minigrid_tpu_torch.convert import actor_critic_from_flax
from minigrid_tpu_torch.models import ppo as P
from minigrid_tpu_torch.models.actor_critic import (ActorCritic,
                                                    ActorCriticRNN,
                                                    init_params,
                                                    init_params_rnn)
from minigrid_tpu_torch.models.train import TrainConfig, train
from minigrid_tpu_torch.parallel import mesh as M

from tests import torch_parallel_ranks as R
from tests.torch_port_utils import (share_cpu,  # noqa: F401
                                    export, fresh_case, jax_keys,
                                    jax_train_step_closures)

pytestmark = pytest.mark.usefixtures("share_cpu")
ATOL = 1e-5
# JAX's fresh select on a global batch of 64 DoorKey-8x8 envs, 6 steps: the
# first 32 envs (the first data rank's) finish at p=0.6 a step, the rest at
# 0.05; the 16-row window overflows on the first rank's waves and the
# 64-row buffer (one generator compile for the states and the buffer) runs
# out
FRESH_B, FRESH_STEPS, FRESH_BUFFER, FRESH_WINDOW = 64, 6, 64, 16


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_rollout():
    """A pooled JAX rollout of DoorKey-5x5 (B=32, T=16) by the f32
    ``ActorCritic(hidden=32)``, its GAE and the JAX closures; JAX's update
    of each shuffle (:func:`_jax_update`) is computed in a thread from
    here on (``"updates"``, a future), beside the payload and the ranks."""
    jcfg = JPPOConfig(num_envs=R.B, rollout_len=R.T, num_minibatches=4)
    jm = JActorCritic(hidden=32, dtype=jnp.float32)
    env = minigrid_tpu.make(R.ROLL_ENV).packed()
    fns = jax_train_step_closures(j_make_train_step(
        env, jm, jcfg, j_make_optimizer(jcfg), resets="pooled"))
    params = jax.jit(lambda k: j_init_params(k, model=jm, packed=True))(
        jax.random.PRNGKey(0))
    pool = j_make_layout_pool(env, jax.random.PRNGKey(1), 16)
    obs, st = jax.jit(jax.vmap(env.reset_staggered))(
        jax.random.split(jax.random.PRNGKey(2), R.B))
    _, last_obs, _, traj, _, _ = jax.jit(fns["rollout"])(
        params, st, obs, jax.random.PRNGKey(3), pool)
    _, last_value = jax.jit(jm.apply)(params, last_obs)
    adv, ret = fns["gae"](traj, last_value)
    assert float(traj.done.sum()) > 0  # episodes end inside the rollout
    opt = j_make_optimizer(jcfg)

    @jax.jit
    def step(params, state, batch, adv, ret):
        """JAX's gradient step on one minibatch: (params, state, metrics)."""
        (_, m), grads = jax.value_and_grad(fns["loss_fn"], has_aux=True)(
            params, batch, adv, ret)
        updates, state = opt.update(grads, state, params)
        return optax.apply_updates(params, updates), state, m

    out = {"params": params, "traj": traj, "last_obs": last_obs,
           "adv": adv, "ret": ret, "step": step, "jcfg": jcfg}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        out["updates"] = pool.submit(
            lambda: {s: _jax_update(out, s) for s in P.SHUFFLES})
        yield out


def _port_rollout(model, B=16, T=8, h=None):
    """A pooled port rollout of DoorKey-5x5 by ``model``, as numpy: the
    stored trajectory, the last observations (and hidden state)."""
    env = mt.make(R.ROLL_ENV, device=R.CPU).packed()
    g = env.generator(11)
    pool = env.make_pool(g, 16)
    obs, st = env.reset_staggered(g, B)
    noise = P.sample_rollout_noise(g, pool, B, T, model.num_actions)
    out = P.rollout(model, env, st, obs, noise, "pooled", h=h)
    traj = {k: v for k, v in out[2]._asdict().items() if v is not None}
    res = {"traj": R.arrays(traj), "last_obs": R.arrays(out[1])}
    if h is not None:
        res["last_h"] = R.arrays(out[4])
    return res


def _tp_payload():
    """The unsharded f32 models of hidden 128, an observation batch and a
    trajectory of each, for the tensor-parallel checks."""
    env = mt.make(R.ROLL_ENV, device=R.CPU).packed()
    g = env.generator(12)
    obs, _ = env.reset_staggered(g, 16)
    mlp = init_params(ActorCritic(hidden=128, dtype=torch.float32,
                                  device=R.CPU), g)
    rnn = init_params_rnn(ActorCriticRNN(hidden=128, dtype=torch.float32,
                                         device=R.CPU), g)
    h = 0.5 * torch.randn((16, 128), generator=g)
    return {"obs": R.arrays(obs),
            "mlp": {"params": R.arrays(mlp.state_dict()),
                    **_port_rollout(mlp)},
            "rnn": {"params": R.arrays(rnn.state_dict()), "h": h.numpy(),
                    **_port_rollout(rnn, h=rnn.initial_state(16))}}


def _fresh_routing_case():
    """JAX's ``_fresh_select`` run step by step on the global batch (a
    JAX-exported buffer, done masks that one rank's envs meet far more
    often): the rank side's inputs (the port's copies) and JAX's result of
    each step (the selected states' fields, the packed observation, the
    cursor, ``reset_overflow``)."""
    env, jst, jbuf, _, pst, pbuf = fresh_case(FRESH_B, FRESH_BUFFER,
                                               seed=4)
    rng = np.random.default_rng(5)
    p = np.where(np.arange(FRESH_B) < FRESH_B // 2, 0.6, 0.05)
    done = rng.random((FRESH_STEPS, FRESH_B)) < p
    select = jax.jit(lambda k, s, d, c: j_fresh_select(
        env, k, s, d, jbuf, c, FRESH_WINDOW))
    keys, want = [], []
    cursor = jnp.asarray(0, jnp.int32)
    for t in range(FRESH_STEPS):
        jk, pk = jax_keys(30 + t, FRESH_B)
        obs, jst, info, cursor = select(jk, jst, jnp.asarray(done[t]),
                                        cursor)
        keys.append(pk.numpy())
        want.append({"state": R.arrays(export(jst).tensors()),
                     "packed": np.asarray(obs["packed"]),
                     "cursor": int(cursor),
                     "reset_overflow": int(info["reset_overflow"])})
    case = {"env_id": "MiniGrid-DoorKey-8x8-v0", "state": pst,
            "buffer": pbuf, "keys": np.stack(keys), "done": done,
            "cursor": 0, "window": FRESH_WINDOW}
    return case, want


@pytest.fixture(scope="module")
def workers(tmp_path_factory):
    """The 2-rank group, ``train``'s own spawn and JAX's fresh routing case,
    started at once in threads (their results are futures) while this
    process computes the other references; the ranks wait for the payload
    (:func:`payload`) only after the checks that need none."""
    tmp = tmp_path_factory.mktemp("ranks")
    (tmp / "spawned").mkdir()
    saved = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = str(R.THREADS)  # train's spawned ranks
    logged = []
    try:
        with concurrent.futures.ThreadPoolExecutor(3) as pool:
            yield {"tmp": tmp, "logged": logged,
                   "fresh_routing": pool.submit(_fresh_routing_case),
                   "ranks": pool.submit(M.spawn, R.rank_checks, R.RANKS,
                                        "gloo", R.CPU, (str(tmp),),
                                        timeout=600),
                   "train": pool.submit(
                       train, R.TRAIN_ENV,
                       R.train_config("pooled", str(tmp / "spawned")),
                       logged.append, R.CPU)}
    finally:
        if saved is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = saved


@pytest.fixture(scope="module")
def payload(workers, jax_rollout):
    """The references' inputs, handed to the ranks through a file."""
    j = jax_rollout
    traj = _np(j["traj"])
    out = {"params": R.arrays(actor_critic_from_flax(_np(j["params"]))),
           "traj": {"obs": dict(traj.obs), "action": traj.action,
                    "log_prob": traj.log_prob, "value": traj.value,
                    "reward": traj.reward, "done": traj.done},
           "last_obs": dict(_np(j["last_obs"])),
           "tp": _tp_payload(),
           "fresh_routing": workers["fresh_routing"].result()[0]}
    tmp = workers["tmp"]
    with open(tmp / "payload.tmp", "wb") as f:
        pickle.dump(out, f)
    os.replace(tmp / "payload.tmp", tmp / R.PAYLOAD)
    return out


@pytest.fixture(scope="module")
def ranks(workers, payload):
    """The 2 ranks' results (a future)."""
    return workers["ranks"]


# --- the update --------------------------------------------------------------

def _jax_update(j, shuffle):
    """JAX's loss and optax's Adam over the minibatches the shared
    generator picks, on JAX's GAE: (params, metrics)."""
    params = j["params"]
    traj = _np(j["traj"])
    data = {k: torch.from_numpy(np.array(v)) for k, v in dict(
        traj.obs, action=traj.action, log_prob=traj.log_prob,
        adv=_np(j["adv"]), ret=_np(j["ret"])).items()}
    cfg = P.PPOConfig(num_envs=R.B, rollout_len=R.T, num_minibatches=4,
                      shuffle=shuffle)
    opt = j_make_optimizer(j["jcfg"])
    state = opt.init(params)
    per_mb = []
    g = torch.Generator().manual_seed(R.UPDATE_SEED)
    for mb in P.epoch_minibatches(data, cfg, g):
        j_mb = {k: jnp.asarray(v.numpy()) for k, v in mb.items()}
        batch = JTransition({k: j_mb[k] for k in P.OBS_KEYS},
                            j_mb["action"], j_mb["log_prob"], None, None,
                            None)
        params, state, m = j["step"](params, state, batch, j_mb["adv"],
                                     j_mb["ret"])
        per_mb.append(m)
    metrics = {k: float(np.mean([m[k] for m in per_mb])) for k in per_mb[0]}
    metrics["mean_reward"] = float(traj.reward.mean())
    return R.arrays(actor_critic_from_flax(_np(params))), metrics


@pytest.mark.parametrize("shuffle", P.SHUFFLES)
def test_update_matches_one_process_and_jax(ranks, payload, jax_rollout,
                                            shuffle):
    """ppo_update of one exported JAX trajectory over 2 ranks against one
    process and JAX's update, within 1e-5; the ranks' parameters
    bit-equal and their shared generators in one state."""
    one = R.update(payload, shuffle)
    j_params, j_metrics = jax_rollout["updates"].result()[shuffle]
    got = [r["update"][shuffle] for r in ranks.result()]
    for name, w in one["params"].items():
        np.testing.assert_array_equal(got[0]["params"][name],
                                      got[1]["params"][name], err_msg=name)
        np.testing.assert_allclose(got[0]["params"][name], w, rtol=0,
                                   atol=ATOL, err_msg=name)
        np.testing.assert_allclose(got[0]["params"][name], j_params[name],
                                   rtol=0, atol=ATOL, err_msg=name)
        np.testing.assert_allclose(w, j_params[name], rtol=0, atol=ATOL)
        assert not np.array_equal(w, payload["params"][name]) or \
            name.endswith("bias")
    for k, w in one["metrics"].items():
        for g in got:
            np.testing.assert_allclose(g["metrics"][k], w, rtol=0, atol=ATOL,
                                       err_msg=k)
        np.testing.assert_allclose(w, j_metrics[k], rtol=0, atol=ATOL,
                                   err_msg=k)
    for g in got:
        np.testing.assert_array_equal(g["generator"], one["generator"])


# --- no process ------------------------------------------------------------

@pytest.mark.parametrize("recurrent", [False, True])
@pytest.mark.parametrize("hidden", [32, 128])
def test_param_spec_matches_jax(recurrent, hidden):
    """Every leaf's layout, JAX's kernels (in, out) against the port's
    (out, in) weights: hidden 32 keeps its biases whole, 128 splits them
    (a GRU's 3H-wide bias splits at both)."""
    if recurrent:
        init = lambda k: j_init_rnn(  # noqa: E731
            k, model=JActorCriticRNN(hidden=hidden), packed=True)
        model = ActorCriticRNN(hidden=hidden, device=R.CPU)
    else:
        init = lambda k: j_init_params(  # noqa: E731
            k, model=JActorCritic(hidden=hidden), packed=True)
        model = ActorCritic(hidden=hidden, device=R.CPU)
    # the leaves' shapes are all param_spec reads
    jparams = jax.eval_shape(init, jax.random.PRNGKey(0))
    want = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        spec = tuple(j_param_spec(path, leaf))
        keys = [p.key for p in path][1:]
        if keys[-1] == "kernel":
            want[f"{keys[0]}.weight"] = spec[::-1]
        elif keys[-1] == "bias":
            want[f"{keys[0]}.bias"] = spec
        else:
            want[keys[0]] = spec
    got = {name: M.param_spec(name, p)
           for name, p in model.named_parameters()}
    pad = lambda s, n: tuple(s) + (None,) * (n - len(s))  # noqa: E731
    assert set(got) == set(want)
    for name, p in model.named_parameters():
        assert pad(got[name], p.ndim) == pad(want[name], p.ndim), name
    split = {n for n, s in got.items() if M.MODEL_AXIS in s}
    assert ("trunk1.bias" in split) == (hidden >= 64)
    assert not any("policy" in n or "value" in n for n in split)


def test_rank_layouts_refuse_what_cannot_run():
    assert M.rank_device(2, None, "cpu") == ("gloo", torch.device("cpu"))
    with pytest.raises(ValueError, match="backend='gloo'"):
        M.rank_device(2, "nccl", "cpu")
    with pytest.raises(ValueError, match="backend"):
        M.rank_device(2, "mpi", "cpu")
    with pytest.raises(RuntimeError, match="initialised process group"):
        M.make_mesh(2)
    with pytest.raises(ValueError, match="store"):
        M.init_ranks(2, "gloo", "cpu")


def test_regen_layouts_are_the_global_batch_rows():
    """A data rank's regen layouts are its rows of the global batch's, drawn
    as one process draws them (the generator left in the same state); a
    stack holding a ReseedWrapper draws none, as one process does not."""
    env = mt.make(R.ROLL_ENV, device=R.CPU)
    g, g_one = env.generator(8), env.generator(8)
    got = P.regen_layouts(W.ActionBonus(env), g, 8, slice(4, 8))
    want = env._gen_grid(g_one, 8)
    for k, v in got.tensors().items():
        np.testing.assert_array_equal(v.numpy(), want.tensors()[k][4:].numpy(),
                                      err_msg=k)
    np.testing.assert_array_equal(g.get_state().numpy(),
                                  g_one.get_state().numpy())
    stack = W.ImgObsWrapper(W.ReseedWrapper(env, seeds=(1, 2)))
    assert P.regen_layouts(stack, g, 8, slice(4, 8)) is None
    np.testing.assert_array_equal(g.get_state().numpy(),
                                  g_one.get_state().numpy())


# --- the rollouts ------------------------------------------------------------

def test_sharded_rollout_matches_unsharded(ranks):
    """The port's counterpart of JAX's test of that name: each rank's
    pooled random-policy rollout is its block of the one-process rollout,
    bit for bit, and the replicated pools are equal."""
    pool, chunk, st = R.pooled_rollout()
    want = R.arrays({"reward": chunk.reward, "action": chunk.action,
                     "done": chunk.done, "packed": chunk.obs["packed"],
                     "grid": st.grid, "agent_pos": st.agent_pos})
    assert want["done"].any()
    got = [r["rollouts"]["pooled"] for r in ranks.result()]
    for k, w in want.items():
        axis = 1 if w.shape[:2] == (R.T, R.B) else 0
        np.testing.assert_array_equal(
            np.concatenate([g[k] for g in got], axis=axis), w, err_msg=k)
    for g in got:
        np.testing.assert_array_equal(g["pool_grid"], pool.grid.numpy())
        np.testing.assert_array_equal(g["pool_scal"], pool.scal.numpy())


def test_sharded_rollouts_make_no_collective_call(ranks):
    """Only the fresh reset communicates: the pooled and regen rollouts
    call no function of torch.distributed, the fresh one one all-reduce a
    step (the finisher counts)."""
    for r in ranks.result():
        assert r["rollouts"]["dist_calls"] == {"pooled": 0, "regen": 0,
                                               "fresh": R.T}


@pytest.mark.parametrize("resets", ["regen", "fresh"])
def test_regen_and_fresh_rollouts_sharded(ranks, resets):
    """Each rank's regen or fresh random-policy rollout is its block of the
    one-process rollout, bit for bit (reward, done, action, packed obs,
    final step count, grid and agent position): the regen layouts are the
    global batch's, the fresh buffer is whole on every rank and routed by
    the global ranks of the finishers, although the first rank's envs
    finish twice as often as the second's."""
    want, calls = R.reset_rollout(resets)
    assert calls == 0
    half = R.B // R.RANKS
    assert want["done"][0, :half].all() and not want["done"][0, half:].any()
    assert want["done"][9, half:].all() and want["done"].sum() >= 3 * half
    got = [r["rollouts"][resets] for r in ranks.result()]
    for k, w in want.items():
        axis = 1 if w.shape[:2] == (R.T, R.B) else 0
        np.testing.assert_array_equal(
            np.concatenate([g[k] for g in got], axis=axis), w, err_msg=k)


@functools.lru_cache(maxsize=1)
def _one_process_train_steps():
    return R.train_step_generators()


def test_train_steps_keep_the_shared_generator_in_step(ranks):
    """After a pooled and a fresh policy-driven train step on 2 ranks, the
    shared generators are in one state, that of one process after the same
    steps, and the parameters are bit-equal."""
    one = _one_process_train_steps()
    got = [r["generators"] for r in ranks.result()]
    for g in got:
        np.testing.assert_array_equal(g["shared"], one["shared"])
    for name, p in got[0]["params"].items():
        np.testing.assert_array_equal(p, got[1]["params"][name])


def test_fresh_train_step_matches_one_process(ranks):
    """The policy-driven train steps of the test above against one
    process: the rollouts' actions equal, the fresh step's
    ``reset_overflow`` (nonzero: its buffer runs out) equal, and the f32
    parameters within 1e-5."""
    one = _one_process_train_steps()
    got = [r["generators"] for r in ranks.result()]
    np.testing.assert_array_equal(
        np.concatenate([g["actions"] for g in got], axis=2), one["actions"])
    assert one["reset_overflow"] > 0
    for g in got:
        assert g["reset_overflow"] == one["reset_overflow"]
        for name, w in one["params"].items():
            np.testing.assert_allclose(g["params"][name], w, rtol=0,
                                       atol=ATOL, err_msg=name)


def test_fresh_routing_over_ranks_matches_jax(ranks, workers):
    """JAX's ``_fresh_select`` on a global batch of 64, against the port's
    routing over 2 ranks of 32 (each rank its rows of the states, keys and
    done masks, the whole buffer, ``finisher_counts``), 6 steps in which the
    first rank's envs finish 12x as often as the second's: each step's
    selected states and observations (the ranks' rows joined), the cursor
    on each rank and ``reset_overflow`` summed over the ranks, bit for
    bit; one all-reduce a step."""
    _, want = workers["fresh_routing"].result()
    got = [r["fresh_routing"] for r in ranks.result()]
    for g in got:
        assert g["dist_calls"] == FRESH_STEPS
    overflow = 0
    for t, w in enumerate(want):
        steps = [g["steps"][t] for g in got]
        for k, v in w["state"].items():
            np.testing.assert_array_equal(
                np.concatenate([s["state"][k] for s in steps]), v,
                err_msg=f"step {t}: {k}")
        np.testing.assert_array_equal(
            np.concatenate([s["packed"] for s in steps]), w["packed"])
        assert [s["cursor"] for s in steps] == [w["cursor"]] * R.RANKS
        assert sum(s["reset_overflow"] for s in steps) == \
            w["reset_overflow"], f"step {t}"
        overflow += w["reset_overflow"]
    assert overflow > 0 and want[-1]["cursor"] > FRESH_BUFFER


# --- train ---------------------------------------------------------------------

@pytest.mark.parametrize("run", list(R.TRAIN_RUNS))
def test_train_in_a_process_group(ranks, run):
    """train(devices=2) inside an initialised group of 2 (the torchrun
    path): 2 updates, global metrics (the same history on both ranks),
    bit-equal parameters; rank 0 alone logs and checkpoints. A world of
    another size is refused."""
    got = [r["train"] for r in ranks.result()]
    a, b = got[0][run], got[1][run]
    assert (a["logged"], b["logged"]) == (2, 0)
    assert a["checkpoints"] == ["step_1.npz", "step_2.npz"]
    assert b["checkpoints"] == []
    assert a["history"] == b["history"]
    assert [m["update"] for m in a["history"]] == [1, 2]
    assert all(np.isfinite(v) for m in a["history"] for v in m.values())
    for name, p in a["params"].items():
        np.testing.assert_array_equal(p, b["params"][name], err_msg=name)
    assert "process group of 2" in got[0]["world_mismatch"]


def test_train_spawns_its_ranks(workers):
    """Outside a process group, train(devices=2) spawns 2 gloo ranks on
    the CPU, logs rank 0's metrics here, checkpoints once an update, and
    returns rank 0's model; a batch that does not split is refused
    first."""
    model, history = workers["train"].result()
    assert isinstance(model, ActorCritic) and model.hidden == 32
    assert workers["logged"] == history and len(history) == 2
    assert sorted(p.name for p in (workers["tmp"] / "spawned").iterdir()) \
        == ["step_1.npz", "step_2.npz"]
    assert all(torch.isfinite(p).all() for p in model.parameters())
    with pytest.raises(ValueError, match="does not split"):
        train(R.TRAIN_ENV, TrainConfig(devices=3,
                                       ppo=P.PPOConfig(num_envs=16)),
              device=R.CPU)


# --- tensor parallelism and the dry run ------------------------------------------

@pytest.mark.parametrize("name", ["mlp", "rnn"])
def test_tensor_parallel_matches_unsharded(ranks, payload, name):
    """ActorCritic(128) and ActorCriticRNN(128), f32, split over a (1, 2)
    mesh: the forward, and the parameters and metrics after one update,
    within 1e-5 of the unsharded model."""
    p = payload["tp"][name]
    cls = ActorCriticRNN if name == "rnn" else ActorCritic
    model = cls(hidden=128, dtype=torch.float32, device=R.CPU)
    model.load_state_dict(R.tensors(p["params"]))
    obs = R.tensors(payload["tp"]["obs"])
    with torch.no_grad():
        if name == "rnn":
            (logits, value), h = model(obs, R.tensors(p["h"]))
            want = {"logits": logits, "value": value, "h": h}
        else:
            logits, value = model(obs)
            want = {"logits": logits, "value": value}
    cfg = P.PPOConfig(num_envs=16, rollout_len=8, num_minibatches=2)
    metrics = P.ppo_update(
        model, P.make_optimizer(model, cfg), cfg,
        P.Transition(**R.tensors(p["traj"])), R.tensors(p["last_obs"]),
        torch.Generator().manual_seed(R.UPDATE_SEED),
        h=R.tensors(p["last_h"]) if name == "rnn" else None)
    got = [r["tp"][name] for r in ranks.result()]
    for k, w in R.arrays(want).items():
        for g in got:
            np.testing.assert_allclose(g["forward"][k], w, rtol=0,
                                       atol=ATOL, err_msg=k)
    specs = got[0]["specs"]
    assert sum(M.MODEL_AXIS in s for s in specs.values()) >= 5
    full = R.full_params(specs, [g["shards"] for g in got])
    for k, w in R.arrays(model.state_dict()).items():
        np.testing.assert_allclose(full[k], w, rtol=0, atol=ATOL, err_msg=k)
    for k, w in metrics.items():
        np.testing.assert_allclose(got[0]["metrics"][k], float(w), rtol=0,
                                   atol=ATOL, err_msg=k)


@pytest.mark.parametrize("step", list(R.TP_STEPS))
def test_tensor_parallel_ranks_hold_the_same_envs(ranks, step):
    """The two model ranks of a (1, 2) mesh after a fresh or a regen train
    step in which every env ends: the env states, the observations, the
    metrics and the replicated parameters bit-equal (every reset draw comes
    from the shared generator), and their generators in one state."""
    got = [r["tp"]["steps"] for r in ranks.result()]
    a, b = got[0][step], got[1][step]
    for k, v in a["state"].items():
        np.testing.assert_array_equal(v, b["state"][k], err_msg=k)
    for k, v in a["obs"].items():
        np.testing.assert_array_equal(v, b["obs"][k], err_msg=k)
    assert a["metrics"] == b["metrics"]
    R.full_params(a["specs"], [a["shards"], b["shards"]])
    np.testing.assert_array_equal(got[0]["generator"], got[1]["generator"])


def test_dryrun_multichip(ranks):
    """dryrun_multichip(2) on a (2, 1) mesh: the three train steps run and
    their metrics are finite and global (equal on both ranks)."""
    got = [r["dryrun"] for r in ranks.result()]
    assert set(got[0]) == {"pooled+MLP", "fresh+MLP", "fresh+RNN"}
    assert got[0] == got[1]
    assert all(np.isfinite(v) for m in got[0].values() for v in m.values())
    assert got[0]["fresh+RNN"]["reset_overflow"] == 0
