"""Shared helpers for the tests of the PyTorch port (tests/test_torch_*.py).

Data crosses between the two packages as numpy arrays: JAX states are
exported with ``jax.tree.map(np.asarray, ...)`` and rebuilt on the CPU by
``minigrid_tpu_torch.convert``."""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import jax

import minigrid_tpu
from minigrid_tpu_torch.convert import (env_state_from_numpy, flatten_extra,
                                        state_from_numpy)
from minigrid_tpu_torch.core import constants as C

CPU = "cpu"
# torch threads per test process (the ``share_cpu`` fixture): pytest-xdist
# runs several workers on the machine's cores, and torch's default of one
# thread per core in each of them oversubscribes the CPU (two workers of
# tests/test_torch_{ppo,learning}.py took 830 s at 8 threads each, 54 s at
# 4 on an 8-core machine; the port's files under the tier-1 flags, 6
# workers on 8 cores, summed 1362.5 s of test time at 1 thread against
# 1902.8 s at 2)
TEST_THREADS = 1

# interaction-biased action stream of tests/test_fused_step.py
INTERACT = np.array([0, 1, 2, 2, 3, 4, 5, 5], np.int32)


@functools.lru_cache(maxsize=None)
def jax_env_fns(env_id: str, packed: bool = True):
    """(JAX env, its jitted ``vmap(env.reset)``, ``vmap(env._gen_grid)``),
    once per process: a test module's cases trace and compile them once
    per batch shape."""
    env = minigrid_tpu.make(env_id)
    if packed:
        env = env.packed()
    return env, jax.jit(jax.vmap(env.reset)), jax.jit(jax.vmap(env._gen_grid))


@functools.lru_cache(maxsize=None)
def jax_states(env_id: str, batch: int, seed: int = 0, packed: bool = True):
    """(JAX env, batched JAX states) from ``jax.vmap(env.reset)`` (cached:
    the states are immutable)."""
    env, reset, _ = jax_env_fns(env_id, packed)
    _, states = reset(jax.random.split(jax.random.PRNGKey(seed), batch))
    return env, states


def jax_keys(seed: int, B: int):
    """(JAX uint32 keys, the port's int32 view of the same bits)."""
    k = np.array(jax.random.split(jax.random.PRNGKey(seed), B))
    return jax.numpy.asarray(k), torch.from_numpy(k.view(np.int32))


def fresh_case(B: int, n_buf: int, seed: int):
    """DoorKey-8x8: JAX states near truncation (so resets happen), a JAX
    fresh buffer and the port's copies: (JAX env, states, buffer, the
    port's env, states, buffer)."""
    import minigrid_tpu_torch

    env_id = "MiniGrid-DoorKey-8x8-v0"
    # the states of jax_states(env_id, B, seed) and the buffer of
    # env.presample_fresh(PRNGKey(seed + 3), n_buf), both drawn by the
    # cached jitted generator (one compile per batch size)
    env, _, gen = jax_env_fns(env_id)
    st = gen(jax.random.split(jax.random.PRNGKey(seed), B))
    ms = env.params.max_steps
    st = st.replace(step_count=jax.numpy.asarray(
        ms - 1 - (np.arange(B) % 5), jax.numpy.int32))
    buf = gen(jax.random.split(jax.random.PRNGKey(seed + 3), n_buf))
    penv = minigrid_tpu_torch.make(env_id, device=CPU).packed()
    return env, st, buf, penv, export(st), export(buf)


def export(states):
    """Batched JAX EnvState -> the port's EnvState on the CPU."""
    return env_state_from_numpy(jax.tree.map(np.asarray, states), CPU)


def export_state(states):
    """Batched JAX state, wrapped (a JAX ``WrappedState``) or not -> the
    port's state on the CPU."""
    return state_from_numpy(jax.tree.map(np.asarray, states), CPU)


def action_stream(kind: str, T: int, B: int, seed: int = 1) -> np.ndarray:
    """(T, B) int32 actions: uniform over the 7 actions, or the
    interaction-biased stream."""
    rng = np.random.default_rng(seed)
    if kind == "interact":
        return INTERACT[rng.integers(0, len(INTERACT), (T, B))]
    return rng.integers(0, 7, (T, B)).astype(np.int32)


def assert_state_equal(port, ref, fields=("grid", "agent_pos", "agent_dir",
                                          "carrying", "step_count",
                                          "terminated", "truncated"),
                       msg=""):
    """Port EnvState == JAX EnvState on ``fields``, bit for bit, dtypes
    included; the field "extra" compares every entry (a nested JAX extra
    flattened as ``convert.flatten_extra`` flattens it)."""
    for k in fields:
        if k == "extra":
            want_x, got_x = ref.extra, port.extra
            assert (want_x is None) == (got_x is None), f"{msg} extra"
            want_x = None if want_x is None else flatten_extra(want_x)
            assert set(got_x or {}) == set(want_x or {}), f"{msg} extra"
            for name, v in (want_x or {}).items():
                want, got = np.asarray(v), got_x[name].numpy()
                assert got.dtype == want.dtype, f"{msg} extra {name}"
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"{msg} extra {name}")
            continue
        want = np.asarray(getattr(ref, k))
        got = getattr(port, k).numpy()
        if k == "rng":
            want = want.view(np.int32)
        np.testing.assert_array_equal(got, want, err_msg=f"{msg} {k}")


ALL_FIELDS = ("grid", "agent_pos", "agent_dir", "carrying", "step_count",
              "terminated", "truncated", "mission", "rng", "extra")


@functools.lru_cache(maxsize=None)
def jax_layouts(env_id: str, n: int, seed: int = 0):
    """(packed JAX env, ``n`` layouts from ``jax.vmap(env._gen_grid)``;
    cached)."""
    env, _, gen = jax_env_fns(env_id, True)
    return env, gen(jax.random.split(jax.random.PRNGKey(seed), n))


@functools.lru_cache(maxsize=None)
def jax_core_step(params):
    """The core transition and packed observation of the JAX package,
    vmapped and jitted (once per params): ``(states, actions) -> (obs,
    states, reward, terminated, truncated)``, what its fused step computes
    per step."""
    from minigrid_tpu.core.obs import gen_obs
    from minigrid_tpu.core.step import step_core

    def one(s, a):
        ns, r, te = step_core(params, s, a)
        ns = ns.replace(terminated=te)
        return gen_obs(params, ns)["packed"], ns, r, te, ns.truncated

    return jax.jit(jax.vmap(one))


def check_fused_step_against_jax(env_id, jenv, jst, kind, T=16, B=128):
    """The port's plain fused step (T steps of the first B exported
    states) bit-exact against T steps of the JAX core transition."""
    import torch

    from minigrid_tpu_torch.ops.fused_step import fused_rollout

    jst = jax.tree.map(lambda x: x[:B], jst)
    actions = action_stream(kind, T, B)
    p_new, p_obs, p_rew, p_te, p_tr = fused_rollout(
        jenv.params, export(jst), torch.from_numpy(actions))
    step = jax_core_step(jenv.params)
    for t in range(T):
        o, jst, r, te, tr = step(jst, jax.numpy.asarray(actions[t]))
        msg = f"{env_id} {kind} step {t}"
        np.testing.assert_array_equal(p_obs[t].numpy(), np.asarray(o),
                                      err_msg=msg)
        np.testing.assert_array_equal(p_rew[t].numpy(), np.asarray(r),
                                      err_msg=msg)
        np.testing.assert_array_equal(p_te[t].numpy(), np.asarray(te),
                                      err_msg=msg)
        np.testing.assert_array_equal(p_tr[t].numpy(), np.asarray(tr),
                                      err_msg=msg)
    assert_state_equal(p_new, jst, ALL_FIELDS, msg=env_id)


def categories(*samples):
    """Each sample's rows (e.g. mission token rows) as category ids common
    to all samples."""
    allrows = np.concatenate([np.asarray(s).reshape(len(s), -1)
                              for s in samples])
    _, inv = np.unique(allrows, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    out, i = [], 0
    for s in samples:
        out.append(inv[i:i + len(s)])
        i += len(s)
    return out


def binned(a, b, k: int = 8):
    """Two samples of a numeric feature cut into ``k`` bins at the
    quantiles of both together (so that a chi-square sees few empty
    cells)."""
    a, b = np.asarray(a), np.asarray(b)
    edges = np.unique(np.quantile(np.concatenate([a, b]),
                                  np.linspace(0, 1, k + 1)[1:-1]))
    return np.searchsorted(edges, a, "right"), np.searchsorted(edges, b,
                                                                "right")


def reachable(grid, start, passable) -> np.ndarray:
    """(W, H) cells reachable from ``start`` through 4-neighbours whose
    object type is in ``passable`` (numpy BFS on one (W, H, 5) grid)."""
    W, H = grid.shape[:2]
    ok = np.isin(grid[..., 0], list(passable))
    seen = np.zeros((W, H), bool)
    stack = [tuple(int(v) for v in start)]
    seen[stack[0]] = True
    while stack:
        x, y = stack.pop()
        for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            u, v = x + dx, y + dy
            if 0 <= u < W and 0 <= v < H and not seen[u, v] and ok[u, v]:
                seen[u, v] = True
                stack.append((u, v))
    return seen


def jax_train_step_closures(train_step) -> dict:
    """The closures of a JAX ``make_train_step`` result that the port's
    module-level functions mirror: ``gae``, ``loss_fn`` and ``rollout``
    (free variables of ``train_step_core``), and ``fresh_buffer`` /
    ``fresh_window`` (free variables of ``rollout``)."""
    def cells(fn):
        out = {}
        for k, c in zip(fn.__code__.co_freevars, fn.__closure__):
            try:
                out[k] = c.cell_contents
            except ValueError:  # a variable this configuration never set
                pass
        return out

    core = cells(train_step)["train_step_core"]
    out = cells(core)
    out.update({k: v for k, v in cells(out["rollout"]).items()
                if k in ("fresh_buffer", "fresh_window")})
    return out


def doorkey_features(grid, agent_pos, agent_dir):
    """Per DoorKey layout: split column, door row, key cell, agent cell and
    direction."""
    grid = np.asarray(grid)
    B, W, H, _ = grid.shape
    door = np.argwhere(grid[..., 0] == C.DOOR)
    key = np.argwhere(grid[..., 0] == C.KEY)
    assert len(door) == B and len(key) == B  # exactly one of each
    assert (door[:, 0] == np.arange(B)).all()
    pos = np.asarray(agent_pos)
    return {
        "split": door[:, 1],
        "door_row": door[:, 2],
        "key": key[:, 1] * H + key[:, 2],
        "agent": pos[:, 0] * H + pos[:, 1],
        "agent_dir": np.asarray(agent_dir),
    }


def chi2_same_distribution(a, b) -> float:
    """p-value of a chi-square test that two samples of categories come
    from one distribution."""
    from scipy import stats as sps

    cats = np.union1d(a, b)
    table = np.stack([(np.asarray(a)[:, None] == cats).sum(0),
                      (np.asarray(b)[:, None] == cats).sum(0)])
    return sps.chi2_contingency(table)[1]


@pytest.fixture(scope="module")
def share_cpu():
    """Run the module with :data:`TEST_THREADS` torch threads, then restore
    the process's setting."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, TEST_THREADS))
    yield
    torch.set_num_threads(n)


def to_jax_state(port_state):
    """The port's state (CPU tensors) as a batched JAX state: the inverse
    of :func:`export_state`. A ``WrappedState`` becomes JAX's, nested as
    it is; dotted ``extra`` keys nest again, BabyAI's ``instr.*`` into the
    JAX ``InstrState``/``Descs`` (packed masks back to uint32)."""
    import jax.numpy as jnp
    from minigrid_tpu.core.types import EnvState as JEnvState
    from minigrid_tpu.wrappers import WrappedState as JWrappedState
    from minigrid_tpu_torch.wrappers import WrappedState

    if isinstance(port_state, WrappedState):
        return JWrappedState(inner=to_jax_state(port_state.inner),
                             wrapper=jnp.asarray(port_state.wrapper.numpy()))

    def arr(t):
        return jnp.asarray(t.numpy())

    extra = None
    if port_state.extra is not None:
        flat = {k: v.numpy() for k, v in port_state.extra.items()}
        extra = {k: jnp.asarray(v) for k, v in flat.items()
                 if not k.startswith("instr.")}
        if any(k.startswith("instr.") for k in flat):
            extra["instr"] = to_jax_instr(flat)
    return JEnvState(
        grid=arr(port_state.grid), agent_pos=arr(port_state.agent_pos),
        agent_dir=arr(port_state.agent_dir),
        carrying=arr(port_state.carrying),
        step_count=arr(port_state.step_count),
        terminated=arr(port_state.terminated),
        truncated=arr(port_state.truncated), mission=arr(port_state.mission),
        rng=jnp.asarray(port_state.rng.numpy().view(np.uint32)), extra=extra)


def to_jax_instr(flat):
    """A JAX ``InstrState`` from the port's flat ``instr.*`` arrays (numpy,
    or tensors via an ``InstrState.to_extra()`` dict)."""
    import jax.numpy as jnp
    from minigrid_tpu.envs.babyai.core import instrs as JI

    flat = {k: np.asarray(v) for k, v in flat.items()}

    def a(k):
        v = flat["instr." + k]
        return jnp.asarray(v.view(np.uint32) if k.startswith("descs.mask")
                           else v)

    descs = JI.Descs(**{f: a("descs." + f) for f in (
        "type", "color", "loc", "count", "mask_objs", "mask_poss",
        "carried")})
    return JI.InstrState(descs=descs, **{f: a(f) for f in (
        "root_kind", "a_is_and", "b_is_and", "kinds", "strict", "pre_empty",
        "pre_move_carried", "last_match", "leaf_done", "a_done", "b_done")})
