"""The port's public surface against the JAX package's: the re-exports of
the six packages, ``vector(n)`` (JAX's ``vmap(reset)`` / ``vmap(
step_autoreset)`` pair) on a core env, a hook env and a wrapper stack,
``obs_shape()``, the env classes' ``name`` on every ID, the grid and cell
helpers of ``core/grid.py`` and ``core/types.py``, the object cells of
``envs/common.py`` and ``LayoutPool.replace``. Everything runs on the CPU,
bit for bit against the JAX functions on the same inputs."""

from __future__ import annotations

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import minigrid_tpu
from minigrid_tpu import wrappers as JW
from minigrid_tpu.core import grid as JG
from minigrid_tpu.core import types as JT
from minigrid_tpu.envs import common as JX

import minigrid_tpu_torch
from minigrid_tpu_torch import wrappers as PW
from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid as PG
from minigrid_tpu_torch.core import types as PT
from minigrid_tpu_torch.envs import common as PX
from minigrid_tpu_torch.ops import fused_rollout

from tests.torch_port_utils import share_cpu  # noqa: F401
from tests.torch_port_utils import CPU, INTERACT, export_state, to_jax_state
from tests.torch_wrapper_utils import assert_obs_equal, assert_wrapped_equal

pytestmark = pytest.mark.usefixtures("share_cpu")

DOORKEY = "MiniGrid-DoorKey-8x8-v0"
B = 64
T = 16
PACKAGES = ["", "models", "utils", "envs", "ops", "core"]


@pytest.mark.parametrize("package", PACKAGES)
def test_all_equals_jax(package):
    """Each package's ``__all__`` is the JAX package's, list for list, and
    every name resolves (``core``'s to its submodules)."""
    suffix = "." + package if package else ""
    jmod = importlib.import_module("minigrid_tpu" + suffix)
    pmod = importlib.import_module("minigrid_tpu_torch" + suffix)
    assert pmod.__all__ == jmod.__all__
    for name in pmod.__all__:
        obj = getattr(pmod, name)
        if package == "core":
            assert obj.__name__ == f"minigrid_tpu_torch.core.{name}"
        else:
            assert obj.__module__.startswith("minigrid_tpu_torch"), name
    if package == "ops":
        from minigrid_tpu_torch.ops import fused_step

        assert pmod.fused_rollout is fused_step.fused_rollout


# --- vector(n) ---------------------------------------------------------------

# name -> (env id, packed, wrapper or None)
VECTOR_CASES = {
    "DoorKey-8x8 packed": (DOORKEY, True, None),
    "DoorKey-8x8 image": (DOORKEY, False, None),
    # a hook env (the step hooks around the kernel's step entry): a MiniGrid
    # family, whose JAX generator compiles in ~2 s where BabyAI-GoToObj's
    # takes ~7 s, twice (chip_smoke.py drives BabyAI-GoToObj's vector)
    "GoToObject-8x8-N2": ("MiniGrid-GoToObject-8x8-N2-v0", True, None),
    "ActionBonus(DoorKey-8x8)": (DOORKEY, True, "ActionBonus"),
}


def both_envs(env_id, packed, wrapper):
    jenv = minigrid_tpu.make(env_id)
    penv = minigrid_tpu_torch.make(env_id, device=CPU)
    if packed:
        jenv, penv = jenv.packed(), penv.packed()
    if wrapper is not None:
        jenv, penv = getattr(JW, wrapper)(jenv), getattr(PW, wrapper)(penv)
    return jenv, penv


def bare(state):
    return state.inner if isinstance(state, JW.WrappedState) else state


def keys(seed):
    """(JAX keys of B envs, the port's int32 view of the same bits)."""
    k = np.array(jax.random.split(jax.random.PRNGKey(seed), B))
    return jnp.asarray(k), torch.from_numpy(k.view(np.int32))


def near_budget(state, max_steps):
    """``state`` with each env's step count 1-16 steps short of its
    episode budget (``max_steps``, or a BabyAI level's own in ``extra``),
    so that episodes end and reset within the run."""
    e = bare(state)
    if isinstance(e.extra, dict) and "max_steps" in e.extra:
        max_steps = e.extra["max_steps"]
    e = e.replace(step_count=(max_steps - 1 - jnp.arange(B) % T).astype(
        jnp.int32))
    return state.replace(inner=e) if isinstance(
        state, JW.WrappedState) else e


@pytest.mark.parametrize("case", list(VECTOR_CASES))
def test_vector_matches_jax(case):
    """``vector(B)``: its reset's shapes, the reset to JAX's layouts
    (``reset_from``) equal to JAX's ``vmap(reset)``, then T steps equal to
    JAX's ``vmap(step_autoreset)`` from the same states, keys and actions,
    the regen layouts (JAX's, of each step key's reset half) given as
    ``layouts``: observations, states, rewards and flags bit for bit (the
    wrapper's reward within rtol 1e-6, ROADMAP Queue 3)."""
    env_id, packed, wrapper = VECTOR_CASES[case]
    jenv, penv = both_envs(env_id, packed, wrapper)
    jreset, jstep = (jax.jit(f) for f in jenv.vector(B))
    preset, pstep = penv.vector(B)

    g = torch.Generator().manual_seed(0)
    pobs, pst = preset(g)
    jk, _ = keys(0)
    jobs, jst = jreset(jk)
    assert pst.batch_size == B
    assert {k: tuple(v.shape) for k, v in pobs.items()} == {
        k: v.shape for k, v in jobs.items()}
    pobs, pst = penv.reset_from(export_state(bare(jst)))
    assert_obs_equal(pobs, jobs, f"{case} reset")
    assert_wrapped_equal(pst, jst, f"{case} reset")

    jst = near_budget(jst, jenv.params.max_steps)
    pst = export_state(jst)
    acts = np.random.default_rng(1).integers(0, 7, (T, B)).astype(np.int32)
    resets = 0
    for t in range(T):
        jk, pk = keys(100 + t)
        layouts = bare(jreset(jax.vmap(lambda k: jax.random.split(k)[1])(
            jk))[1])
        j = jstep(jk, jst, jnp.asarray(acts[t]))
        p = pstep(pk, pst, torch.from_numpy(acts[t]), g,
                  layouts=export_state(layouts))
        msg = f"{case} step {t}"
        assert_obs_equal(p[0], j[0], f"{msg} obs")
        assert_wrapped_equal(p[1], j[1], f"{msg} state")
        if wrapper is None:
            np.testing.assert_array_equal(p[2].numpy(), np.asarray(j[2]),
                                          err_msg=f"{msg} reward")
        else:
            np.testing.assert_allclose(p[2].numpy(), np.asarray(j[2]),
                                       rtol=1e-6, err_msg=f"{msg} reward")
        for i, name in ((3, "terminated"), (4, "truncated")):
            np.testing.assert_array_equal(p[i].numpy(), np.asarray(j[i]),
                                          err_msg=f"{msg} {name}")
        resets += int((p[3] | p[4]).sum())
        jst, pst = j[1], p[1]
    assert resets >= B
    with pytest.raises(ValueError, match=f"vector\\({B}\\)"):
        pstep(pk[:8], pst.map(lambda x: x[:8]), torch.zeros(8), g)


def test_wrapper_vector_goes_through_the_stack():
    """A stack's ``vector`` is its own (``Wrapper.vector``), never the bare
    env's reached through ``__getattr__``: an array observation wrapper's
    pair returns the stack's observations, and its step equals the
    stack's ``step_autoreset``."""
    env = minigrid_tpu_torch.make(DOORKEY, device=CPU).packed()
    w = PW.ImgObsWrapper(PW.ActionBonus(env))
    assert type(w).vector is PW.Wrapper.vector
    reset, step = w.vector(8)
    g = env.generator(3)
    obs, st = reset(g)
    bare_obs, _ = env.vector(8)[0](env.generator(3))
    assert isinstance(obs, torch.Tensor) and isinstance(bare_obs, dict)
    assert torch.equal(obs, bare_obs["packed"])
    assert isinstance(st, PW.WrappedState)
    st = st.replace(inner=st.inner.replace(step_count=torch.full(
        (8,), env.params.max_steps - 1, dtype=torch.int32)))
    k = torch.arange(16, dtype=torch.int32).reshape(8, 2)
    a = torch.full((8,), 2, dtype=torch.int32)
    layouts = env._gen_grid(env.generator(4), 8)
    got = step(k, st, a, g, layouts)
    want = w.step_autoreset(k, st, a, g, layouts)
    assert torch.equal(got[0], want[0]) and got[0].shape == (8, 7, 7)
    assert torch.equal(got[0], env.reset_from(layouts)[0]["packed"])
    assert torch.equal(got[1].wrapper, want[1].wrapper)
    assert torch.equal(got[2], want[2]) and bool((got[4]).all())


@pytest.mark.parametrize("kind", ["packed", "image", "wrapped"])
def test_obs_shape_matches_jax(kind):
    """``obs_shape()`` of a packed and an image env, and through a wrapper
    (which forwards it to the env it wraps, as JAX's does)."""
    for env_id in (DOORKEY, "BabyAI-GoToObj-v0"):
        jenv = minigrid_tpu.make(env_id)
        penv = minigrid_tpu_torch.make(env_id, device=CPU)
        if kind != "image":
            jenv, penv = jenv.packed(), penv.packed()
        if kind == "wrapped":
            jenv, penv = JW.ActionBonus(jenv), PW.ActionBonus(penv)
        assert penv.obs_shape() == jenv.obs_shape()
    penv = minigrid_tpu_torch.make(DOORKEY, device=CPU).replace_params(
        view_size=9)
    assert penv.obs_shape()["image"] == (9, 9, 3)


def test_env_names_match_jax():
    """``type(make(id)).name`` is the JAX class's on all 178 IDs."""
    ids = minigrid_tpu.registered_ids()
    assert len(ids) == 178 and minigrid_tpu_torch.registered_ids() == ids
    for env_id in ids:
        want = type(minigrid_tpu.make(env_id)).name
        got = type(minigrid_tpu_torch.make(env_id, device=CPU)).name
        assert got == want, env_id
    assert minigrid_tpu_torch.envs.MiniGridEnv.name == "MiniGridEnv"


# --- the grid and cell helpers ---------------------------------------------

GRID_IDS = [DOORKEY, "MiniGrid-KeyCorridorS6R3-v0", "BabyAI-BossLevel-v0"]


def stepped_states(env_id):
    """B port states after T interaction steps on the CPU (objects picked
    up and moved), with the doors of every other env then set open."""
    env = minigrid_tpu_torch.make(env_id, device=CPU).packed()
    _, st = env.reset(env.generator(5), B)
    rng = np.random.default_rng(6)
    acts = torch.from_numpy(INTERACT[rng.integers(0, len(INTERACT), (T, B))])
    st = fused_rollout(env.params, st, acts)[0]
    grid = st.grid.clone()
    doors = (grid[..., 0] == C.DOOR) & (torch.arange(B) % 2 == 0)[
        :, None, None]
    grid[..., 2][doors] = C.OPEN
    return st.replace(grid=grid)


@pytest.mark.parametrize("env_id", GRID_IDS)
def test_grid_helpers_match_jax(env_id):
    """``encode`` with and without a visibility mask, ``decode``,
    ``get_cell`` in and out of range, ``transparent_mask`` and
    ``can_overlap_mask`` on B stepped grids, bit for bit against the JAX
    functions under ``vmap``; each also on one unbatched grid."""
    grid = stepped_states(env_id).grid
    W, H = grid.shape[1:3]
    g = grid.numpy()
    rng = np.random.default_rng(7)
    vis = rng.random((B, W, H)) < 0.5
    x = rng.integers(-2, W + 2, B).astype(np.int32)
    y = rng.integers(-2, H + 2, B).astype(np.int32)
    assert ((x < 0) | (x >= W) | (y < 0) | (y >= H)).any()
    is_open = g[..., 2] == C.OPEN
    assert ((g[..., 0] == C.DOOR) & is_open).any()
    assert ((g[..., 0] == C.DOOR) & ~is_open).any()

    def same(got, fn, *args):
        want = jax.jit(jax.vmap(fn))(*(jnp.asarray(a) for a in args))
        assert got.numpy().dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    same(PG.encode(grid), JG.encode, g)
    same(PG.encode(grid, torch.from_numpy(vis)), JG.encode, g, vis)
    enc = PG.encode(grid, torch.from_numpy(vis))
    same(PG.decode(enc), JG.decode, enc.numpy())
    assert torch.equal(PG.decode(enc.numpy(), device=CPU), PG.decode(enc))
    same(PG.get_cell(grid, torch.from_numpy(x), torch.from_numpy(y)),
         JG.get_cell, g, x, y)
    same(PG.transparent_mask(grid), JG.transparent_mask, g)
    same(PG.can_overlap_mask(grid), JG.can_overlap_mask, g)
    # one grid, int coordinates
    for i in range(4):
        np.testing.assert_array_equal(
            PG.get_cell(grid[i], int(x[i]), int(y[i])).numpy(),
            np.asarray(JG.get_cell(jnp.asarray(g[i]), int(x[i]),
                                   int(y[i]))))
    np.testing.assert_array_equal(PG.transparent_mask(grid[0]).numpy(),
                                  np.asarray(JG.transparent_mask(g[0])))


def test_cells_match_jax():
    """``pack_cell`` from ints and from per-env tensors, and the object
    cells of ``envs/common.py``; Fetch's ``OBJ_TYPES``."""
    np.testing.assert_array_equal(
        PT.pack_cell(C.BOX, 2, 1, C.KEY, 4, device=CPU).numpy(),
        np.asarray(JT.pack_cell(C.BOX, 2, 1, C.KEY, 4)))
    rng = np.random.default_rng(8)
    t, c = rng.integers(0, 11, B), rng.integers(0, 6, B)
    got = PT.pack_cell(torch.from_numpy(t), torch.from_numpy(c), 1)
    want = jax.vmap(lambda a, b: JT.pack_cell(a, b, 1))(t, c)
    assert got.dtype == torch.uint8 and got.device.type == CPU
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for color in range(6):
        for state in (C.OPEN, C.CLOSED, C.LOCKED):
            np.testing.assert_array_equal(
                PX.door(color, state, device=CPU).numpy(),
                np.asarray(JX.door(color, state)))
        for fn in ("key", "ball"):
            np.testing.assert_array_equal(
                getattr(PX, fn)(color, device=CPU).numpy(),
                np.asarray(getattr(JX, fn)(color)))
        np.testing.assert_array_equal(
            PX.box(color, C.BALL, 3, device=CPU).numpy(),
            np.asarray(JX.box(color, C.BALL, 3)))
    np.testing.assert_array_equal(PX.door(torch.arange(3)).numpy(),
                                  np.asarray(jax.vmap(JX.door)(
                                      jnp.arange(3))))
    from minigrid_tpu.envs import fetch as jfetch
    from minigrid_tpu_torch.envs import fetch as pfetch

    assert pfetch.OBJ_TYPES == jfetch.OBJ_TYPES


def test_is_carrying_matches_jax():
    """``is_carrying`` on stepped DoorKey states, some carrying the key,
    against JAX's under ``vmap``."""
    st = stepped_states(DOORKEY)
    got = PT.is_carrying(st)
    want = jax.vmap(JT.is_carrying)(to_jax_state(st))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.bool and 0 < int(got.sum()) < B


def test_layout_pool_replace():
    """``LayoutPool.replace`` returns a new pool with the fields given and
    leaves the pool it copies alone, as the JAX struct's does."""
    env = minigrid_tpu_torch.make(DOORKEY, device=CPU)
    pool = env.make_pool(env.generator(9), 8)
    mission = torch.zeros_like(pool.mission)
    new = pool.replace(mission=mission)
    assert new.mission is mission and new.grid is pool.grid
    assert (new.width, new.height, new.size) == (8, 8, 8)
    assert not torch.equal(pool.mission, mission)
    assert torch.equal(new.entry(3).mission, mission[3:4])
