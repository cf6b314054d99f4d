"""The port's fused step (minigrid_tpu_torch/ops/fused_step.py).

On the CPU its plain version must reproduce the JAX package's Pallas kernel
(``fused_rollout(..., interpret=True)``, as tests/test_fused_step.py runs it)
and the JAX pooled auto-reset bit-exactly, the reward within rtol 1e-6.
The CUDA kernel itself runs only on the card
(tests/test_torch_kernel_gpu.py)."""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from minigrid_tpu.envs.base import (autoreset_step_presampled as
                                    j_autoreset_presampled,
                                    presample_reset_states as j_presample)
from minigrid_tpu.ops.fused_step import fused_rollout as j_fused_rollout

import minigrid_tpu_torch
from minigrid_tpu_torch.envs.base import (MiniGridEnv, pool_from_states,
                                          random_keys)
from minigrid_tpu_torch.ops import fused_step as F
from minigrid_tpu_torch.ops import native
from minigrid_tpu_torch.ops.fused_step import (fused_rollout,
                                               require_core_dynamics)
from minigrid_tpu_torch.ops.native import COUNTERS

from tests.torch_port_utils import share_cpu  # noqa: F401
from tests.torch_port_utils import (CPU, action_stream, assert_state_equal,
                                    export, jax_states)

pytestmark = pytest.mark.usefixtures("share_cpu")

CASES = [
    ("MiniGrid-Empty-8x8-v0", "uniform"),
    ("MiniGrid-DoorKey-8x8-v0", "uniform"),
    ("MiniGrid-DoorKey-5x5-v0", "interact"),
]


# the CASES at the default view size, and DoorKey-8x8 at V=9 with the
# params ViewSizeWrapper(env, 9) renders with
VIEW_CASES = [pytest.param(e, k, 7, id=f"{e}-{k}") for e, k in CASES] + [
    pytest.param("MiniGrid-DoorKey-8x8-v0", "uniform", 9,
                 id="MiniGrid-DoorKey-8x8-v0-uniform-view9")]


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("env_id,kind,view", VIEW_CASES)
def test_plain_matches_jax_pallas_kernel(env_id, kind, view, native):
    B, T = 128, 8
    env, jst = jax_states(env_id, B)
    params = dataclasses.replace(env.params, view_size=view)
    actions = action_stream(kind, T, B)
    j_new, j_obs, j_rew, j_te, j_tr = j_fused_rollout(
        params, jst, jnp.asarray(actions), T_tile=8, interpret=True,
        native_layout=native)
    launches = COUNTERS.launches
    p_new, p_obs, p_rew, p_te, p_tr = fused_rollout(
        params, export(jst), torch.from_numpy(actions),
        native_layout=native)
    assert p_obs.shape[-1] == (B if native else view)
    assert COUNTERS.launches == launches  # CPU tensors: the plain version
    np.testing.assert_array_equal(p_obs.numpy(), np.asarray(j_obs))
    np.testing.assert_allclose(p_rew.numpy(), np.asarray(j_rew), rtol=1e-6)
    np.testing.assert_array_equal(p_te.numpy(), np.asarray(j_te))
    np.testing.assert_array_equal(p_tr.numpy(), np.asarray(j_tr))
    assert_state_equal(p_new, j_new, fields=(
        "grid", "agent_pos", "agent_dir", "carrying", "step_count",
        "terminated", "truncated", "mission", "rng"))


def _reset_case(env_id, B=96, T=10, seed=0):
    """JAX and port inputs for T pooled auto-reset steps: states close to
    truncation (so resets happen), per-step keys, presampled reset rows."""
    env, jst = jax_states(env_id, B, seed)
    ms = env.params.max_steps
    jst = jst.replace(step_count=jnp.asarray(
        ms - 1 - (np.arange(B) % (T + 4)), jnp.int32))
    pool = env.make_pool(jax.random.PRNGKey(seed + 5), 16)
    j_rows = j_presample(jax.random.PRNGKey(seed + 6), pool, T)
    keys = jax.random.split(jax.random.PRNGKey(seed + 7), T * B)
    keys = np.array(keys).reshape(T, B, 2)
    p_rows = pool_from_states(export(j_rows))
    return env, jst, keys, j_rows, p_rows


@pytest.mark.parametrize("env_id,kind", CASES)
def test_reset_row_entry_matches_jax_autoreset(env_id, kind):
    B, T = 96, 10
    env, jst, keys, j_rows, p_rows = _reset_case(env_id, B, T)
    actions = action_stream(kind, T, B)
    penv = minigrid_tpu_torch.make(env_id, device=CPU).packed()
    pst = export(jst)
    step = jax.jit(lambda k, s, a, r: j_autoreset_presampled(env, k, s, a, r))
    n_done = 0
    for t in range(T):
        j_row = jax.tree.map(lambda x: x[t], j_rows)
        jo, jst, jr, jte, jtr, _ = step(jnp.asarray(keys[t]), jst,
                                        jnp.asarray(actions[t]), j_row)
        po, pst, pr, pte, ptr, _ = penv.step_autoreset_presampled(
            torch.from_numpy(keys[t].view(np.int32)), pst,
            torch.from_numpy(actions[t]), p_rows.rows(t))
        msg = f"{env_id} step {t}"
        for k in jo:
            np.testing.assert_array_equal(po[k].numpy(), np.asarray(jo[k]),
                                          err_msg=f"{msg} obs {k}")
        assert_state_equal(pst, jst, msg=msg, fields=(
            "grid", "agent_pos", "agent_dir", "carrying", "step_count",
            "terminated", "truncated", "mission", "rng"))
        np.testing.assert_allclose(pr.numpy(), np.asarray(jr), rtol=1e-6)
        np.testing.assert_array_equal(pte.numpy(), np.asarray(jte))
        np.testing.assert_array_equal(ptr.numpy(), np.asarray(jtr))
        n_done += int((pte | ptr).sum())
    assert n_done >= B // 2  # the case really exercises the reset select


def test_reset_rows_over_t_steps_match_single_steps():
    """The T-step reset-row entry equals T single-step calls."""
    B, T = 64, 10
    env, jst, keys, _, rows = _reset_case("MiniGrid-DoorKey-8x8-v0", B, T)
    st0 = export(jst)
    actions = torch.from_numpy(action_stream("uniform", T, B))
    st, obs, rew, te, tr = fused_rollout(env.params, st0, actions,
                                         reset_grid=rows.grid,
                                         reset_scal=rows.scal)
    st1 = st0
    for t in range(T):
        st1, o, r, e, u = fused_rollout(
            env.params, st1, actions[t:t + 1], reset_grid=rows.grid[t:t + 1],
            reset_scal=rows.scal[t:t + 1])
        assert torch.equal(o[0], obs[t]) and torch.equal(r[0], rew[t])
        assert torch.equal(e[0], te[t]) and torch.equal(u[0], tr[t])
    for k, v in st.tensors().items():
        assert torch.equal(v, getattr(st1, k)), k


def test_ragged_batch_matches_step_composition():
    """B=100 (not a multiple of the kernel's block) against the port's
    step_state + gen_obs, composed step by step."""
    from minigrid_tpu_torch.core.obs import gen_obs

    env = minigrid_tpu_torch.make("MiniGrid-DoorKey-8x8-v0",
                                  device=CPU).packed()
    g = env.generator(3)
    _, st = env.reset(g, 100)
    actions = torch.from_numpy(action_stream("interact", 12, 100))
    new, obs, rew, te, tr = fused_rollout(env.params, st, actions)
    keys = random_keys(g, (100, 2), CPU)
    for t in range(12):
        st, r, e, u = env.step_state(keys, st, actions[t])
        assert torch.equal(gen_obs(env.params, st)["packed"], obs[t])
        assert torch.equal(r, rew[t]) and torch.equal(e, te[t])
        assert torch.equal(u, tr[t])
    for k, v in st.tensors().items():
        assert torch.equal(v, getattr(new, k)), k


def test_env_step_goes_through_fused_step():
    env = minigrid_tpu_torch.make("MiniGrid-DoorKey-5x5-v0", device=CPU)
    g = env.generator(0)
    obs, st = env.reset(g, 16)
    keys = random_keys(g, (16, 2), CPU)
    a = torch.from_numpy(action_stream("interact", 1, 16)[0])
    o, st2, r, te, tr, _ = env.step(keys, st, a)
    want = env.step_state(keys, st, a)
    for k, v in want[0].tensors().items():
        assert torch.equal(v, getattr(st2, k)), k
    assert o["image"].shape == (16, 7, 7, 3) and o["image"].dtype == \
        torch.uint8


def test_kernel_wrapper_refuses_cpu_tensors():
    env = minigrid_tpu_torch.make("MiniGrid-DoorKey-8x8-v0", device=CPU)
    _, st = env.reset(env.generator(0), 4)
    a = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        F._fused_rollout_cuda(env.params, st, a, False, None, None)
    with pytest.raises(ValueError, match="together"):
        fused_rollout(env.params, st, a, reset_grid=torch.zeros((1, 64)))


def test_shared_memory_and_build_flags():
    # per env: the packed cells (an odd word count) and the V*V observation
    # words; then from a 16-byte boundary the 8 warps' 8-byte barriers and
    # the block's run of grids, unpadded, with 19 bytes of slack rounded up
    # to 16
    assert F.shared_memory_bytes(64, 7, 16) == (16 * (65 + 49) * 4 + 64
                                                + 16 * 320 + 32)
    assert F.shared_memory_bytes(25, 7, 32) == (32 * (25 + 49) * 4 + 64
                                                + 32 * 125 + 32)
    assert F.shared_memory_bytes(25, 9, 1) == 108 * 4 + 64 + 144  # 106 words
    # a 32x32 grid fits a block of 8 envs at G=32, not the 32 envs of a
    # one-lane warp
    assert F.launch_geometry(64, 32, 32, 7, 132, 32).envs_per_block == 8
    with pytest.raises(ValueError, match="shared memory"):
        F.launch_geometry(64, 32, 32, 7, 132, 1)
    env = minigrid_tpu_torch.make("MiniGrid-Empty-8x8-v0", device=CPU)
    _, st = env.reset(env.generator(0), 2)
    with pytest.raises(ValueError, match="view size"):
        F._fused_rollout_cuda(env.replace_params(view_size=65).params, st,
                              torch.zeros((1, 2), dtype=torch.int32), False,
                              None, None)
    for bad in (8, 65, 1):
        with pytest.raises(ValueError, match="view size"):
            F.check_view_size(bad)
        with pytest.raises(ValueError, match="view size"):
            F.launch_geometry(64, 8, 8, bad, 132)
    with pytest.raises(ValueError, match="group_lanes"):
        F.launch_geometry(64, 8, 8, 7, 132, 3)
    flags = " ".join(native.NVCC_FLAGS)
    assert "sm_90a" in flags and "-fmad=false" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    assert F.SOURCE.exists()


def test_build_compiles_the_sources_it_is_given(tmp_path, monkeypatch):
    """``native.build(sources)`` compiles every source into one library
    named after the first, under BUILD_DIR, with the kernels' flags; it
    compiles once per sources and flags, again after an edit (a stand-in
    compiler here, which writes its arguments to the library)."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nout=""; prev=""\nfor a in "$@"; do\n'
                    '  [ "$prev" = "-o" ] && out="$a"; prev="$a"\ndone\n'
                    'echo "$@" > "$out"\necho "ptxas info: Used 9 '
                    'registers"\n')
    nvcc.chmod(0o755)
    calls = []
    monkeypatch.setattr(native, "_nvcc",
                        lambda: calls.append(1) or str(nvcc))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    a, b = tmp_path / "first.cu", tmp_path / "second.cu"
    a.write_text("// a")
    b.write_text("// b")
    lib, log = native.build((a, b))
    assert lib.parent == tmp_path / "build"
    assert lib.name.startswith("libfirst_") and lib.suffix == ".so"
    args = lib.read_text().split()
    assert args[-2:] == [str(a), str(b)]
    assert args[:len(native.NVCC_FLAGS)] == native.NVCC_FLAGS
    assert "Used 9 registers" in log
    assert native.build((a, b)) == (lib, "") and len(calls) == 1
    b.write_text("// b, edited")
    edited, _ = native.build((a, b))
    assert edited != lib and len(calls) == 2
    assert F.LIBRARY.source == F.SOURCE


@pytest.mark.parametrize("group_lanes", [None, *F.GROUP_LANES])
def test_launch_geometry_fits_every_env_and_view(group_lanes):
    """Every registered env at every odd view size 3..63: a valid block
    (whole warps, at most MAX_THREADS threads) under the shared-memory
    limit, covering the batch. A G given explicitly raises exactly where
    one warp of its envs exceeds the limit (G=1 from a view of 21 on
    MultiRoom's 25x25, 27 on BabyAI's 22x22 mazes, 31 on the 20x20 room
    and 33-43 on the other grids; G=2 from 49-61); the picked G always
    fits, and gives the blocks an SM holds at once
    ``RESIDENT_WARPS_PER_SM`` warps unless it is already the widest."""
    sizes = set()
    for env_id in minigrid_tpu_torch.registered_ids():
        p = minigrid_tpu_torch.make(env_id, device=CPU).params
        sizes.add((p.width, p.height))
    assert {(25, 25), (22, 22), (16, 8)} <= sizes
    over = set()
    for w, h in sorted(sizes):
        for v in range(3, 64, 2):
            for batch in (1, 1001, 4096, 65536):
                if group_lanes is not None and F.shared_memory_bytes(
                        w * h, v, 32 // group_lanes) > F.SMEM_LIMIT:
                    over.add((w, h, v))
                    with pytest.raises(ValueError, match="shared memory"):
                        F.launch_geometry(batch, w, h, v, 132, group_lanes)
                    continue
                geo = F.launch_geometry(batch, w, h, v, 132, group_lanes)
                assert geo.shared_memory_bytes <= F.SMEM_LIMIT
                assert geo.shared_memory_bytes == F.shared_memory_bytes(
                    w * h, v, geo.envs_per_block)
                assert geo.threads == geo.envs_per_block * geo.group_lanes
                assert geo.threads % 32 == 0
                assert geo.threads <= F.MAX_THREADS
                assert geo.blocks * geo.envs_per_block >= batch
                assert (geo.blocks - 1) * geo.envs_per_block < batch
                if group_lanes is None:
                    assert (F.resident_warps(geo) >= F.RESIDENT_WARPS_PER_SM
                            or geo.group_lanes == F.GROUP_LANES[-1])
    # the first view that one warp of G=1 or G=2 envs cannot hold, per grid
    first = {
        1: {(4, 4): 43, (5, 5): 43, (6, 6): 43, (7, 3): 43, (7, 4): 43,
            (7, 5): 43, (7, 7): 43, (8, 8): 41, (9, 5): 43, (9, 7): 41,
            (9, 9): 41, (10, 10): 41, (11, 6): 41, (11, 11): 41,
            (12, 6): 41, (12, 12): 39, (13, 7): 41, (13, 9): 41,
            (13, 13): 39, (15, 8): 41, (16, 6): 41, (16, 8): 41,
            (16, 16): 37, (17, 17): 35, (19, 19): 33, (20, 20): 31,
            (22, 22): 27, (25, 25): 21},
        2: {(4, 4): 61, (5, 5): 61, (6, 6): 61, (7, 3): 61, (7, 4): 61,
            (7, 5): 61, (7, 7): 61, (8, 8): 61, (9, 5): 61, (9, 7): 61,
            (9, 9): 59, (10, 10): 59, (11, 6): 61, (11, 11): 59,
            (12, 6): 59, (12, 12): 59, (13, 7): 59, (13, 9): 59,
            (13, 13): 59, (15, 8): 59, (16, 6): 59, (16, 8): 59,
            (16, 16): 57, (17, 17): 55, (19, 19): 55, (20, 20): 53,
            (22, 22): 51, (25, 25): 49}}.get(group_lanes, {})
    assert set(first) <= sizes
    want = {(w, h, v) for (w, h), v0 in first.items()
            for v in range(v0, 64, 2)}
    assert over == want


def test_launch_geometry_fills_the_card():
    """B=4096 (the rollout's batch) on an H100's 132 SMs: G=8, blocks of 8
    warps on 128 SMs (7.8 warps per SM over all 132); B=65536 needs no
    more than one lane per env. Where one block holds an SM's shared
    memory, G is widened until that block has 8 warps: G=32 for the 8 envs
    of a block at a view of 63 on 25x25 (G=8 gave 2 warps), G=8 for
    MultiRoom's 25x25 at view 7 at B=65536 (G=1 gave 1); a view of 33 on
    8x8 keeps G=8 (32 envs, 8 warps). The choice depends on its arguments
    alone."""
    geo = F.launch_geometry(4096, 8, 8, 7, 132)
    assert geo.group_lanes >= 8 and geo.threads // 32 >= 8
    assert geo.blocks >= 128
    assert geo.blocks * geo.threads / 32 / 132 >= F.MIN_WARPS_PER_SM
    assert geo == F.launch_geometry(4096, 8, 8, 7, 132)
    big = F.launch_geometry(65536, 8, 8, 7, 132)
    assert big.group_lanes == 1
    for grid in ((25, 25), (22, 22), (16, 16)):  # the main path's batch
        assert F.launch_geometry(4096, *grid, 7, 132).group_lanes == 8
    wide = F.launch_geometry(4096, 25, 25, 63, 132)
    assert (wide.group_lanes, wide.envs_per_block, wide.threads) == (32, 8,
                                                                     256)
    assert F.resident_warps(wide) == 8
    assert F.launch_geometry(4096, 8, 8, 33, 132).group_lanes == 8
    many = F.launch_geometry(65536, 25, 25, 7, 132)
    assert (many.group_lanes, many.envs_per_block) == (8, 32)
    assert F.resident_warps(many) == 8
    picks = [F.pick_group_lanes(b, 132) for b in (64, 4096, 8192, 65536)]
    assert picks == [32, 8, 4, 1]
    assert picks == [F.pick_group_lanes(b, 132) for b in (64, 4096, 8192,
                                                           65536)]


# grid sizes of the catalog's families (the step entry's test collects all
# 178 IDs' sizes), from the smallest to the largest
CATALOG_GRIDS = [(4, 4), (5, 5), (7, 3), (8, 8), (16, 8), (16, 16),
                 (22, 22), (25, 25)]


@pytest.mark.parametrize("group_lanes", [None, *F.GROUP_LANES])
def test_observe_geometry_fits_every_grid_and_view(group_lanes):
    """The observe entry's geometry at every odd view 3..63 and batch:
    whole warps, at most MAX_THREADS threads, under the shared-memory
    limit, covering the batch. It takes no grid size (the entry reads each
    window from device memory), so one geometry serves every catalog grid.
    An explicit G raises exactly where one warp of its envs' views exceeds
    the limit (G=1 from a view of 43, G=2 from 61); the picked G always
    fits, leaves a lane at most OBSERVE_CELLS_PER_ROW cells of a row, and
    gives an SM RESIDENT_WARPS_PER_SM warps unless it is the widest."""
    import inspect

    params = inspect.signature(F.observe_launch_geometry).parameters
    assert not {"width", "height", "num_cells"} & set(params)
    over = set()
    for v in range(3, 64, 2):
        for batch in (1, 1001, 4096, 65536):
            if group_lanes is not None and F.observe_shared_memory_bytes(
                    v, 32 // group_lanes) > F.SMEM_LIMIT:
                over.add(v)
                with pytest.raises(ValueError, match="shared memory"):
                    F.observe_launch_geometry(batch, v, 132, group_lanes)
                continue
            geo = F.observe_launch_geometry(batch, v, 132, group_lanes)
            assert geo.shared_memory_bytes <= F.SMEM_LIMIT
            assert geo.shared_memory_bytes == F.observe_shared_memory_bytes(
                v, geo.envs_per_block)
            assert geo.threads == geo.envs_per_block * geo.group_lanes
            assert geo.threads % 32 == 0 and geo.threads <= F.MAX_THREADS
            assert geo.blocks * geo.envs_per_block >= batch
            assert (geo.blocks - 1) * geo.envs_per_block < batch
            if group_lanes is None:
                assert -(-v // geo.group_lanes) <= F.OBSERVE_CELLS_PER_ROW
                assert (F.resident_warps(geo) >= F.RESIDENT_WARPS_PER_SM
                        or geo.group_lanes == F.GROUP_LANES[-1])
    first = {1: 43, 2: 61}.get(group_lanes, 65)
    assert over == set(range(first, 64, 2))
    with pytest.raises(ValueError, match="view size"):
        F.observe_launch_geometry(64, 65, 132)
    with pytest.raises(ValueError, match="group_lanes"):
        F.observe_launch_geometry(64, 7, 132, 3)


@pytest.mark.parametrize("view", [3, 7, 9, 33, 63])
def test_observe_geometry_fills_the_card(view):
    """B=4096 (the fresh and regen rollouts' batch) on an H100's 132 SMs:
    at least MIN_WARPS_PER_SM warps for every SM at every view, all of them
    resident at once up to view 33. G=8 and 32 envs a block (6,272 B) at
    view 7; G=16 at view 33; G=32 at view 63, whose views let an SM hold
    14 of the batch's 31 warps an SM."""
    geo = F.observe_launch_geometry(4096, view, 132)
    warps = geo.blocks * geo.threads // 32
    assert warps / 132 >= F.MIN_WARPS_PER_SM
    assert (F.resident_warps(geo) * 132 >= warps) == (view <= 33)
    assert geo == F.observe_launch_geometry(4096, view, 132)
    want = {3: (8, 32), 7: (8, 32), 9: (8, 32), 33: (16, 16), 63: (32, 2)}
    assert (geo.group_lanes, geo.envs_per_block) == want[view]
    if view == 7:
        assert geo.shared_memory_bytes == 6272
        # a rank's B=2048 of the multi-device step: G=16
        assert F.observe_launch_geometry(2048, 7, 132).group_lanes == 16


@pytest.mark.parametrize("width,height", CATALOG_GRIDS)
def test_observe_shared_memory_does_not_grow_with_the_grid(width, height):
    """The observe entry's block holds only its envs' view words: at view 7
    and 32 envs 6,272 B on every grid, where the step entry's block, which
    stages the grids, grows with W*H (186,368 B at 25x25)."""
    nc = width * height
    assert F.observe_shared_memory_bytes(7, 32) == 32 * 49 * 4 == 6272
    step = F.shared_memory_bytes(nc, 7, 32)
    assert step > F.observe_shared_memory_bytes(7, 32) + 5 * nc * 32
    if (width, height) == (25, 25):
        assert step == 186368


@functools.cache
def registered_grids() -> tuple:
    """The (width, height) of every registered ID."""
    return tuple(sorted({(p.width, p.height) for p in (
        minigrid_tpu_torch.make(env_id, device=CPU).params
        for env_id in minigrid_tpu_torch.registered_ids())}))


@pytest.mark.parametrize("view", [3, 7, 9, 33, 63])
def test_step_entry_stages_the_run_unpadded(view):
    """The step entry's block stages its envs' grids as one run, as they lie
    in device memory: past the packed cells and the view words its shared
    memory is the run's envs x W*H*5 bytes, the warps' barriers (64) and
    at most the slack the bulk copies need (15 bytes to match the run's
    offset modulo 16, one word after it, rounded up to 16), never a padded
    grid an env. At 25x25, view 7, 32 envs that is 186,368 B, under the
    186,624 B of 16-byte padded grids, and the blocks an SM holds keep their
    8 warps."""
    grids = registered_grids()
    assert {(5, 5), (9, 9), (19, 19), (22, 22), (25, 25)} <= set(grids)
    least = F.BARRIER_BYTES + F.RUN_SLACK
    for w, h in grids:
        nc = w * h
        for envs in (1, 2, 4, 8, 16, 32, 64, 128, 256):
            words = envs * ((nc | 1) + view ** 2)
            staged = F.shared_memory_bytes(nc, view, envs) - (
                (words + 3) // 4 * 16)
            run = envs * 5 * nc
            assert run + least <= staged <= run + least + 15, (w, h, envs)
            assert staged % 16 == 0
    if view == 7:
        assert F.shared_memory_bytes(625, 7, 32) == 186368 <= 186624
        geo = F.launch_geometry(4096, 25, 25, 7, 132)
        assert (geo.envs_per_block, geo.shared_memory_bytes) == (32, 186368)
        assert F.resident_warps(geo) == 8


def test_require_core_dynamics_rejects_hooked_envs():
    class Hooked(MiniGridEnv):
        def _post_step(self, prev, state, action, reward, terminated):
            return state, reward, terminated

    require_core_dynamics(minigrid_tpu_torch.make("MiniGrid-Empty-5x5-v0",
                                                  device=CPU))
    with pytest.raises(NotImplementedError, match="_post_step"):
        require_core_dynamics(Hooked(minigrid_tpu_torch.EnvParams(),
                                     device=CPU))
