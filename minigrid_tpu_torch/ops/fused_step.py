"""Fused step + observation over T steps: the CUDA kernel and its plain
PyTorch version.

Counterpart of ``minigrid_tpu/ops/fused_step.py``, whose Pallas kernel it
replaces with ``csrc/fused_step.cu`` (a group of G lanes per env, the env's
packed grid in shared memory, scalars in registers across the T steps; the
launch geometry is :func:`launch_geometry`; the observe entry reads each
env's view window from device memory, its geometry is
:func:`observe_launch_geometry`). On the card
this is the transition of every env: those without step hooks
(:func:`require_core_dynamics`) step and take the pooled broadcast row in
one launch, and a hook env (``envs/base.py::has_step_hooks``) runs its
hooks in PyTorch around the step entry without a reset row. Its
observe-only entry, :func:`fused_observe`, observes states as given: the
resets that select a different state into each finished env (regenerated,
per-env pool rows, the fresh buffer, a hook env's broadcast row) step
without a reset row, select (in PyTorch; the fresh buffer's by its own
kernel on the card, ``ops/fresh_select.py``), then observe through it.

Routing is by the device of the tensors: CPU tensors take
:func:`fused_rollout_reference` (the port's ``step_core`` + ``gen_obs``),
CUDA tensors take the kernel or raise; nothing falls back.

The kernel is :data:`LIBRARY`, built, loaded, checked, called and counted
through ``ops/native.py``, the route of every hand-written kernel of the
port.
"""

from __future__ import annotations

import dataclasses

import torch

from minigrid_tpu_torch.core import grid as G
from minigrid_tpu_torch.core.obs import gen_obs
from minigrid_tpu_torch.core.step import step_core
from minigrid_tpu_torch.core.types import EnvParams, EnvState
from minigrid_tpu_torch.ops import native
from minigrid_tpu_torch.utils import trace

NSCAL = 8  # x, y, dir, carrying, step_count, terminated, truncated, pad
# odd view sizes the kernel takes: 32-bit view rows up to NARROW_VIEW,
# 64-bit ones (an instantiation family of their own) beyond, up to MAX_VIEW
MIN_VIEW, NARROW_VIEW, MAX_VIEW = 3, 31, 63
GROUP_LANES = (1, 2, 4, 8, 16, 32)  # lanes per env the kernel is built for
MAX_THREADS = 256  # threads per block (csrc/fused_step.cu kMaxThreads)
# G is raised until the batch gives every SM this many warps: one for each
# of its four schedulers. Lanes beyond that repeat an env's serial work (the
# transition, the flood) for nothing: on an H100 at B=4096, G=8 (7.8 warps
# per SM) ran 151.7 us per T=128 launch and G=16 (15.5) 231.2 us
# (port_probes/rollout_profile.py sweep, PERF.md).
MIN_WARPS_PER_SM = 4
# Where a block's shared memory leaves an SM room for few blocks, G is then
# widened (the same envs a block) until the blocks an SM holds at once have
# this many warps. On an H100 at B=4096, MultiRoom-N6's 25x25 at view 63
# (8 envs, 172 KB a block, one block an SM) ran a T=128 launch in 30.4 ms
# at G=8 (2 warps), 15.2 at G=16 and 10.0 at G=32; at B=65536 at view 7
# (32 envs, 182 KB) 12.6 ms at G=1 and 3.4 at G=8, whose 8 warps are also
# where the 8x8 grid's picks land (port_probes/rollout_profile.py
# --sweep-only, PERF.md).
RESIDENT_WARPS_PER_SM = 8
SMEM_LIMIT = 227 * 1024  # shared memory one block may opt into on sm_90
SMEM_PER_SM = 228 * 1024  # shared memory of an sm_90 SM, of which
SMEM_PER_BLOCK_RESERVED = 1024  # each resident block holds back 1 KB
MAX_WARPS_PER_SM, MAX_BLOCKS_PER_SM = 64, 32  # an sm_90 SM's other limits
# The observe entry takes at least the G that leaves a lane this many view
# cells of a row: each lane sweeps the rows in series, and its cells of a
# row set how long each row takes. On an H100 at B=4096, DoorKey-8x8 at view
# 33 ran 11.96 us at G=8 (5 cells), 9.36 at G=16 (3) and 10.71 at G=32 (2);
# MultiRoom-N6 at view 63 34.15 us at G=16 (4) and 29.20 at G=32 (2)
# (port_probes/rollout_profile.py --sweep-only, PERF.md).
OBSERVE_CELLS_PER_ROW = 3

SOURCE = native.CSRC / "fused_step.cu"
# (device pointers, ints) of each entry: csrc/fused_step.cu's k*Pointers
LIBRARY = native.Library(SOURCE, {"fused_step_launch": (19, 10),
                                  "fused_observe_launch": (5, 7)})


def require_core_dynamics(env) -> None:
    """Raise unless ``env`` uses the unmodified core transition: the guard
    of the kernel's direct entry with a broadcast reset row.

    The fused step implements only ``step_core``: an env that overrides
    ``step_state``/``_pre_step``/``_post_step``/``_transform_action``, or
    carries composed transition wrappers, would get wrong dynamics through
    it."""
    from minigrid_tpu_torch.envs.base import STEP_HOOKS, MiniGridEnv

    if env.transitions:
        names = ", ".join(type(w).__name__ for w in env.transitions)
        raise NotImplementedError(
            f"{type(env).__name__} carries transition wrappers ({names}); "
            "the fused step implements only the core transition")
    for name in ("step_state",) + STEP_HOOKS:
        if getattr(type(env), name) is not getattr(MiniGridEnv, name):
            raise NotImplementedError(
                f"{type(env).__name__} overrides {name}; the fused step "
                "implements only the core transition")


# --------------------------------------------------------------------------
# Reset rows: the kernel's broadcast-reset format. Row t is one reset state
# as its packed grid (W*H int32 cells, x-major) and NSCAL int32 scalars.
# --------------------------------------------------------------------------

def pack_rows(states: EnvState):
    """Batched EnvState (P, ...) -> (grid (P, W*H), scal (P, NSCAL)) int32."""
    P = states.batch_size
    grid = G.pack_cells(states.grid).reshape(P, -1)
    zero = torch.zeros_like(states.step_count)
    scal = torch.stack([
        states.agent_pos[:, 0], states.agent_pos[:, 1], states.agent_dir,
        G.pack_cells(states.carrying), states.step_count,
        states.terminated.to(torch.int32), states.truncated.to(torch.int32),
        zero], dim=-1)
    return grid.contiguous(), scal.to(torch.int32).contiguous()


def unpack_rows(grid: torch.Tensor, scal: torch.Tensor, width: int,
                height: int) -> dict:
    """Inverse of :func:`pack_rows` for the core fields."""
    return {
        "grid": G.unpack_cells(grid).reshape(-1, width, height, 5),
        "agent_pos": scal[:, 0:2].contiguous(),
        "agent_dir": scal[:, 2].contiguous(),
        "carrying": G.unpack_cells(scal[:, 3]),
        "step_count": scal[:, 4].contiguous(),
        "terminated": scal[:, 5] != 0,
        "truncated": scal[:, 6] != 0,
    }


def select_reset_row(params: EnvParams, st: EnvState, done: torch.Tensor,
                     grid_row: torch.Tensor, scal_row: torch.Tensor):
    """Core fields of the reset row selected into the envs where ``done``."""
    row = unpack_rows(grid_row[None], scal_row[None], params.width,
                      params.height)
    new = {}
    for k, v in row.items():
        cur = getattr(st, k)
        mask = done.reshape((-1,) + (1,) * (cur.ndim - 1))
        new[k] = torch.where(mask, v.to(cur.dtype), cur)
    return st.replace(**new)


# --------------------------------------------------------------------------
# Plain version
# --------------------------------------------------------------------------

def fused_rollout_reference(params: EnvParams, states: EnvState,
                            actions: torch.Tensor, native_layout: bool = False,
                            reset_grid: torch.Tensor | None = None,
                            reset_scal: torch.Tensor | None = None):
    """The fused step's function in plain PyTorch: T steps of ``step_core``
    (terminated is this step's flag), the optional broadcast reset row
    selected into finished envs, then ``gen_obs`` in packed mode.

    Same signature and outputs as :func:`fused_rollout`."""
    T, B = actions.shape
    V = params.view_size
    packed = dataclasses.replace(params, packed_obs=True)
    st = states
    obs, rew, term, trunc = [], [], [], []
    for t in range(T):
        st, r, te = step_core(params, st, actions[t])
        st = st.replace(terminated=te)
        tr = st.truncated
        if reset_grid is not None:
            st = select_reset_row(params, st, te | tr, reset_grid[t],
                                  reset_scal[t])
        obs.append(gen_obs(packed, st)["packed"])
        rew.append(r)
        term.append(te)
        trunc.append(tr)
    obs = torch.stack(obs)                                  # (T, B, V, V)
    if native_layout:
        obs = obs.reshape(T, B, V * V).permute(0, 2, 1).contiguous()
    return st, obs, torch.stack(rew), torch.stack(term), torch.stack(trunc)


# --------------------------------------------------------------------------
# The kernel
# --------------------------------------------------------------------------

def check_view_size(view_size: int) -> None:
    """Raise ``ValueError`` unless the kernel takes ``view_size``."""
    if not (MIN_VIEW <= view_size <= MAX_VIEW and view_size % 2 == 1):
        raise ValueError(f"the kernel takes odd view sizes {MIN_VIEW}.."
                         f"{MAX_VIEW}, got {view_size}")


# the step entry's shared memory beyond its words (csrc/fused_step.cu
# ``Layout``): the state copy's mbarriers (8 bytes for each of a block's at
# most 8 warps), and the staged run's slack of up to 15 bytes before it (its
# offset modulo 16) and one word after it
BARRIER_BYTES, RUN_SLACK = 8 * (MAX_THREADS // 32), 15 + 4


def shared_memory_bytes(num_cells: int, view_size: int,
                        envs_per_block: int) -> int:
    """Shared memory of one block (csrc/fused_step.cu ``Layout``): per env
    the packed cells (an odd word count) and the V*V observation words of
    a step; then, from a 16-byte boundary, the state copy's barriers and the
    block's run of grids as it lies in device memory, unpadded, with its
    slack, rounded up to 16 bytes."""
    words = envs_per_block * ((num_cells | 1) + view_size ** 2)
    run = envs_per_block * 5 * num_cells
    return ((words + 3) // 4 * 16 + BARRIER_BYTES
            + (run + RUN_SLACK + 15) // 16 * 16)


@dataclasses.dataclass(frozen=True)
class LaunchGeometry:
    group_lanes: int       # G lanes per env
    envs_per_block: int
    threads: int           # per block
    blocks: int
    shared_memory_bytes: int  # per block


def pick_group_lanes(batch: int, sm_count: int) -> int:
    """The smallest G that gives every SM ``MIN_WARPS_PER_SM`` warps at
    this batch (32 when even that does not)."""
    for g in GROUP_LANES:
        if batch * g >= MIN_WARPS_PER_SM * 32 * sm_count:
            return g
    return GROUP_LANES[-1]


def resident_warps(geo: "LaunchGeometry") -> int:
    """Warps of the blocks an SM holds at once, as its shared memory, its
    warp and its block limits allow (registers aside)."""
    blocks = min(SMEM_PER_SM // (geo.shared_memory_bytes
                                 + SMEM_PER_BLOCK_RESERVED),
                 MAX_BLOCKS_PER_SM, MAX_WARPS_PER_SM * 32 // geo.threads)
    return blocks * geo.threads // 32


def launch_geometry(batch: int, width: int, height: int, view_size: int,
                    sm_count: int, group_lanes: int | None = None
                    ) -> LaunchGeometry:
    """Launch geometry of the kernel: G lanes per env (``group_lanes``, or
    :func:`pick_group_lanes`), ``MAX_THREADS // G`` envs per block, halved
    while the block's shared memory exceeds the opt-in limit (a block keeps
    at least one full warp). When G is picked and even one warp of envs
    does not fit (a 25x25 grid at a view of 21 or more with G=1), the next
    wider G is taken; then G is widened while the blocks an SM holds at
    once have fewer than ``RESIDENT_WARPS_PER_SM`` warps (G=32 at a view of
    63 on 25x25). Raises ``ValueError`` for a view size, G or grid the
    kernel does not take."""
    check_view_size(view_size)
    if group_lanes is not None:
        return _geometry(batch, width, height, view_size, group_lanes)
    first = GROUP_LANES.index(pick_group_lanes(batch, sm_count))
    fits = [g for g in GROUP_LANES[first:]
            if shared_memory_bytes(width * height, view_size,
                                   max(1, 32 // g)) <= SMEM_LIMIT]
    geo = _geometry(batch, width, height, view_size,
                    fits[0] if fits else GROUP_LANES[-1])
    while (geo.group_lanes < GROUP_LANES[-1]
           and resident_warps(geo) < RESIDENT_WARPS_PER_SM):
        geo = _geometry(batch, width, height, view_size, 2 * geo.group_lanes)
    return geo


def _geometry(batch, width, height, view_size, g) -> LaunchGeometry:
    if g not in GROUP_LANES:
        raise ValueError(f"group_lanes must be one of {GROUP_LANES}, got {g}")
    nc = width * height
    envs, least = MAX_THREADS // g, max(1, 32 // g)
    while envs > least and shared_memory_bytes(nc, view_size,
                                               envs) > SMEM_LIMIT:
        envs //= 2
    smem = shared_memory_bytes(nc, view_size, envs)
    if smem > SMEM_LIMIT:
        raise ValueError(f"a {width}x{height} grid does not fit the kernel's "
                         f"shared memory ({smem} bytes for {envs} envs)")
    return LaunchGeometry(g, envs, envs * g, -(-batch // envs), smem)


def observe_shared_memory_bytes(view_size: int, envs_per_block: int) -> int:
    """Shared memory of one block of the observe entry
    (csrc/fused_step.cu ``observe_smem_bytes``): the V*V observation words
    of each env, whatever the grid."""
    return envs_per_block * view_size ** 2 * 4


def observe_launch_geometry(batch: int, view_size: int, sm_count: int,
                            group_lanes: int | None = None
                            ) -> LaunchGeometry:
    """Launch geometry of the observe entry, which stages no grid: G lanes
    per env (``group_lanes``, or the widest of :func:`pick_group_lanes` and
    the narrowest G that leaves a lane ``OBSERVE_CELLS_PER_ROW`` view cells
    of a row), and of the blocks from ``MAX_THREADS // G`` envs down to one
    warp whose view words fit the shared memory, the largest that lets an
    SM hold the most warps at once (:func:`resident_warps`). When G is
    picked, it is widened while one warp of envs does not fit or an SM
    holds fewer than ``RESIDENT_WARPS_PER_SM`` warps. At B=4096: G=8 at
    views up to 23, G=16 at 33, G=32 at 63 (2 envs a block). Raises
    ``ValueError`` for a view size the kernel does not take, or a G of
    which one warp of envs does not fit (G=1 from a view of 43, G=2 from
    61)."""
    check_view_size(view_size)
    if group_lanes is not None:
        return _observe_geometry(batch, view_size, group_lanes)
    narrowest = next(g for g in GROUP_LANES
                     if g * OBSERVE_CELLS_PER_ROW >= view_size)
    first = GROUP_LANES.index(max(pick_group_lanes(batch, sm_count),
                                  narrowest))
    fits = [g for g in GROUP_LANES[first:]
            if observe_shared_memory_bytes(view_size, max(1, 32 // g))
            <= SMEM_LIMIT]
    geo = _observe_geometry(batch, view_size, fits[0])
    while (geo.group_lanes < GROUP_LANES[-1]
           and resident_warps(geo) < RESIDENT_WARPS_PER_SM):
        geo = _observe_geometry(batch, view_size, 2 * geo.group_lanes)
    return geo


def _observe_geometry(batch, view_size, g) -> LaunchGeometry:
    if g not in GROUP_LANES:
        raise ValueError(f"group_lanes must be one of {GROUP_LANES}, got {g}")
    envs, least = MAX_THREADS // g, max(1, 32 // g)
    sizes = []
    while envs >= least:
        smem = observe_shared_memory_bytes(view_size, envs)
        if smem <= SMEM_LIMIT:
            sizes.append(LaunchGeometry(g, envs, envs * g, -(-batch // envs),
                                        smem))
        envs //= 2
    if not sizes:
        raise ValueError(f"one warp of G={g} envs at a view of {view_size} "
                         "does not fit the observe entry's shared memory")
    return max(sizes, key=lambda geo: (resident_warps(geo),
                                       geo.envs_per_block))


_SM_COUNTS: dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _SM_COUNTS:
        _SM_COUNTS[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SM_COUNTS[idx]


def _inputs(states: EnvState, actions, reset_grid, reset_scal) -> list:
    """The tensors the step entry reads, in its pointer table's order
    (csrc/fused_step.cu ``Args``); the observe entry reads the first four."""
    return [states.grid, states.agent_pos, states.agent_dir, states.carrying,
            states.step_count, actions, reset_grid, reset_scal]


def _specs(T: int, B: int, W: int, H: int) -> list:
    """(name, dtype, shape) of each of :func:`_inputs`."""
    i32, u8 = torch.int32, torch.uint8
    return [("grid", u8, (B, W, H, 5)), ("agent_pos", i32, (B, 2)),
            ("agent_dir", i32, (B,)), ("carrying", u8, (B, 5)),
            ("step_count", i32, (B,)), ("actions", i32, (T, B)),
            ("reset_grid", i32, (T, W * H)), ("reset_scal", i32, (T, NSCAL))]


def _fused_rollout_cuda(params, states, actions, native_layout, reset_grid,
                        reset_scal, group_lanes: int | None = None):
    W, H, V = params.width, params.height, params.view_size
    T, B = actions.shape
    check_view_size(V)
    inputs = _inputs(states, actions, reset_grid, reset_scal)
    native.check(inputs, _specs(T, B, W, H))
    dev = states.grid.device
    stream = native.stream(dev)
    geo = launch_geometry(B, W, H, V, sm_count(dev), group_lanes)
    obs = torch.empty((T, V * V, B) if native_layout else (T, B, V, V),
                      dtype=torch.int32, device=dev)
    reward = torch.empty((T, B), dtype=torch.float32, device=dev)
    term = torch.empty((T, B), dtype=torch.bool, device=dev)
    trunc = torch.empty((T, B), dtype=torch.bool, device=dev)
    out = states.replace(
        grid=torch.empty_like(states.grid),
        agent_pos=torch.empty_like(states.agent_pos),
        agent_dir=torch.empty_like(states.agent_dir),
        carrying=torch.empty_like(states.carrying),
        step_count=torch.empty_like(states.step_count),
        terminated=torch.empty((B,), dtype=torch.bool, device=dev),
        truncated=torch.empty((B,), dtype=torch.bool, device=dev),
    )
    LIBRARY.call("fused_step_launch", inputs + [
        obs, reward, term, trunc, out.grid, out.agent_pos, out.agent_dir,
        out.carrying, out.step_count, out.terminated, out.truncated],
        (B, T, W, H, V, params.max_steps, int(params.see_through_walls),
         int(native_layout), geo.group_lanes, geo.envs_per_block), stream)
    native.COUNTERS.launches += 1
    native.COUNTERS.wide_launches += V > NARROW_VIEW
    return out, obs, reward, term, trunc


def fused_observe_reference(params: EnvParams, states: EnvState):
    """The observe entry's function in plain PyTorch: ``gen_obs`` in
    packed mode. Returns (B, V, V) int32."""
    packed = dataclasses.replace(params, packed_obs=True)
    return gen_obs(packed, states)["packed"]


def _fused_observe_cuda(params, states, group_lanes: int | None = None):
    W, H, V = params.width, params.height, params.view_size
    B = states.batch_size
    inputs = _inputs(states, None, None, None)[:4]
    native.check(inputs, _specs(1, B, W, H))
    dev = states.grid.device
    stream = native.stream(dev)
    geo = observe_launch_geometry(B, V, sm_count(dev), group_lanes)
    obs = torch.empty((B, V, V), dtype=torch.int32, device=dev)
    LIBRARY.call("fused_observe_launch", inputs + [obs],
                 (B, W, H, V, int(params.see_through_walls), geo.group_lanes,
                  geo.envs_per_block), stream)
    native.COUNTERS.observe_launches += 1
    native.COUNTERS.wide_observe_launches += V > NARROW_VIEW
    return obs


@trace.spanned("env.kernel")
def fused_observe(params: EnvParams, states: EnvState) -> torch.Tensor:
    """The 9-bit packed view (B, V, V) int32, indexed [vx, vy], of each
    env's state as given: the observation half of the fused step, with no
    transition. CPU tensors run :func:`fused_observe_reference`, CUDA
    tensors the kernel's observe entry."""
    dev = states.grid.device.type
    if dev == "cpu":
        return fused_observe_reference(params, states)
    if dev != "cuda":
        raise ValueError(f"fused_observe runs on cpu or cuda, got {dev}")
    return _fused_observe_cuda(params, states)


@trace.spanned("env.kernel")
def fused_rollout(params: EnvParams, states: EnvState, actions: torch.Tensor,
                  native_layout: bool = False,
                  reset_grid: torch.Tensor | None = None,
                  reset_scal: torch.Tensor | None = None):
    """Run T = actions.shape[0] core-dynamics steps for B batched envs.

    ``states``: batched EnvState; only the core fields are stepped
    (mission and rng pass through untouched). ``actions``: (T, B)
    int32. With ``reset_grid`` (T, W*H) / ``reset_scal`` (T, NSCAL) int32
    (see :func:`pack_rows`), envs finishing step t take reset row t before
    that step's observation. Returns ``(new_states, obs, reward, terminated,
    truncated)``: obs is the 9-bit packed view, (T, B, V, V) int32 indexed
    [vx, vy], or the kernel-native (T, V*V, B) with ``native_layout``;
    reward (T, B) float32; terminated/truncated (T, B) bool, the flags of
    each step before any reset.

    CPU tensors run :func:`fused_rollout_reference`; CUDA tensors run the
    kernel. It computes the core transition only: a reset row needs an env
    that passes :func:`require_core_dynamics`, and a hook env's steps go
    through ``envs/base.py::hooked_step``.
    """
    if (reset_grid is None) != (reset_scal is None):
        raise ValueError("reset_grid and reset_scal go together")
    dev = states.grid.device.type
    if dev == "cpu":
        return fused_rollout_reference(params, states, actions,
                                       native_layout, reset_grid, reset_scal)
    if dev != "cuda":
        raise ValueError(f"fused_rollout runs on cpu or cuda, got {dev}")
    return _fused_rollout_cuda(params, states, actions, native_layout,
                               reset_grid, reset_scal)
