#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``minigrid_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. the card (name, power limit) and the kernel build (ptxas report);
2. the fused step kernel against its plain PyTorch version on the card,
   bit-exact on every output, for every case below (another view size and
   every group width G among them); then its observe entry against plain
   ``gen_obs`` on states taken after interaction steps, bit-exact; then
   both entries on states of each of the 14 other families (B=1024, T=32,
   the interaction stream; MultiRoom's 25x25, RedBlueDoors' 16x8 and the
   see-through families among them), the step entry with and without a
   reset row; then both entries on states of Unlock, KeyCorridorS6R3,
   ObstructedMaze-Full (16x16), BabyAI-GoToObj and BabyAI-BossLevel (22x22)
   with the uniform and the interaction streams, the step entry without a
   row (their hook path); then the 64-bit view rows: both entries at views
   33 and 63 on DoorKey-8x8 and MultiRoom-N6 (25x25), B=1024, at every
   group width that fits;
3. the main path through the public entry points: DoorKey-8x8 with packed
   observations, a 1024-entry layout pool, 4096 staggered envs, the bf16
   ActorCritic and one 128-step pooled rollout, with the kernel's launch
   count read before and after; then a small rollout replayed through the
   plain path on the CPU, and the regen, independent-pool and fresh-buffer
   resets stepped on the card and replayed on the CPU with the same
   actions and candidate states; then each of the 7 hook families', the 5
   RoomGrid families' and 5 BabyAI levels' ``step`` and pooled auto-reset
   (the hook path around the kernel; BabyAI's verifier is a step hook)
   stepped on the card and replayed on the CPU, bit-exact, ``extra``
   included, and one level again with done actions; then frames
   (``render.get_frame``: full with and without the view cone, and POV,
   at tile 8 and 32) of DoorKey-8x8 B=4096 and BabyAI-BossLevel B=1024
   states on the card against the CPU, and 18 wrapper stacks (the 15
   wrappers, two transition wrappers stacked, an observation and a
   stateful wrapper over NoDeath) stepped 32 times at B=256 with pooled
   resets (ReseedWrapper: its own) on the card and replayed on the CPU,
   bit-exact (NaN-equal), with their launches a step;
3c. the BabyAI bot on the card: 8 levels of JAX tests/test_bot.py's cut,
   8 seeds each as one batch, solved within 240 steps, each batch replayed
   on the CPU from the same initial states (the bots' actions and every
   state tensor bit-exact), with the steps and seconds per level;
4. the PPO train step at full width (B=4096, T=128, bf16 hidden=256,
   PPOConfig defaults) in each reset mode: pooled, fresh, regen, one
   warm-up step then three timed ones, with both entries' launch counts
   set to 0 before and read after; then the same (one timed step for the
   first three) for MultiRoom-N6 (25x25)
   pooled, Dynamic-Obstacles-16x16 pooled through the hook path,
   Fetch-8x8-N3 fresh, BabyAI-GoToObj and BabyAI-PutNextLocal fresh (the
   verifier in the loop; staggered and buffered from the episode budgets as
   the JAX bench does) and KeyCorridorS6R3 pooled, with the device kernels
   per rollout step (profile) and the reset overflow;
   and ActionBonus(DoorKey-8x8) pooled, its visit counts growing by B x T
   a train step; then the recurrent train step (DoorKey-8x8 fresh,
   ActorCriticRNN(hidden=256) bf16, truncated BPTT over the rotate
   slabs); then one rotate epoch of the f32 update, MLP and recurrent, on
   the card against the same epoch on the CPU;
5. timings: the rollout, pure packed stepping, and the kernel's device
   time per launch (profiler) at T=1 and T=128 for B=4096 and at T=128 for
   B=65536, with the group width G chosen for each, and the observe
   entry's at B=4096, beside their bounds (the larger of the byte and the
   integer-operation bound) and the plain versions' times (CUDA events);
   the same at B=4096 on MultiRoom-N6 (25x25), RedBlueDoors-8x8 (16x8),
   Fetch-8x8-N3 (see-through walls), BabyAI-BossLevel (22x22) and
   ObstructedMaze-Full (16x16), with each launch geometry; generation of a
   B=4096 batch of BossLevel and KeyCorridorS6R3 on the card (seconds, host
   syncs, attempts, levels left invalid); frames of DoorKey-8x8 B=4096 at
   tile 8 and 32 (device time of a call beside its byte bound); pooled
   stepping at B=4096, T=128 of bare DoorKey-8x8, ImgObs(DoorKey-8x8) and
   NoDeath(LavaCrossingS9N2) (env-steps/s, launches and device kernels a
   step), and of the 64-bit rows' paths (DoorKey-8x8 at view 33, a
   ViewSizeWrapper of 63), whose kernel times at DoorKey-8x8 view 33 and
   MultiRoom-N6 view 63 are taken beside the other shapes;
   WaveFunctionCollapse (3d): the solver on the card against the CPU
   from the same keys (5 configurations at 23x23, B=64; ``propagate`` and
   ``largest_component``), a 1024-layout pool of each of the 6 IDs made
   on the card and held to its invariants, and 32 pooled steps of
   WFC-MazeSimple replayed on the CPU; phase 2 runs both entries on
   WFC-MazeSimple and WFC-ObstaclesAngular states, phase 4 the
   WFC-MazeSimple pooled train step, phase 5 its 25x25 kernel times,
   generation at B=4096 of three IDs, the support product in bf16 and
   f32, and ``benchmark`` on WFC-MazeSimple;
6. learning on the card: the JAX package's guards (Empty-5x5 regen,
   pooled+packed and fresh, 30 updates; DoorKey-5x5, 120 updates at
   B=256), then the greedy success rate of the DoorKey-5x5 policy; then
   the two wrapped guards: ImgObs(Empty-5x5) with a policy over the packed
   array and NoDeath(LavaGapS5), pooled, 30 updates; the recurrent guard
   (Empty-5x5 fresh, ActorCriticRNN(hidden=64), 30 updates); the imitation
   pipeline: 300 bot demos of GoToRedBallGrey generated on the card,
   behaviour cloning (accuracy > 0.9) and the greedy success rate (> 0.5)
   with the eval's cap derived from the episodes' budgets.

The line before the last is the card as ``nvidia-smi`` reports it; the last
line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or outside
the repository, it exits non-zero before printing any result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time

ENV_ID = "MiniGrid-DoorKey-8x8-v0"
BATCH = 4096
POOL_SIZE = 1024
ROLLOUT_LEN = 128
SEED = 0
# one ID of each family beyond DoorKey and Empty: the core-dynamics
# families, then the hook families
CORE_FAMILIES = ["MiniGrid-FourRooms-v0", "MiniGrid-LavaGapS7-v0",
                 "MiniGrid-DistShift1-v0", "MiniGrid-LavaCrossingS11N5-v0",
                 "MiniGrid-LockedRoom-v0", "MiniGrid-Playground-v0",
                 "MiniGrid-MultiRoom-N6-v0"]
HOOK_FAMILIES = ["MiniGrid-MemoryS13Random-v0", "MiniGrid-RedBlueDoors-8x8-v0",
                 "MiniGrid-GoToObject-8x8-N2-v0", "MiniGrid-Fetch-8x8-N3-v0",
                 "MiniGrid-GoToDoor-8x8-v0", "MiniGrid-PutNear-8x8-N3-v0",
                 "MiniGrid-Dynamic-Obstacles-16x16-v0"]
# the RoomGrid families and BabyAI levels: both kernel entries on their
# states (BossLevel's 3x3 maze of 8-rooms is 22x22, ObstructedMaze-Full
# 16x16), and the hook steps card vs CPU, covering the four leaf kinds
# (goto, open, pickup, putnext) and the four root kinds (action, and,
# before, after); the last one again with done actions
ROOMGRID_KERNEL = ["MiniGrid-Unlock-v0", "MiniGrid-KeyCorridorS6R3-v0",
                   "MiniGrid-ObstructedMaze-Full-v0", "BabyAI-GoToObj-v0",
                   "BabyAI-BossLevel-v0"]
ROOMGRID_HOOKS = ["MiniGrid-Unlock-v0", "MiniGrid-UnlockPickup-v0",
                  "MiniGrid-BlockedUnlockPickup-v0",
                  "MiniGrid-KeyCorridorS3R3-v0",
                  "MiniGrid-ObstructedMaze-2Dlh-v0", "BabyAI-GoToObj-v0",
                  "BabyAI-OpenDoorsOrderN4-v0", "BabyAI-GoToSeq-v0",
                  "BabyAI-SynthSeq-v0", "BabyAI-PutNextLocal-v0"]
# the train steps of other families: (env id, reset mode, fresh buffer
# rows, "budget" or None for the default sizing). A random policy ends a
# Fetch episode at its first pickup, ~4x sooner than the max_steps the
# default sizing assumes: its ~2350 rows left ~2600 resets a train step
# degraded (reset overflow), so Fetch takes a buffer sized for ~8000 resets
# a rollout. "budget": the JAX bench's sizing for a dynamic-budget BabyAI
# level, int(B * T / ms * 1.3) + 256 with ms the largest episode budget of
# the batch (bench.py:281-283, 300)
FAMILY_TRAIN = [("MiniGrid-MultiRoom-N6-v0", "pooled", None),
                ("MiniGrid-Dynamic-Obstacles-16x16-v0", "pooled", None),
                ("MiniGrid-Fetch-8x8-N3-v0", "fresh", 12288),
                ("BabyAI-GoToObj-v0", "fresh", "budget"),
                ("BabyAI-PutNextLocal-v0", "fresh", "budget"),
                ("MiniGrid-KeyCorridorS6R3-v0", "pooled", None),
                ("MiniGrid-WFC-MazeSimple-v0", "pooled", None)]
# the earlier families' train steps are timed once, not three times, to
# hold the script's wall time as the configurations grow
ONE_TIMED_STEP = {"MiniGrid-MultiRoom-N6-v0",
                  "MiniGrid-Dynamic-Obstacles-16x16-v0",
                  "MiniGrid-Fetch-8x8-N3-v0", "MiniGrid-WFC-MazeSimple-v0"}
# the kernel's shapes timed beside DoorKey-8x8's: (name, env id, whether the
# T=1 launch carries a reset row). The BabyAI and RoomGrid steps take the
# step entry without a row (the hook path)
SHAPES = [("MultiRoom-N6 25x25", "MiniGrid-MultiRoom-N6-v0", True),
          ("RedBlueDoors-8x8 16x8", "MiniGrid-RedBlueDoors-8x8-v0", True),
          ("Fetch-8x8-N3 see-through", "MiniGrid-Fetch-8x8-N3-v0", True),
          ("BossLevel 22x22", "BabyAI-BossLevel-v0", False),
          ("ObstructedMaze-Full 16x16", "MiniGrid-ObstructedMaze-Full-v0",
           False),
          ("WFC-MazeSimple 25x25", "MiniGrid-WFC-MazeSimple-v0", True)]
# generation on the card at full width: seconds per batch, host syncs, the
# most attempts (levels) or connect_all draws any env used, levels not valid
GENERATION = ["BabyAI-BossLevel-v0", "MiniGrid-KeyCorridorS6R3-v0"]
# the frames rendered: full with the view cone, full without, POV
RENDER_VARIANTS = {"full": {}, "no highlight": {"highlight": False},
                   "pov": {"agent_pov": True}}
LAVA_ID = "MiniGrid-LavaCrossingS9N2-v0"  # JAX bench.py:411's NoDeath env
# views wider than 31 take the kernel's 64-bit view rows; their timed
# shapes: (name, env id, view size)
WIDE_VIEWS = (33, 63)
WIDE_SHAPES = [("DoorKey-8x8 view 33", ENV_ID, 33),
               ("MultiRoom-N6 25x25 view 63", "MiniGrid-MultiRoom-N6-v0", 63)]
# the bot on the card: a cut of JAX tests/test_bot.py's FAST_LEVELS, each
# solved within the reference's 240 steps in at most 8 seeds
BOT_LEVELS = ["BabyAI-GoToRedBallGrey-v0", "BabyAI-GoToLocal-v0",
              "BabyAI-OpenDoorsOrderN4-v0", "BabyAI-PutNextLocal-v0",
              "BabyAI-UnlockLocal-v0", "BabyAI-BlockedUnlockPickup-v0",
              "BabyAI-KeyCorridorS3R3-v0", "BabyAI-MoveTwoAcrossS8N9-v0"]
BOT_SEEDS = 8
BOT_STEPS = 240
# WaveFunctionCollapse: both kernel entries on the states of the smallest
# and the largest catalog (P=12 and P=42) of the 6 IDs at 25x25; the solver
# card against CPU from the same keys (the noise-free location heuristics
# with the lexical choice, backtracking with allpatterns, and backtracking
# with the defaults' hash draws); a pool of each ID checked by invariants;
# the pooled train step; generation at full width of the most collapses
# (MazeSimple), the most passes (DungeonMazeScaled) and the largest catalog
# (ObstaclesAngular)
WFC_IDS = [f"MiniGrid-WFC-{name}-v0" for name in (
    "MazeSimple", "DungeonMazeScaled", "RoomsFabric", "ObstaclesBlackdots",
    "ObstaclesAngular", "ObstaclesHogs3")]
WFC_KERNEL = ["MiniGrid-WFC-MazeSimple-v0",
              "MiniGrid-WFC-ObstaclesAngular-v0"]
WFC_SOLVES = [("MazeSimple", {"loc_heuristic": "simple",
                              "choice_heuristic": "lexical"}),
              ("MazeSimple", {"loc_heuristic": "spiral",
                              "choice_heuristic": "lexical"}),
              ("DungeonMazeScaled", {"loc_heuristic": "lexical",
                                     "choice_heuristic": "lexical"}),
              ("MazeSimple", {"loc_heuristic": "lexical",
                              "choice_heuristic": "lexical",
                              "backtracking": True,
                              "global_constraint": "allpatterns"}),
              ("ObstaclesBlackdots", {"backtracking": True})]
WFC_GENERATION = ["MiniGrid-WFC-MazeSimple-v0",
                  "MiniGrid-WFC-DungeonMazeScaled-v0",
                  "MiniGrid-WFC-ObstaclesAngular-v0"]
WFC_POOL = 1024
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
# INT32 issue rate of an H100 SXM: 64 INT32 lanes per SM (Hopper
# architecture white paper) x 132 SMs x the 1.98 GHz boost clock that the
# data sheet's 67 TFLOP/s of fp32 implies (67e12 / (132 SMs * 128 lanes * 2))
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def wrapper_cases() -> dict:
    """The wrapper replays: name -> (env id, packed, the stack over an env,
    the (step, observe) launches a step). A stateless observation stack
    over a core env takes the step entry with the pooled row; a transition
    or stateful one the step entry without a row and the observe entry
    after the select; rendering and ViewSize add an observe launch; the
    ReseedWrapper's exact reset observes its layouts."""
    from minigrid_tpu_torch import wrappers as W

    def nodeath(e):
        return W.NoDeath(e, no_death_types=("lava",))

    dk = ENV_ID
    return {
        "ImgObs": (dk, True, W.ImgObsWrapper, (1, 0)),
        "OneHotPartialObs": (dk, False, W.OneHotPartialObsWrapper, (1, 0)),
        "RGBImgObs": (dk, True, W.RGBImgObsWrapper, (1, 1)),
        "RGBImgPartialObs": (dk, True, W.RGBImgPartialObsWrapper, (1, 1)),
        "FullyObs": (dk, True, W.FullyObsWrapper, (1, 0)),
        "DictObservationSpace": (dk, True, W.DictObservationSpaceWrapper,
                                 (1, 0)),
        "FlatObs": (dk, False, W.FlatObsWrapper, (1, 0)),
        "ViewSize 9": (dk, False, lambda e: W.ViewSizeWrapper(e, 9), (1, 1)),
        "SymbolicObs": (dk, True, W.SymbolicObsWrapper, (1, 0)),
        "DirectionObs": (dk, True, W.DirectionObsWrapper, (1, 1)),
        "ActionBonus": (dk, True, W.ActionBonus, (1, 1)),
        "PositionBonus": (dk, True, W.PositionBonus, (1, 1)),
        "StochasticAction": (dk, True, W.StochasticActionWrapper, (1, 1)),
        "ReseedWrapper": (dk, True, lambda e: W.ReseedWrapper(
            e, seeds=(0, 1, 2, 3, 4)), (1, 1)),
        "NoDeath": (LAVA_ID, True, nodeath, (1, 1)),
        "NoDeath(StochasticAction)": (LAVA_ID, True, lambda e: nodeath(
            W.StochasticActionWrapper(e)), (1, 1)),
        "ImgObs(NoDeath)": (LAVA_ID, True, lambda e: W.ImgObsWrapper(
            nodeath(e)), (1, 1)),
        "ActionBonus(NoDeath)": (LAVA_ID, True, lambda e: W.ActionBonus(
            nodeath(e)), (1, 1)),
    }


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` on the card, by CUDA events,
    after one warm-up call."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, reps: int, kernel: str = "fused_step_kernel") -> float:
    """Mean device time of one launch of ``kernel`` over ``reps`` calls of
    ``fn``, from the profiler's CUDA activity (CUPTI): the kernel's own time,
    whatever the host spends around the launches. The profiler now and then
    drops launch records (one in 20 on an H100; once 11 of 20 in a session
    after others), so a session missing more than a tenth of them is
    profiled again, three times at most."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and kernel in e.name]
        if reps - max(1, reps // 10) <= len(us) <= reps:
            return sum(us) / len(us) / 1e3
        print(f"  profiled {len(us)} launches of {kernel} of {reps}; again")
    raise AssertionError(f"profiled {len(us)} launches of {kernel}, "
                         f"expected {reps}")


def device_ms_all(fn, reps: int):
    """(mean device time in ms of everything one call of ``fn`` runs on the
    card, device kernels and copies a call), from the profiler's CUDA
    activity after one warm-up call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    if not ev:
        raise AssertionError("the profiler recorded no device activity")
    us = sum(e.time_range.elapsed_us() for e in ev)
    return us / reps / 1e3, len(ev) / reps


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def launch_bytes(states, actions, outputs, reset_grid=None,
                 reset_scal=None) -> int:
    """Bytes the fused step must move: every input read once, every output
    written once (mission/rng are not touched by the kernel)."""
    new_states, obs, reward, term, trunc = outputs
    core = ("grid", "agent_pos", "agent_dir", "carrying", "step_count")
    moved = nbytes(*(getattr(states, k) for k in core), actions, obs, reward,
                   term, trunc)
    moved += nbytes(*(getattr(new_states, k) for k in core),
                    new_states.terminated, new_states.truncated)
    if reset_grid is not None:
        moved += nbytes(reset_grid, reset_scal)
    return moved


def step_ops(view_size: int) -> int:
    """Integer operations one env-step needs at least: a read and a
    transparency test per window cell, two operations per Kogge-Stone step
    (V rows, two sweeps of ceil(log2 V) steps), ~30 for the transition."""
    V = view_size
    return 2 * V * V + V * 2 * math.ceil(math.log2(V)) * 2 + 30


def bound_ms(nbytes_moved: int, env_steps: int, view_size: int):
    """(least time in ms, "bytes" or "operations"): the larger of the bytes
    over the HBM rate and the operations over the INT32 rate."""
    by_bytes = nbytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = env_steps * step_ops(view_size) / INT32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def observe_bytes(states, obs) -> int:
    """Bytes the observe entry must move: the state it reads (grid,
    position, direction, carried cell) and the observations it writes."""
    return nbytes(states.grid, states.agent_pos, states.agent_dir,
                  states.carrying, obs)


def observe_bound_ms(states, obs, view_size: int):
    """The observe entry's bound: bytes, or the window read, tests and
    flood of ``step_ops`` without the transition."""
    by_bytes = observe_bytes(states, obs) / HBM_BYTES_PER_S * 1e3
    by_ops = (states.batch_size * (step_ops(view_size) - 30)
              / INT32_OPS_PER_S * 1e3)
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def short(env_id: str) -> str:
    """The ID without "MiniGrid-" and the version ("BabyAI-" is kept)."""
    if env_id.startswith("MiniGrid-"):
        env_id = env_id[len("MiniGrid-"):]
    return env_id.rsplit("-", 1)[0]


def cuda_events(fn):
    """(kernels, copies and sets) the card ran during ``fn()``, counted
    from the profiler's CUDA activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    copies = sum(n.startswith(("Memcpy", "Memset")) for n in names)
    return len(names) - copies, copies


def stagger_budget(env, st, g, fresh_buffer):
    """``(st, fresh_buffer)``: a BabyAI level's batch staggered uniformly
    below the largest episode budget of the batch (``reset_staggered``
    draws below the 2^30 sentinel), and where ``fresh_buffer`` is "budget"
    the JAX bench's buffer rows for it, ``int(B * T / ms * 1.3) + 256``
    (bench.py:281-284, 300); other envs and sizes pass through."""
    import torch

    if st.extra is None or "max_steps" not in st.extra:
        return st, fresh_buffer
    ms = int(st.extra["max_steps"].max())
    B = st.batch_size
    st = st.replace(step_count=torch.randint(
        0, ms, (B,), generator=g, device=st.device, dtype=torch.int32))
    if fresh_buffer == "budget":
        fresh_buffer = int(B * ROLLOUT_LEN / ms * 1.3) + 256
    return st, fresh_buffer


def clone_generator(g):
    """A generator in the same state as ``g``: it replays ``g``'s next
    draws."""
    import torch

    return torch.Generator(device=g.device).set_state(g.get_state())


def zero_counts():
    """Set every kernel launch count to 0: done just before a path is
    driven, whose counts are read just after."""
    from minigrid_tpu_torch.ops.fused_step import KERNEL

    KERNEL.launches = KERNEL.observe_launches = 0
    KERNEL.wide_launches = KERNEL.wide_observe_launches = 0


def assert_same(name, got, want):
    """Exact equality of two tensors, or of two dicts/states of them,
    across devices (NaN equals NaN)."""
    import torch

    if hasattr(got, "tensors"):
        got, want = got.tensors(), want.tensors()
    if isinstance(got, dict):
        for k in want:
            assert_same(f"{name} {k}", got[k], want[k])
        return
    got, want = got.cpu(), want.cpu()
    same = torch.equal(got, want) or (
        got.is_floating_point() and got.shape == want.shape
        and got.dtype == want.dtype
        and bool(((got == want) | (got.isnan() & want.isnan())).all()))
    if not same:
        raise AssertionError(f"{name} differs between the card and the "
                             f"CPU replay")


def compare(name, got, want) -> float:
    """Bit-exact comparison of the kernel's outputs with the plain
    version's; returns the largest absolute difference (0 when equal)."""
    import torch

    gs, *gt = got
    ws, *wt = want
    pairs = [(k, getattr(gs, k), getattr(ws, k))
             for k in ("grid", "agent_pos", "agent_dir", "carrying",
                       "step_count", "terminated", "truncated")]
    pairs += list(zip(("obs", "reward", "terminated_t", "truncated_t"),
                      gt, wt))
    err = 0.0
    for k, a, b in pairs:
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{name}: {k} {a.shape}/{a.dtype} vs "
                                 f"{b.shape}/{b.dtype}")
        diff = (a.double() - b.double()).abs().max().item()
        err = max(err, diff)
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: {k} differs from the plain "
                                 f"version (max abs {diff})")
    print(f"kernel == plain: {name} (max_abs_err {err})")
    return err


def wfc_catalog(preset: str, device):
    """(adj, weights, output_periodic) of a WFC preset's catalog."""
    from minigrid_tpu_torch.envs.wfc import WFCEnv

    env = WFCEnv(wfc_config=preset, device=device)
    return env._adj, env._weights, env.config.output_periodic


def wfc_solver_replays(device, B=64, shape=(23, 23)):
    """The WFC solver on ``device`` and on the CPU from the same keys:
    grids and ``ok`` of each :data:`WFC_SOLVES` configuration, ``propagate``
    on seeded random waves (periodic and not) and ``largest_component`` on
    random masks, bit-exact. Returns what each solve gave."""
    import numpy as np
    import torch

    from minigrid_tpu_torch.envs.base import random_keys
    from minigrid_tpu_torch.envs.wfc import solver as S
    from minigrid_tpu_torch.envs.wfc import wfcenv as W

    g = torch.Generator(device=device).manual_seed(SEED + 20)
    out = {}
    for preset, kw in WFC_SOLVES:
        adj, w, periodic = wfc_catalog(preset, device)
        keys = random_keys(g, (B, 2), device)
        grid, ok = S.solve(keys, adj, w, shape, periodic, **kw)
        grid_c, ok_c = S.solve(keys.cpu(), adj, w, shape, periodic, **kw)
        name = f"WFC {preset} {kw or 'defaults'}"
        assert_same(f"{name} grid", grid, grid_c)
        assert_same(f"{name} ok", ok, ok_c)
        out[f"{preset} {json.dumps(kw)}"] = int(ok.sum())
        print(f"{name} B={B} {shape[0]}x{shape[1]}: {int(ok.sum())} of {B} "
              f"solved; the card == the CPU")
    rng = np.random.default_rng(SEED)
    for preset in ("MazeSimple", "DungeonMazeScaled"):
        adj, _, periodic = wfc_catalog(preset, device)
        waves = rng.random((B, adj.shape[1]) + shape) < rng.choice(
            [0.4, 0.7, 0.95], (B, 1, 1, 1))
        waves = torch.from_numpy(waves)
        got = S.propagate(waves.to(device), adj, periodic)
        want = S.propagate(waves, adj, periodic)
        assert_same(f"WFC propagate {preset} wave", got[0], want[0])
        assert_same(f"WFC propagate {preset} contradiction", got[1], want[1])
        print(f"WFC propagate {preset} (periodic={periodic}) B={B}: "
              f"{int(want[1].sum())} contradictions; the card == the CPU")
    masks = torch.from_numpy(rng.random((1024,) + shape) < rng.choice(
        [0.3, 0.55, 0.8], (1024, 1, 1)))
    assert_same("WFC largest_component",
                W.largest_component(masks.to(device)),
                W.largest_component(masks))
    print("WFC largest_component B=1024: the card == the CPU")
    return out


def wfc_reachable(grid, agent_pos):
    """(B,) bool: each env's goal reachable from its agent through
    non-wall cells (a 4-neighbour flood on the device, tested for its
    fixpoint every 32 passes)."""
    import torch

    from minigrid_tpu_torch.core import constants as C

    B, Wd, Hd = grid.shape[:3]
    passable = grid[..., 0] != C.WALL
    b = torch.arange(B, device=grid.device)
    reach = torch.zeros((B, Wd, Hd), dtype=torch.bool, device=grid.device)
    reach[b, agent_pos[:, 0].long(), agent_pos[:, 1].long()] = True
    while True:
        before = reach
        for _ in range(32):
            grown = reach.clone()
            grown[:, 1:] |= reach[:, :-1]
            grown[:, :-1] |= reach[:, 1:]
            grown[:, :, 1:] |= reach[:, :, :-1]
            grown[:, :, :-1] |= reach[:, :, 1:]
            reach = grown & passable
        if torch.equal(reach, before):
            break
    return (reach & (grid[..., 0] == C.GOAL)).flatten(1).any(1)


def wfc_pool(env_id, device, B=WFC_POOL):
    """A pool's worth of layouts of a WFC ID made on ``device`` (the solve
    with retries, then the layout) and held to its invariants: the wall
    ring, one goal, the agent on an empty cell (so apart from the goal), the
    goal reachable, the walls those of the pattern grid, every pair of
    neighbouring pattern cells allowed by ``adj`` where the env solved.
    Returns the generation's seconds and counters."""
    import torch

    import minigrid_tpu_torch as mt
    from minigrid_tpu_torch.core import constants as C
    from minigrid_tpu_torch.envs.base import pool_from_states
    from minigrid_tpu_torch.envs.wfc import solver as S

    env = mt.make(env_id, device=device).packed()
    g = env.generator(SEED + 21)
    if device != "cpu":
        torch.cuda.synchronize()
    S.COUNTERS.reset()
    t0 = time.perf_counter()
    pat, ok, attempts = env.solve(g, B)
    st = env.layout(g, pat)
    pool = pool_from_states(st)
    if device != "cpu":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    c = dataclasses.asdict(S.COUNTERS)
    grid = st.grid
    t = grid[..., 0]
    bi = torch.arange(B, device=grid.device)
    wall = t == C.WALL
    checks = {
        "wall ring": bool(wall[:, 0].all() & wall[:, -1].all()
                          & wall[:, :, 0].all() & wall[:, :, -1].all()),
        "one goal": bool(((t == C.GOAL).flatten(1).sum(1) == 1).all()),
        "agent on an empty cell": bool((t[bi, st.agent_pos[:, 0].long(),
                                          st.agent_pos[:, 1].long()]
                                        == C.EMPTY).all()),
        "goal reachable": bool(wfc_reachable(grid, st.agent_pos).all()),
    }
    is_wall = torch.as_tensor(env._is_wall, device=grid.device)[pat]
    inner = wall[:, 1:-1, 1:-1].transpose(1, 2)           # [row, col]
    checks["walls of the pattern grid"] = bool((inner | ~is_wall).all())
    adj = torch.as_tensor(env._adj, device=grid.device)
    right = adj[3][pat[:, :, :-1], pat[:, :, 1:]].flatten(1).all(1)
    down = adj[1][pat[:, :-1, :], pat[:, 1:, :]].flatten(1).all(1)
    checks["neighbours allowed where solved"] = bool(
        ((right & down) | ~ok).all())
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"{env_id} pool: {failed} do not hold")
    if pool.size != B:
        raise AssertionError(f"{env_id}: pool of {pool.size} rows")
    res = {"s": secs, "not_ok": int((~ok).sum()),
           "attempts_max": int(attempts.max()), "counters": c}
    print(f"WFC pool, {short(env_id)} B={B}: {secs:.3f} s, "
          f"{res['not_ok']} not ok, attempts at most {res['attempts_max']}, "
          f"{c['host_syncs']} counted host syncs, collapses at most "
          f"{c['collapses_max']}, passes at most {c['passes_max']}; "
          f"invariants hold")
    return res


def wfc_replay_steps(env_id, device, B=256, T=32):
    """``T`` pooled auto-reset steps of a WFC ID on ``device`` (the step
    entry with the broadcast row), replayed on the CPU with the same keys,
    actions and rows: every output bit-exact. Returns (episodes ended,
    (step, observe) launches of the card's steps)."""
    import torch

    import minigrid_tpu_torch as mt
    from minigrid_tpu_torch.envs.base import (presample_reset_states,
                                              random_keys)
    from minigrid_tpu_torch.ops.fused_step import KERNEL

    env = mt.make(env_id, device=device).packed()
    cpu_env = mt.make(env_id, device="cpu").packed()
    g = env.generator(SEED + 22)
    _, st = env.reset(g, B)
    ms = env.params.max_steps
    st = st.replace(step_count=(ms - 1 - torch.arange(
        B, device=device) % (2 * T)).to(torch.int32))
    st_c = st.map(lambda x: x.cpu())
    rows = presample_reset_states(g, env.make_pool(g, 64), T)
    n_done = 0
    zero_counts()
    for t in range(T):
        keys = random_keys(g, (B, 2), device)
        a = torch.randint(0, 7, (B,), generator=g, device=device,
                          dtype=torch.int32)
        out = env.step_autoreset_presampled(keys, st, a, rows.rows(t))
        ref = cpu_env.step_autoreset_presampled(keys.cpu(), st_c, a.cpu(),
                                                rows.rows(t).to("cpu"))
        for part, x, y in zip(("obs", "state", "reward", "terminated",
                               "truncated"), out[:5], ref[:5]):
            assert_same(f"{short(env_id)} pooled step {t} {part}", x, y)
        st, st_c = out[1], ref[1]
        n_done += int((out[3] | out[4]).sum())
    return n_done, (KERNEL.launches, KERNEL.observe_launches)


def wfc_generation(env_id, device, B=BATCH):
    """One timed generation of ``B`` layouts of a WFC ID (after a warm-up
    batch of 64): seconds, counted host syncs, the most collapses, passes
    and attempts any env used, envs not ok."""
    import torch

    import minigrid_tpu_torch as mt
    from minigrid_tpu_torch.core import constants as C
    from minigrid_tpu_torch.envs.wfc import solver as S

    env = mt.make(env_id, device=device).packed()
    g = env.generator(SEED + 23)
    env._gen_grid(g, 64)
    torch.cuda.synchronize()
    S.COUNTERS.reset()
    t0 = time.perf_counter()
    st = env._gen_grid(g, B)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if not (st.grid[..., 0] == C.GOAL).flatten(1).any(1).all():
        raise AssertionError(f"{env_id}: a layout without a goal")
    return {"s_per_batch": secs} | dataclasses.asdict(S.COUNTERS)


def wfc_product_ms(preset="ObstaclesAngular", B=BATCH, shape=(23, 23)):
    """The support product's time on the card in its two exact operand
    types, bf16 (the solver's) and f32: one propagation pass
    (four products and their shifts) and one product alone, at ``B`` waves
    of the preset's catalog (CUDA events)."""
    import torch

    from minigrid_tpu_torch.envs.wfc import solver as S

    adj, w, periodic = wfc_catalog(preset, "cuda")
    P = adj.shape[1]
    g = torch.Generator(device="cuda").manual_seed(SEED)
    wave = torch.rand((B,) + shape + (P,), generator=g, device="cuda") < 0.5
    _, adj_bf16, edge_bf16, _ = S._catalog(adj, w, "cuda")
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        adj_t, edge = adj_bf16.to(dtype), edge_bf16.to(dtype)
        x = torch.zeros((wave.numel() // P, adj_t.shape[-1]), dtype=dtype,
                        device="cuda")
        x[:, :P] = wave.reshape(-1, P)
        name = str(dtype).split(".")[-1]
        out[f"pass_ms_{name}"] = cuda_ms(
            lambda: S._pass(wave, adj_t, edge, periodic), 10)
        out[f"product_ms_{name}"] = cuda_ms(
            lambda: torch.matmul(x, adj_t[0]), 20)
    out["product_flop"] = 2 * B * shape[0] * shape[1] * P * P  # unpadded
    return out


def main() -> int:
    script_t0 = time.perf_counter()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import minigrid_tpu_torch as mt
    from minigrid_tpu_torch.models.actor_critic import (ActorCritic,
                                                        ActorCriticRNN,
                                                        encode_obs,
                                                        init_params,
                                                        init_params_rnn)
    from minigrid_tpu_torch.envs.base import (autoreset_step_select,
                                              draw_independent_rows,
                                              independent_candidates,
                                              presample_reset_states,
                                              random_keys)
    from minigrid_tpu_torch import wrappers as WR
    from minigrid_tpu_torch.core import roomgrid as RG
    from minigrid_tpu_torch.models.actor_critic import encode_packed
    from minigrid_tpu_torch.render import get_atlas, get_frame
    from minigrid_tpu_torch.envs.babyai.core import level as level_module
    from minigrid_tpu_torch.envs.babyai.core.level import (USE_DONE_ACTIONS,
                                                           RoomGridLevel)
    from minigrid_tpu_torch.models.bc import behavior_clone
    from minigrid_tpu_torch.models.eval import episode_budget, evaluate_success
    from minigrid_tpu_torch.utils.demos import generate_demos
    from minigrid_tpu_torch.models.ppo import (PPOConfig, epoch_minibatches,
                                               fresh_sizes, gae,
                                               make_optimizer,
                                               make_train_step, ppo_update,
                                               rollout, sample_rollout_noise,
                                               update_minibatch)
    from minigrid_tpu_torch.ops import fused_step as F
    from minigrid_tpu_torch.ops.fused_step import (
        GROUP_LANES, KERNEL, _fused_observe_cuda, _fused_rollout_cuda,
        fused_observe_reference, fused_rollout_reference, has_step_hooks,
        launch_geometry, sm_count)

    from minigrid_tpu_torch.utils.demos import bot_episodes, reset_seeds
    from minigrid_tpu_torch.benchmark import benchmark

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {kind}")

    # --- 1. build -------------------------------------------------------
    t0 = time.perf_counter()
    KERNEL.library()
    print(f"kernel built in {time.perf_counter() - t0:.2f} s")
    for line in KERNEL.build_log.splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print("  " + line.strip())
    sms = sm_count(torch.device("cuda"))

    def geometry(B, W=8, H=8, V=7, group_lanes=None):
        geo = launch_geometry(B, W, H, V, sms, group_lanes)
        return (f"G={geo.group_lanes}, {geo.envs_per_block} envs x "
                f"{geo.blocks} blocks, {geo.threads} threads, "
                f"{geo.shared_memory_bytes} bytes of shared memory per "
                f"block, {geo.blocks * geo.threads / 32 / sms:.1f} warps "
                f"per SM")

    print(f"  {sms} SMs; DoorKey-8x8 B={BATCH}: {geometry(BATCH)}; "
          f"B=65536: {geometry(65536)}; DoorKey-16x16 B=1000: "
          f"{geometry(1000, 16, 16)}; MultiRoom 25x25 B={BATCH}: "
          f"{geometry(BATCH, 25, 25)}; RedBlueDoors 16x8 B={BATCH}: "
          f"{geometry(BATCH, 16, 8)}; BossLevel 22x22 B={BATCH}: "
          f"{geometry(BATCH, 22, 22)}; ObstructedMaze-Full 16x16 B={BATCH}: "
          f"{geometry(BATCH, 16, 16)}")

    # --- 2. kernel against plain version -------------------------------
    def check(name, env_id, B, T, hint=None, reset=False, native=False,
              view=None, group_lanes=None):
        env = mt.make(env_id, device="cuda").packed()
        if view is not None:
            env = env.replace_params(view_size=view)
        g = env.generator(SEED + 1)
        if reset:
            _, st = env.reset_staggered(g, B)
        else:
            _, st = env.reset(g, B)
        if hint == "interact":
            choice = torch.tensor([0, 1, 2, 2, 3, 4, 5, 5], device="cuda")
            actions = choice[torch.randint(0, 8, (T, B), generator=g,
                                           device="cuda")]
        else:
            actions = torch.randint(0, 7, (T, B), generator=g, device="cuda")
        actions = actions.to(torch.int32)
        rg = rs = None
        if reset:
            rows = env.make_pool(g, 64).rows(
                torch.randint(0, 64, (T,), generator=g, device="cuda"))
            rg, rs = rows.grid, rows.scal
        got = _fused_rollout_cuda(env.params, st, actions, native, rg, rs,
                                  group_lanes)
        torch.cuda.synchronize()
        want = fused_rollout_reference(env.params, st, actions, native, rg,
                                       rs)
        torch.cuda.synchronize()
        if reset:
            n_done = int((got[3] | got[4]).sum())
            print(f"  {name}: {n_done} resets selected over {T} steps")
        return compare(name, got, want)

    errs = [
        check("DoorKey-8x8 B=4096 T=64 pure", ENV_ID, BATCH, 64),
        check("Empty-8x8 B=4096 T=64 see-through native layout",
              "MiniGrid-Empty-8x8-v0", BATCH, 64, native=True),
        check("DoorKey-5x5 B=4096 T=64 interaction stream",
              "MiniGrid-DoorKey-5x5-v0", BATCH, 64, hint="interact"),
        check("DoorKey-8x8 ragged B=4000 T=32", ENV_ID, 4000, 32),
        check("DoorKey-8x8 B=4096 T=64 reset-row entry", ENV_ID, BATCH, 64,
              reset=True),
        check("DoorKey-16x16 B=1000 T=16 reset-row entry",
              "MiniGrid-DoorKey-16x16-v0", 1000, 16, hint="interact",
              reset=True),
        check("DoorKey-8x8 view size 9 B=4096 T=64 reset-row entry", ENV_ID,
              BATCH, 64, hint="interact", reset=True, view=9),
    ]
    for G in GROUP_LANES:  # every width, a ragged last block in each
        errs.append(check(f"DoorKey-8x8 G={G} B=1001 T=16 reset-row entry",
                          ENV_ID, 1001, 16, hint="interact", reset=True,
                          group_lanes=G))

    # the observe entry against plain gen_obs, on states after 16
    # interaction steps (doors opened, keys carried)
    def check_observe(name, env_id, B, view=None, group_lanes=None):
        env = mt.make(env_id, device="cuda").packed()
        if view is not None:
            env = env.replace_params(view_size=view)
        g = env.generator(SEED + 3)
        _, st = env.reset(g, B)
        choice = torch.tensor([0, 1, 2, 2, 3, 4, 5, 5], device="cuda")
        acts = choice[torch.randint(0, 8, (16, B), generator=g,
                                    device="cuda")].to(torch.int32)
        st = _fused_rollout_cuda(env.params, st, acts, False, None, None)[0]
        got = _fused_observe_cuda(env.params, st, group_lanes)
        torch.cuda.synchronize()
        want = fused_observe_reference(env.params, st)
        err = (got.double() - want.double()).abs().max().item()
        if not torch.equal(got, want):
            raise AssertionError(f"observe entry: {name} differs from plain "
                                 f"gen_obs (max abs {err})")
        carried = int((st.carrying[:, 0] != 1).sum())
        print(f"observe == plain: {name} ({carried} envs carrying; max_abs_"
              f"err {err})")
        return err

    observe_errs = [
        check_observe("DoorKey-8x8 B=4096", ENV_ID, BATCH),
        check_observe("Empty-8x8 B=4096 see-through",
                      "MiniGrid-Empty-8x8-v0", BATCH),
        check_observe("DoorKey-5x5 B=4096", "MiniGrid-DoorKey-5x5-v0", BATCH),
        check_observe("DoorKey-8x8 ragged B=4000", ENV_ID, 4000),
        check_observe("DoorKey-8x8 view size 9 B=4096", ENV_ID, BATCH,
                      view=9),
    ] + [check_observe(f"DoorKey-8x8 G={G} B=1001", ENV_ID, 1001,
                       group_lanes=G) for G in GROUP_LANES]
    # both entries on states of every other family: the step entry with
    # and without a reset row, and the observe entry
    for env_id in CORE_FAMILIES + HOOK_FAMILIES:
        name = short(env_id)
        errs.append(check(f"{name} B=1024 T=32 interaction stream", env_id,
                          1024, 32, hint="interact"))
        errs.append(check(f"{name} B=1024 T=32 reset-row entry", env_id,
                          1024, 32, hint="interact", reset=True))
        observe_errs.append(check_observe(f"{name} B=1024", env_id, 1024))
    # the RoomGrid families and BabyAI levels: the step entry without a
    # row (their hook path) on the uniform and the interaction streams, and
    # the observe entry; the 22x22 and 16x16 shapes at full width
    for env_id in ROOMGRID_KERNEL:
        name = short(env_id)
        W = mt.make(env_id, device="cpu").params.width
        B = BATCH if W >= 16 else 1024
        errs.append(check(f"{name} B={B} T=32 uniform stream", env_id, B, 32))
        errs.append(check(f"{name} B={B} T=32 interaction stream", env_id,
                          B, 32, hint="interact"))
        observe_errs.append(check_observe(f"{name} B={B}", env_id, B))
    # the WFC layouts (25x25, no step hooks): both entries on the states of
    # the smallest and the largest catalog of the 6 IDs, the step entry with
    # and without a reset row; the seconds each WFC addition takes on the
    # script's clock are kept in ``wfc_secs``
    t0 = time.perf_counter()
    for env_id in WFC_KERNEL:
        name = short(env_id)
        errs.append(check(f"{name} B=1024 T=32 interaction stream", env_id,
                          1024, 32, hint="interact"))
        errs.append(check(f"{name} B=1024 T=32 reset-row entry", env_id,
                          1024, 32, hint="interact", reset=True))
        observe_errs.append(check_observe(f"{name} B=1024", env_id, 1024))
    wfc_secs = {"2 kernel checks": time.perf_counter() - t0}
    max_err = max(errs)
    observe_err = max(observe_errs)
    # the 64-bit view rows (33 <= V <= 63): both entries at V=33 and V=63
    # on DoorKey-8x8 and MultiRoom-N6's 25x25, B=1024, at the picked G (the
    # step entry with a reset row, T=32) and at every other G that fits
    # (T=8)
    wide_errs, wide_observe_errs = [], []
    for env_id in (ENV_ID, "MiniGrid-MultiRoom-N6-v0"):
        wp = mt.make(env_id, device="cpu").params
        for view in WIDE_VIEWS:
            name = f"{short(env_id)} view {view}"
            wide_errs.append(check(f"{name} B=1024 T=32 reset-row entry",
                                   env_id, 1024, 32, hint="interact",
                                   reset=True, view=view))
            wide_observe_errs.append(check_observe(f"{name} B=1024",
                                                   env_id, 1024, view=view))
            for G in GROUP_LANES:
                try:
                    launch_geometry(1024, wp.width, wp.height, view, sms, G)
                except ValueError:  # one warp of G-lane envs does not fit
                    print(f"  {name}: G={G} does not fit the shared memory")
                    continue
                wide_errs.append(check(f"{name} G={G} B=1024 T=8",
                                       env_id, 1024, 8, hint="interact",
                                       reset=True, view=view,
                                       group_lanes=G))
                wide_observe_errs.append(check_observe(
                    f"{name} G={G} B=1024", env_id, 1024, view=view,
                    group_lanes=G))
    wide_err = max(wide_errs)
    wide_observe_err = max(wide_observe_errs)

    # from here on the card path must never run the plain transition or
    # observation
    plain_gen_obs, plain_step_core = F.gen_obs, F.step_core

    def gen_obs_on_cpu_only(params, state):
        if state.grid.is_cuda:
            raise AssertionError("plain gen_obs ran on CUDA tensors")
        return plain_gen_obs(params, state)

    def step_core_on_cpu_only(params, state, action):
        if state.grid.is_cuda:
            raise AssertionError("plain step_core ran on CUDA tensors")
        return plain_step_core(params, state, action)

    F.gen_obs, F.step_core = gen_obs_on_cpu_only, step_core_on_cpu_only

    # --- 3. the main path -----------------------------------------------
    env = mt.make(ENV_ID, device="cuda").packed()
    g = env.generator(SEED)
    pool = env.make_pool(g, POOL_SIZE)
    obs, st = env.reset_staggered(g, BATCH)
    model = init_params(ActorCritic(hidden=256, dtype=torch.bfloat16,
                                    device="cuda"), g)
    warm = sample_rollout_noise(g, pool, BATCH, 4, model.num_actions)
    st, obs, _, _ = rollout(model, env, st, obs, warm)    # cuBLAS warm-up
    noise = sample_rollout_noise(g, pool, BATCH, ROLLOUT_LEN,
                                 model.num_actions)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    st, obs, traj, _ = rollout(model, env, st, obs, noise)
    torch.cuda.synchronize()
    rollout_s = time.perf_counter() - t0
    launches = KERNEL.launches
    print(f"main path: {ROLLOUT_LEN}-step pooled rollout, B={BATCH}: "
          f"{launches} kernel launches")
    if launches != ROLLOUT_LEN:
        raise AssertionError(f"expected {ROLLOUT_LEN} kernel launches on the "
                             f"main path, counted {launches}")
    V = env.params.view_size
    assert traj.obs["img_feat"].shape == (ROLLOUT_LEN, BATCH, V * V * 24)
    assert traj.action.shape == (ROLLOUT_LEN, BATCH)
    for k in ("log_prob", "value", "reward"):
        x = getattr(traj, k)
        assert x.shape == (ROLLOUT_LEN, BATCH) and torch.isfinite(x).all(), k
    assert int(traj.obs["img_feat"].sum(-1).min()) == V * V * 3
    assert ((traj.reward >= 0) & (traj.reward <= 1)).all()
    n_done = int(traj.done.sum())
    assert n_done > 0, "no episode ended in the rollout"
    assert ((obs["packed"] >> 9) == 0).all()
    print(f"  {n_done} episodes ended, {int((traj.reward > 0).sum())} "
          f"reached the goal; outputs finite and in range")

    # a small rollout on the card, replayed through the plain path on the
    # CPU with the actions the card took: observations, rewards and dones
    # exact, the f32 policy's values and log-probs within 1e-4 (the two
    # devices sum the matmuls in different orders)
    sm_env = mt.make(ENV_ID, device="cuda").packed()
    sg = sm_env.generator(SEED + 2)
    sm_pool = sm_env.make_pool(sg, 32)
    sm_obs, sm_st = sm_env.reset_staggered(sg, 64)
    f32 = init_params(ActorCritic(dtype=torch.float32, device="cuda"), sg)
    sm_noise = sample_rollout_noise(sg, sm_pool, 64, 16, f32.num_actions)
    _, _, sm_traj, _ = rollout(f32, sm_env, sm_st, sm_obs, sm_noise)
    cpu_env = mt.make(ENV_ID, device="cpu").packed()
    cpu_model = ActorCritic(dtype=torch.float32, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               f32.state_dict().items()})
    st_c = sm_st.map(lambda x: x.cpu())
    obs_c = {k: v.cpu() for k, v in sm_obs.items()}
    from minigrid_tpu_torch.models.actor_critic import mission_counts
    counts = mission_counts(obs_c["mission"])
    rows = sm_noise.reset_rows
    for t in range(16):
        enc = encode_obs({"packed": obs_c["packed"], "direction":
                          obs_c["direction"], "mission_counts": counts})
        for k, v in enc.items():
            if not torch.equal(v, sm_traj.obs[k][t].cpu()):
                raise AssertionError(f"replay step {t}: obs {k} differs")
        logits, value = cpu_model(enc)
        lp = torch.log_softmax(logits, -1).gather(
            -1, sm_traj.action[t].cpu().long()[:, None])[:, 0]
        torch.testing.assert_close(value, sm_traj.value[t].cpu(), rtol=0,
                                   atol=1e-4)
        torch.testing.assert_close(lp, sm_traj.log_prob[t].cpu(), rtol=0,
                                   atol=1e-4)
        row = rows.rows(t)
        obs_c, st_c, r, te, tr, _ = cpu_env.step_autoreset_presampled(
            sm_noise.step_keys[t].cpu(), st_c, sm_traj.action[t].cpu(),
            row.to("cpu"))
        if not (torch.equal(r, sm_traj.reward[t].cpu())
                and torch.equal(te | tr, sm_traj.done[t].cpu())):
            raise AssertionError(f"replay step {t}: reward/done differ")
        counts = torch.where((te | tr)[:, None],
                             mission_counts(row.mission.cpu()), counts)
    print("small rollout (B=64, T=16, f32) on the card == replay through "
          "the plain path on the CPU")

    # the resets that select a different state into each finished env,
    # stepped on the card through the public entry points and replayed on
    # the CPU with the same actions and candidate states: the regenerated
    # batch and the independent row indices are redrawn from a copy of the
    # generator, the fresh buffer is copied; small buffer and window so the
    # fresh mode overflows
    def replay_resets(mode, B=64, T=16):
        env = mt.make(ENV_ID, device="cuda").packed()
        cpu_env = mt.make(ENV_ID, device="cpu").packed()
        g = env.generator(SEED + 4)
        _, st = env.reset(g, B)
        ms = env.params.max_steps
        st = st.replace(step_count=(ms - 1 - torch.arange(
            B, device="cuda") % T).to(torch.int32))
        st_c = st.map(lambda x: x.cpu())
        pool = env.make_pool(g, 32)
        buffer, window = env.presample_fresh(g, 48), 8
        cursor = torch.zeros((), dtype=torch.int32, device="cuda")
        cursor_c = cursor.cpu()
        n_done = overflow = 0
        zero_counts()
        for t in range(T):
            keys = random_keys(g, (B, 2), "cuda")
            a = torch.randint(0, 7, (B,), generator=g, device="cuda",
                              dtype=torch.int32)
            k_c, a_c = keys.cpu(), a.cpu()
            if mode == "regen":
                cand = env._gen_grid(clone_generator(g), B)
                out = env.step_autoreset(keys, st, a, g)
                ref = autoreset_step_select(cpu_env, st_c, a_c,
                                            cand.map(lambda x: x.cpu()))
            elif mode == "independent":
                idx = draw_independent_rows(clone_generator(g), pool, B)
                out = env.step_autoreset_pooled(keys, st, a, pool, g,
                                                independent=True)
                ref = autoreset_step_select(
                    cpu_env, st_c, a_c,
                    independent_candidates(k_c, pool.to("cpu"), idx.cpu()))
            else:
                out = env.step_autoreset_fresh(keys, st, a, buffer, cursor,
                                               window)
                ref = cpu_env.step_autoreset_fresh(
                    k_c, st_c, a_c, buffer.map(lambda x: x.cpu()), cursor_c,
                    window)
                assert_same(f"fresh step {t} reset_overflow",
                            out[5]["reset_overflow"],
                            ref[5]["reset_overflow"])
                assert_same(f"fresh step {t} cursor", out[6], ref[6])
                cursor, cursor_c = out[6], ref[6]
                overflow += int(out[5]["reset_overflow"])
            for name, x, y in zip(("obs", "state", "reward", "terminated",
                                   "truncated"), out[:5], ref[:5]):
                assert_same(f"{mode} step {t} {name}", x, y)
            st, st_c = out[1], ref[1]
            n_done += int((out[3] | out[4]).sum())
        if (KERNEL.launches, KERNEL.observe_launches) != (T, T):
            raise AssertionError(f"{mode}: expected {T} step and {T} observe "
                                 "launches")
        if n_done < B:
            raise AssertionError(f"{mode}: only {n_done} resets")
        extra = (f"; cursor {int(cursor)}, reset_overflow {overflow}"
                 if mode == "fresh" else "")
        print(f"{mode} resets (B={B}, T={T}): {n_done} resets, {T} step + "
              f"{T} observe launches; card == CPU replay{extra}")
        if mode == "fresh" and overflow == 0:
            raise AssertionError("the fresh replay never overflowed")

    for mode in ("regen", "independent", "fresh"):
        replay_resets(mode)

    # the hook path: each hook family's step (the hooks in PyTorch around
    # the step entry), then its pooled auto-reset (step, the row selected
    # in PyTorch, the observe entry), on the card and replayed on the CPU
    # with the same keys, actions and rows; the episodes end in the second
    # half, so the resets select. A BabyAI level's budget is per episode
    # (``extra["max_steps"]``), and its verifier replaces the state every
    # step, so each of its steps is observed again
    def replay_hooks(env_id, B=256, T=16, done_actions=False):
        env = mt.make(env_id, device="cuda").packed()
        cpu_env = mt.make(env_id, device="cpu").packed()
        g = env.generator(SEED + 8)
        _, st = env.reset(g, B)
        level = isinstance(env, RoomGridLevel)
        ms = st.extra["max_steps"] if level else env.params.max_steps
        st = st.replace(step_count=(ms - 1 - torch.arange(
            B, device="cuda") % (2 * T)).clamp(min=0).to(torch.int32))
        st_c = st.map(lambda x: x.cpu())
        rows = presample_reset_states(g, env.make_pool(g, 32), T)
        choice = torch.tensor([0, 1, 2, 2, 3, 4, 5, 5, 6], device="cuda")
        n_done = n_success = 0
        zero_counts()
        level_module.USE_DONE_ACTIONS = done_actions
        for t in range(T):
            keys = random_keys(g, (B, 2), "cuda")
            a = choice[torch.randint(0, len(choice), (B,), generator=g,
                                     device="cuda")].to(torch.int32)
            k_c, a_c = keys.cpu(), a.cpu()
            if t < T // 2:
                out = env.step(keys, st, a)
                ref = cpu_env.step(k_c, st_c, a_c)
            else:
                out = env.step_autoreset_presampled(keys, st, a, rows.rows(t))
                ref = cpu_env.step_autoreset_presampled(
                    k_c, st_c, a_c, rows.rows(t).to("cpu"))
            for name, x, y in zip(("obs", "state", "reward", "terminated",
                                   "truncated"), out[:5], ref[:5]):
                assert_same(f"{short(env_id)} hook step {t} {name}", x, y)
            st, st_c = out[1], ref[1]
            n_done += int((out[3] | out[4]).sum())
            n_success += int((out[2] > 0).sum())
        level_module.USE_DONE_ACTIONS = USE_DONE_ACTIONS
        want = (T, T if level else T // 2)
        launched = (KERNEL.launches, KERNEL.observe_launches)
        if launched != want:
            raise AssertionError(f"{env_id}: (step, observe) launches "
                                 f"{launched}, expected {want}")
        if n_done < B // 2:
            raise AssertionError(f"{env_id}: only {n_done} episodes ended")
        mode = ", done actions" if done_actions else ""
        print(f"hook path, {short(env_id)}{mode} (B={B}, T={T}): {n_done} "
              f"episodes ended, {n_success} rewarded; {want[0]} step + "
              f"{want[1]} observe launches; card == CPU replay, extra "
              f"included")

    for env_id in HOOK_FAMILIES + ROOMGRID_HOOKS:
        replay_hooks(env_id)
    replay_hooks(ROOMGRID_HOOKS[-1], done_actions=True)

    # --- 3b. rendering and the wrappers, card against CPU ---------------
    # get_frame on states after interaction steps (every third agent given
    # a key to carry): full frames with and without the view cone and POV
    # frames at tile 8 and 32, on the card and on the CPU, bit-exact; the
    # cone and the POV cells come from the observe entry (one launch each)
    def replay_render(env_id, B, steps=8):
        env = mt.make(env_id, device="cuda").packed()
        g = env.generator(SEED + 11)
        _, st = env.reset(g, B)
        choice = torch.tensor([0, 1, 2, 2, 3, 4, 5, 5], device="cuda")
        for _ in range(steps):
            a = choice[torch.randint(0, 8, (B,), generator=g,
                                     device="cuda")].to(torch.int32)
            st = env.step(random_keys(g, (B, 2), "cuda"), st, a)[1]
        key = torch.tensor([5, 4, 0, 0, 0], dtype=torch.uint8, device="cuda")
        carry = (torch.arange(B, device="cuda") % 3 == 0)[:, None]
        st = st.replace(carrying=torch.where(carry, key, st.carrying))
        st_c = st.map(lambda x: x.cpu())
        launched = {v: [] for v in RENDER_VARIANTS}  # per card call
        for tile in (8, 32):
            for variant, kw in RENDER_VARIANTS.items():
                zero_counts()
                got = get_frame(env.params, st, tile_size=tile, **kw)
                launched[variant].append(KERNEL.observe_launches)
                want = get_frame(env.params, st_c, tile_size=tile, **kw)
                assert_same(f"{short(env_id)} {variant} frame tile {tile}",
                            got, want)
                del got, want
        # the cone and the POV cells come from one observe launch a frame;
        # a frame without the cone needs no observation
        want_launched = {"full": [1, 1], "no highlight": [0, 0],
                         "pov": [1, 1]}
        if launched != want_launched:
            raise AssertionError(f"{env_id} frames: observe launches per "
                                 f"call {launched}, expected "
                                 f"{want_launched}")
        print(f"render, {short(env_id)} B={B} (W={env.params.width}, H="
              f"{env.params.height}): full, no-highlight and POV frames at "
              f"tile 8 and 32 on the card == CPU; observe launches per "
              f"call (tile 8, 32) {launched}")
        return st, {v: n[0] for v, n in launched.items()}

    render_states, frame_launches = replay_render(ENV_ID, BATCH)
    replay_render("BabyAI-BossLevel-v0", 1024, steps=4)

    # each of the 15 wrappers and three stacks, B=256, 32 steps from
    # staggered resets with pooled reset rows (ReseedWrapper: its exact
    # auto-reset to its seeds' layouts), on the card and replayed on the
    # CPU with the same keys, actions and rows: observations, rewards,
    # flags and the WrappedState bit-exact (NaN-equal), and the launches
    # of each entry per step as the path predicts
    def replay_wrapper(name, env_id, packed, wrap, per_step, B=256, T=32):
        env = mt.make(env_id, device="cuda")
        cpu_env = mt.make(env_id, device="cpu")
        if packed:
            env, cpu_env = env.packed(), cpu_env.packed()
        w, wc = wrap(env), wrap(cpu_env)
        exact = isinstance(w, WR.ReseedWrapper)
        if exact:  # the CPU replay resets to the card's layouts
            wc.layouts = w.layouts.map(lambda x: x.cpu())
        g = env.generator(SEED + 12)
        _, st = w.reset(g, B)
        e = WR._inner_env_state(st)
        st = WR._replace_inner(st, e.replace(step_count=(
            env.params.max_steps - 1 - torch.arange(B, device="cuda") % T
        ).to(torch.int32)))
        st_c = st.map(lambda x: x.cpu())
        rows = (None if exact
                else presample_reset_states(g, w.make_pool(g, 64), T))
        zero_counts()
        n_done = 0
        for t in range(T):
            keys = random_keys(g, (B, 2), "cuda")
            a = torch.randint(0, 7, (B,), generator=g, device="cuda",
                              dtype=torch.int32)
            if exact:
                out = w.step_autoreset(keys, st, a, g)
                ref = wc.step_autoreset(keys.cpu(), st_c, a.cpu(), None)
            else:
                out = w.step_autoreset_presampled(keys, st, a, rows.rows(t))
                ref = wc.step_autoreset_presampled(
                    keys.cpu(), st_c, a.cpu(), rows.rows(t).to("cpu"))
            for part, x, y in zip(("obs", "state", "reward", "terminated",
                                   "truncated"), out[:5], ref[:5]):
                assert_same(f"{name} step {t} {part}", x, y)
            st, st_c = out[1], ref[1]
            n_done += int((out[3] | out[4]).sum())
        launched = (KERNEL.launches, KERNEL.observe_launches)
        want = (per_step[0] * T, per_step[1] * T)
        if launched != want:
            raise AssertionError(f"{name}: (step, observe) launches "
                                 f"{launched}, expected {want}")
        if n_done < B:
            raise AssertionError(f"{name}: only {n_done} episodes ended")
        print(f"wrapper {name} (B={B}, T={T}, "
              f"{'exact' if exact else 'pooled'} resets): {n_done} episodes "
              f"ended; {per_step[0]} step + {per_step[1]} observe launches a "
              f"step; card == CPU replay")
        return {"launches_per_step": (launched[0] // T, launched[1] // T),
                "episodes_ended": n_done}

    wrappers = {name: replay_wrapper(name, *case)
                for name, case in wrapper_cases().items()}

    # --- 3c. the BabyAI bot on the card, replayed on the CPU --------------
    # each level's 8 seeds as one batch on the card (the hook path: a step
    # entry and an observe entry a step), one host copy of the batch's state
    # a step; the bot must solve a seed within 240 steps. The same initial
    # states, copied to the CPU, stepped there by the CPU's bots: the
    # actions and every state tensor of every step bit-exact, extra included
    bot_runs = {}
    for level in BOT_LEVELS:
        benv = mt.make(level, device="cuda")
        obs0, st0_b = reset_seeds(benv, range(BOT_SEEDS))
        trace, cpu_trace = [], []
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        eps = bot_episodes(benv, obs0, st0_b, BOT_STEPS, trace)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launched = (KERNEL.launches, KERNEL.observe_launches)
        if launched != (len(trace), len(trace)):
            raise AssertionError(f"{level}: (step, observe) launches "
                                 f"{launched} over {len(trace)} steps")
        solved = [b for b, e in enumerate(eps) if e[4]]
        if not solved:
            raise AssertionError(f"the bot solved no seed of {level} in "
                                 f"{BOT_STEPS} steps")
        cpu_eps = bot_episodes(mt.make(level, device="cpu"),
                               {k: v.cpu() for k, v in obs0.items()},
                               st0_b.map(lambda x: x.cpu()), BOT_STEPS,
                               cpu_trace)
        if len(cpu_trace) != len(trace):
            raise AssertionError(f"{level}: the CPU replay took "
                                 f"{len(cpu_trace)} steps, the card "
                                 f"{len(trace)}")
        for t, ((a, s_card), (ca, s_cpu)) in enumerate(zip(trace,
                                                           cpu_trace)):
            if not np.array_equal(a, ca):
                raise AssertionError(f"{level} step {t}: the bots' actions "
                                     f"differ between the card and the CPU")
            assert_same(f"{level} bot step {t}", s_card, s_cpu)
        if [e[2] for e in eps] != [e[2] for e in cpu_eps]:
            raise AssertionError(f"{level}: the episodes differ")
        lengths = [len(eps[b][2]) for b in solved]
        bot_runs[level] = {"solved_seeds": solved, "solved_steps": lengths,
                           "batch_steps": len(trace), "s": secs,
                           "launches": launched}
        print(f"bot, {short(level)}: solved seeds {solved} of "
              f"{BOT_SEEDS} in {lengths} steps; {len(trace)} batch steps "
              f"(B={BOT_SEEDS}) in {secs:.2f} s on the card, {launched[0]} "
              f"step + {launched[1]} observe launches; the CPU replay "
              f"bit-exact (host clock; {card})")

    # --- 3d. WaveFunctionCollapse on the card ----------------------------
    # the solver on the card against the CPU from the same keys, a pool of
    # each of the 6 IDs made on the card and held to its invariants, and 32
    # pooled steps of one ID (the step entry with the broadcast row)
    # replayed on the CPU
    t0 = time.perf_counter()
    wfc = {"solves": wfc_solver_replays("cuda")}
    wfc_secs["3d solver replays"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    wfc["pools"] = {short(env_id): wfc_pool(env_id, "cuda")
                    for env_id in WFC_IDS}
    wfc_secs["3d pools"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    n_done, wfc_launched = wfc_replay_steps(WFC_IDS[0], "cuda")
    wfc_secs["3d stepping"] = time.perf_counter() - t0
    if wfc_launched != (32, 0):
        raise AssertionError(f"WFC pooled steps: (step, observe) launches "
                             f"{wfc_launched}, expected (32, 0)")
    wfc["stepping"] = {"episodes_ended": n_done, "launches": wfc_launched}
    print(f"WFC pooled steps, {short(WFC_IDS[0])} (B=256, T=32): {n_done} "
          f"episodes ended; 32 step + 0 observe launches; card == CPU "
          f"replay")

    # --- 4. the train step at full width --------------------------------
    cfg = PPOConfig()  # B=4096, T=128, 1 epoch of 4 rotate minibatches
    assert (cfg.num_envs, cfg.rollout_len) == (BATCH, ROLLOUT_LEN)

    def train_phase(env_id, mode, fresh_buffer=None, wrap=None):
        """One warm-up train step, then three timed ones (one for
        :data:`ONE_TIMED_STEP`) with both entries' launch counts set to 0
        before and read after; then one more rollout and update timed
        apart, and one rollout under the profiler for the device kernels
        per step. A BabyAI level is staggered by :func:`stagger_budget`.
        ``wrap``: a stateful wrapper over the env, whose visit counts must
        grow by B x T a train step."""
        tenv = mt.make(env_id, device="cuda").packed()
        if wrap is not None:
            tenv = wrap(tenv)
        tg = tenv.generator(SEED + 5)
        model = init_params(ActorCritic(hidden=256, dtype=torch.bfloat16,
                                        device="cuda"), tg)
        opt = make_optimizer(model, cfg)
        tpool = (tenv.make_pool(tg, POOL_SIZE) if mode == "pooled"
                 else None)
        obs, st = tenv.reset_staggered(tg, BATCH)
        budget = isinstance(tenv, RoomGridLevel)
        if wrap is None:
            st, fresh_buffer = stagger_budget(tenv, st, tg, fresh_buffer)
        reps = 1 if env_id in ONE_TIMED_STEP else 3
        step = make_train_step(tenv, model, cfg, opt, resets=mode,
                               fresh_buffer=fresh_buffer)
        st, obs, _ = step(st, obs, tg, tpool)               # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        metrics, visits = [], []
        for _ in range(reps):
            st, obs, m = step(st, obs, tg, tpool)
            metrics.append(m)
            if wrap is not None:
                visits.append(st.wrapper.sum())
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / reps
        launches_t = KERNEL.launches, KERNEL.observe_launches
        one_launch = (mode == "pooled" and wrap is None
                      and not has_step_hooks(tenv))
        visits = [int(v) for v in visits]
        if wrap is not None and visits != [BATCH * ROLLOUT_LEN * (k + 2)
                                           for k in range(reps)]:
            raise AssertionError(f"visit counts {visits} do not grow by "
                                 "B x T a train step")
        want = (reps * ROLLOUT_LEN, 0 if one_launch else reps * ROLLOUT_LEN)
        if launches_t != want:
            raise AssertionError(f"{short(env_id)} {mode} train steps: "
                                 f"(step, observe) launches {launches_t}, "
                                 f"expected {want}")
        metrics = [{k: float(v) for k, v in m.items()} for m in metrics]
        overflow = sum(m.get("reset_overflow", 0) for m in metrics)
        for m in metrics:
            if not all(math.isfinite(v) for v in m.values()):
                raise AssertionError(f"{mode}: metrics not finite: {m}")
            # the bench's sizing of a BabyAI buffer may overflow: reported
            if m.get("reset_overflow", 0) != 0 and not budget:
                raise AssertionError(f"{mode}: reset_overflow {m}")
        lo, hi = tenv.reward_range
        if wrap is None and not lo <= metrics[-1]["mean_reward"] <= hi:
            raise AssertionError(f"{mode}: mean reward out of range")
        peak = torch.cuda.max_memory_allocated() / 2**30
        # where the time goes: the rollout and the update of one more
        # step, timed apart
        noise = sample_rollout_noise(tg, tpool, BATCH, ROLLOUT_LEN,
                                     model.num_actions, device="cuda")
        n_buf, window = (fresh_sizes(tenv, cfg, fresh_buffer)
                         if mode == "fresh" else (None, 32))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, obs, traj, _ = rollout(model, tenv, st, obs, noise, mode, tg,
                                   n_buf, window)
        torch.cuda.synchronize()
        rollout_only = time.perf_counter() - t0
        n_done = int(traj.done.sum())
        t0 = time.perf_counter()
        ppo_update(model, opt, cfg, traj, obs, tg)
        torch.cuda.synchronize()
        update_only = time.perf_counter() - t0
        noise = sample_rollout_noise(tg, tpool, BATCH, ROLLOUT_LEN,
                                     model.num_actions, device="cuda")
        # profiled at the end of the script, after the kernel timings (a
        # profiler session after these large ones has lost records)
        profile_rollout = lambda: cuda_events(lambda: rollout(
            model, tenv, st, obs, noise, mode, tg, n_buf, window))
        rate = BATCH * ROLLOUT_LEN / step_s
        name = (short(env_id) if wrap is None
                else f"{wrap.__name__}({short(env_id)})")
        print(f"train step, {name} {mode} resets: {rate:.0f} env-steps/s "
              f"(B={BATCH}, T={ROLLOUT_LEN}, bf16 hidden=256; "
              f"{step_s * 1e3:.1f} ms per step; apart: rollout "
              f"{rollout_only * 1e3:.1f} ms, update {update_only * 1e3:.1f} "
              f"ms; {launches_t[0] // reps} step + {launches_t[1] // reps} "
              f"observe "
              f"launches per step; {n_done} episodes ended in the rollout; "
              f"peak "
              f"{peak:.2f} GiB; host clock; {card})")
        print(f"  metrics of the last step: {json.dumps(metrics[-1])}")
        if mode == "fresh":
            print(f"  fresh buffer {n_buf} rows, window {window}; reset "
                  f"overflow {overflow:.0f} over the {reps} timed steps")
        if n_done == 0:
            raise AssertionError(f"{name} {mode}: no episode ended")
        return {"env_steps_per_s": rate, "step_s": step_s,
                "reset_overflow": overflow, "fresh_buffer": n_buf,
                "rollout_s": rollout_only, "update_s": update_only,
                "timed_steps": reps, "launches": launches_t[0],
                "observe_launches": launches_t[1],
                "launches_per_step": launches_t[0] // reps,
                "observe_launches_per_step": launches_t[1] // reps,
                "peak_gib": peak, "visits": visits,
                "metrics": metrics[-1]}, profile_rollout

    train, profile_later = {}, {}
    for mode in ("pooled", "fresh", "regen"):
        train[mode], profile_later[mode] = train_phase(ENV_ID, mode)
    for env_id, mode, fresh_buffer in FAMILY_TRAIN:
        key = f"{short(env_id)} {mode}"
        t0 = time.perf_counter()
        train[key], profile_later[key] = train_phase(env_id, mode,
                                                     fresh_buffer)
        if env_id in WFC_IDS:
            wfc_secs["4 train step"] = time.perf_counter() - t0
    # a stateful wrapper's WrappedState batch through the pooled train step
    key = "ActionBonus(DoorKey-8x8) pooled"
    train[key], profile_later[key] = train_phase(ENV_ID, "pooled",
                                                 wrap=WR.ActionBonus)
    print(f"  visit counts after the timed steps: {train[key]['visits']} "
          f"(B x T = {BATCH * ROLLOUT_LEN} a step)")
    torch.cuda.empty_cache()

    # the recurrent train step at full width: DoorKey-8x8 fresh, B=4096,
    # T=128, ActorCriticRNN(hidden=256) bf16, PPOConfig() (the JAX bench's
    # ppo_train_step_rnn configuration, bench.py:308-339): one warm-up step
    # and three timed with both entries' launch counts set to 0 before and
    # read after, then a rollout and an update timed apart
    def train_phase_rnn():
        tenv = mt.make(ENV_ID, device="cuda").packed()
        tg = tenv.generator(SEED + 14)
        model = init_params_rnn(ActorCriticRNN(
            hidden=256, dtype=torch.bfloat16, device="cuda"), tg)
        opt = make_optimizer(model, cfg)
        obs, st = tenv.reset_staggered(tg, BATCH)
        h = model.initial_state(BATCH)
        step = make_train_step(tenv, model, cfg, opt, resets="fresh")
        st, obs, h, _ = step(st, obs, h, tg)                # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        metrics = []
        for _ in range(3):
            st, obs, h, m = step(st, obs, h, tg)
            metrics.append(m)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / 3
        launches_t = KERNEL.launches, KERNEL.observe_launches
        if launches_t != (3 * ROLLOUT_LEN, 3 * ROLLOUT_LEN):
            raise AssertionError(f"recurrent train steps: (step, observe) "
                                 f"launches {launches_t}")
        metrics = [{k: float(v) for k, v in m.items()} for m in metrics]
        for m in metrics:
            if not all(math.isfinite(v) for v in m.values()):
                raise AssertionError(f"recurrent: metrics not finite: {m}")
            if m["reset_overflow"] != 0:
                raise AssertionError(f"recurrent: reset_overflow {m}")
        if not torch.isfinite(h.float()).all():
            raise AssertionError("recurrent: the hidden state is not finite")
        peak = torch.cuda.max_memory_allocated() / 2**30
        n_buf, window = fresh_sizes(tenv, cfg)
        noise = sample_rollout_noise(tg, None, BATCH, ROLLOUT_LEN,
                                     model.num_actions, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, obs, traj, _, h = rollout(model, tenv, st, obs, noise, "fresh",
                                      tg, n_buf, window, h)
        torch.cuda.synchronize()
        rollout_only = time.perf_counter() - t0
        last_done = traj.done[-1]
        if last_done.any() and bool(h[last_done].any()):
            raise AssertionError("recurrent: a finished env kept its hidden")
        t0 = time.perf_counter()
        ppo_update(model, opt, cfg, traj, obs, tg, h)
        torch.cuda.synchronize()
        update_only = time.perf_counter() - t0
        n_done = int(traj.done.sum())
        noise = sample_rollout_noise(tg, None, BATCH, ROLLOUT_LEN,
                                     model.num_actions, device="cuda")
        profile_rollout = lambda: cuda_events(lambda: rollout(
            model, tenv, st, obs, noise, "fresh", tg, n_buf, window, h))
        rate = BATCH * ROLLOUT_LEN / step_s
        print(f"train step, DoorKey-8x8 fresh resets, ActorCriticRNN: "
              f"{rate:.0f} env-steps/s (B={BATCH}, T={ROLLOUT_LEN}, bf16 "
              f"hidden=256; {step_s * 1e3:.1f} ms per step; apart: rollout "
              f"{rollout_only * 1e3:.1f} ms, update {update_only * 1e3:.1f} "
              f"ms; {launches_t[0] // 3} step + {launches_t[1] // 3} observe "
              f"launches per step; {n_done} episodes ended in the rollout; "
              f"peak {peak:.2f} GiB; MLP fresh in this run "
              f"{train['fresh']['env_steps_per_s']:.0f}; host clock; {card})")
        print(f"  metrics of the last step: {json.dumps(metrics[-1])}")
        return {"env_steps_per_s": rate, "step_s": step_s,
                "reset_overflow": 0, "fresh_buffer": n_buf,
                "rollout_s": rollout_only, "update_s": update_only,
                "timed_steps": 3, "launches": launches_t[0],
                "observe_launches": launches_t[1],
                "launches_per_step": launches_t[0] // 3,
                "observe_launches_per_step": launches_t[1] // 3,
                "peak_gib": peak, "visits": [],
                "metrics": metrics[-1]}, profile_rollout

    key = "DoorKey-8x8 fresh ActorCriticRNN"
    train[key], profile_later[key] = train_phase_rnn()
    torch.cuda.empty_cache()

    # one rotate epoch of the f32 update on the card and on the CPU, from
    # the same parameters and the same stored batch
    cfg_u = PPOConfig(num_envs=256, rollout_len=16)
    tenv = mt.make(ENV_ID, device="cuda").packed()
    tg = tenv.generator(SEED + 6)
    f32 = init_params(ActorCritic(dtype=torch.float32, device="cuda"), tg)
    cpu_model = ActorCritic(dtype=torch.float32, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               f32.state_dict().items()})
    u_pool = tenv.make_pool(tg, 64)
    obs, st = tenv.reset_staggered(tg, 256)
    noise = sample_rollout_noise(tg, u_pool, 256, 16, f32.num_actions)
    st, obs, traj, _ = rollout(f32, tenv, st, obs, noise)
    with torch.no_grad():
        _, last_value = f32(obs)
    adv, ret = gae(traj.reward, traj.value, traj.done, last_value,
                   cfg_u.gamma, cfg_u.gae_lambda)
    data = dict(traj.obs, action=traj.action, log_prob=traj.log_prob,
                adv=adv, ret=ret)
    initial = [p.detach().cpu().clone() for p in f32.parameters()]
    for m, d in ((f32, data), (cpu_model, {k: v.cpu() for k, v in
                                           data.items()})):
        opt = make_optimizer(m, cfg_u)
        for mb in epoch_minibatches(d, cfg_u, None, offset=1):
            update_minibatch(m, opt, cfg_u, mb)
    update_err = max((p.detach().cpu() - q.detach()).abs().max().item()
                     for p, q in zip(f32.parameters(),
                                     cpu_model.parameters()))
    moved = max((p.detach() - q).abs().max().item()
                for p, q in zip(cpu_model.parameters(), initial))
    print(f"f32 update, one rotate epoch (B=256, T=16): card vs CPU max abs "
          f"parameter difference {update_err:.3g} (tolerance 1e-4; the "
          f"parameters moved up to {moved:.3g})")
    if not update_err <= 1e-4:
        raise AssertionError(f"card and CPU updates differ by {update_err}")
    # the same for the recurrent update: each slab's GRU replayed from its
    # stored start hidden, episodes ending inside the slabs
    rnn = init_params_rnn(ActorCriticRNN(dtype=torch.float32,
                                         device="cuda"), tg)
    cpu_rnn = ActorCriticRNN(dtype=torch.float32, device="cpu")
    cpu_rnn.load_state_dict({k: v.cpu() for k, v in
                             rnn.state_dict().items()})
    obs, st = tenv.reset_staggered(tg, 256)
    noise = sample_rollout_noise(tg, u_pool, 256, 16, rnn.num_actions)
    st, obs, traj, _, h = rollout(rnn, tenv, st, obs, noise,
                                  h=rnn.initial_state(256))
    with torch.no_grad():
        (_, last_value), _ = rnn(obs, h)
    adv, ret = gae(traj.reward, traj.value, traj.done, last_value,
                   cfg_u.gamma, cfg_u.gae_lambda)
    data = dict(traj.obs, action=traj.action, log_prob=traj.log_prob,
                adv=adv, ret=ret, done=traj.done, hidden=traj.hidden)
    initial = [p.detach().cpu().clone() for p in rnn.parameters()]
    for m, d in ((rnn, data), (cpu_rnn, {k: v.cpu() for k, v in
                                         data.items()})):
        opt = make_optimizer(m, cfg_u)
        for mb in epoch_minibatches(d, cfg_u, None, offset=1):
            update_minibatch(m, opt, cfg_u, mb)
    rnn_update_err = max((p.detach().cpu() - q.detach()).abs().max().item()
                         for p, q in zip(rnn.parameters(),
                                         cpu_rnn.parameters()))
    moved = max((p.detach() - q).abs().max().item()
                for p, q in zip(cpu_rnn.parameters(), initial))
    print(f"f32 recurrent update, one rotate epoch (B=256, T=16, "
          f"{int(traj.done.sum())} episode ends): card vs CPU max abs "
          f"parameter difference {rnn_update_err:.3g} (tolerance 1e-4; the "
          f"parameters moved up to {moved:.3g})")
    if not rnn_update_err <= 1e-4:
        raise AssertionError(f"card and CPU recurrent updates differ by "
                             f"{rnn_update_err}")
    F.gen_obs, F.step_core = plain_gen_obs, plain_step_core

    # --- 5. timings -----------------------------------------------------
    rollout_rate = BATCH * ROLLOUT_LEN / rollout_s
    print(f"rollout: {rollout_rate:.0f} env-steps/s (B={BATCH}, "
          f"T={ROLLOUT_LEN}, bf16 ActorCritic, pooled resets; host clock; "
          f"{card})")

    _, st0 = env.reset(g, BATCH)
    rows1 = pool.rows(0)
    a1 = torch.randint(0, 7, (1, BATCH), generator=g, device="cuda",
                       dtype=torch.int32)
    p = env.params
    run1 = lambda: _fused_rollout_cuda(p, st0, a1, False, rows1.grid,
                                       rows1.scal)
    plain1 = lambda: fused_rollout_reference(p, st0, a1, False, rows1.grid,
                                             rows1.scal)
    ms1 = device_ms(run1, 200)
    call_ms1 = cuda_ms(run1, 200)
    plain_ms1 = cuda_ms(plain1, 10)
    bound1, by1 = bound_ms(
        launch_bytes(st0, a1, run1(), rows1.grid, rows1.scal), BATCH, V)

    a128 = torch.randint(0, 7, (128, BATCH), generator=g, device="cuda",
                         dtype=torch.int32)
    run128 = lambda: _fused_rollout_cuda(p, st0, a128, False, None, None)
    ms128 = device_ms(run128, 20)
    plain_ms128 = cuda_ms(
        lambda: fused_rollout_reference(p, st0, a128, False), 1)
    bound128, by128 = bound_ms(launch_bytes(st0, a128, run128()),
                               BATCH * 128, V)
    big = 65536
    _, st_big = env.reset(g, big)
    a_big = torch.randint(0, 7, (128, big), generator=g, device="cuda",
                          dtype=torch.int32)
    run_big = lambda: _fused_rollout_cuda(p, st_big, a_big, False, None,
                                          None)
    ms_big = device_ms(run_big, 5)
    plain_ms_big = cuda_ms(
        lambda: fused_rollout_reference(p, st_big, a_big, False), 1)
    bound_big, by_big = bound_ms(launch_bytes(st_big, a_big, run_big()),
                                 big * 128, V)
    del st_big, a_big
    groups = {f"t1_b{BATCH}": launch_geometry(BATCH, 8, 8, V, sms)
              .group_lanes,
              f"t128_b{BATCH}": launch_geometry(BATCH, 8, 8, V, sms)
              .group_lanes,
              f"t128_b{big}": launch_geometry(big, 8, 8, V, sms).group_lanes}
    print(f"kernel per launch, DoorKey-8x8, device time ({card}):")
    print(f"  B={BATCH} T=1 with reset row, G={groups[f't1_b{BATCH}']}: "
          f"{ms1 * 1e3:.2f} us (bound {bound1 * 1e3:.2f} us by {by1}, "
          f"plain version {plain_ms1 * 1e3:.1f} us; {call_ms1 * 1e3:.1f} "
          f"us per call back to back, host-bound)")
    print(f"  B={BATCH} T=128 pure, G={groups[f't128_b{BATCH}']}: "
          f"{ms128 * 1e3:.2f} us (bound {bound128 * 1e3:.2f} us by "
          f"{by128}, plain version {plain_ms128 * 1e3:.1f} us)")
    print(f"  B={big} T=128 pure, G={groups[f't128_b{big}']}: "
          f"{ms_big * 1e3:.2f} us (bound {bound_big * 1e3:.2f} us by "
          f"{by_big}, plain version {plain_ms_big * 1e3:.1f} us)")

    # the observe entry at B=4096 (the fresh and regen rollouts' shape)
    run_o = lambda: _fused_observe_cuda(p, st0)
    ms_o = device_ms(run_o, 200, kernel="fused_observe_kernel")
    plain_ms_o = cuda_ms(lambda: fused_observe_reference(p, st0), 10)
    bound_o, by_o = observe_bound_ms(st0, run_o(), V)
    print(f"  observe entry B={BATCH}, G={groups[f't1_b{BATCH}']}: "
          f"{ms_o * 1e3:.2f} us (bound {bound_o * 1e3:.2f} us by {by_o}, "
          f"{observe_bytes(st0, run_o()) / 1e6:.2f} MB; plain version "
          f"{plain_ms_o * 1e3:.1f} us)")

    # the other families' shapes at B=4096: 25x25, 16x8, see-through,
    # 22x22, 16x16; T=1 with a reset row where the family's pooled step
    # takes one, else without (the hook path)
    def shape_times(name, env_id, with_row, view=None):
        senv = mt.make(env_id, device="cuda").packed()
        if view is not None:
            senv = senv.replace_params(view_size=view)
        sg = senv.generator(SEED + 9)
        sp = senv.params
        _, s0 = senv.reset(sg, BATCH)
        row = senv.make_pool(sg, 16).rows(0)
        rg, rsc = (row.grid, row.scal) if with_row else (None, None)
        s1 = torch.randint(0, 7, (1, BATCH), generator=sg, device="cuda",
                           dtype=torch.int32)
        s128 = torch.randint(0, 7, (128, BATCH), generator=sg,
                             device="cuda", dtype=torch.int32)
        r1 = lambda: _fused_rollout_cuda(sp, s0, s1, False, rg, rsc)
        r128 = lambda: _fused_rollout_cuda(sp, s0, s128, False, None, None)
        ro = lambda: _fused_observe_cuda(sp, s0)
        sv = sp.view_size
        out = {"ms_t1": device_ms(r1, 100),
               "plain_ms_t1": cuda_ms(lambda: fused_rollout_reference(
                   sp, s0, s1, False, rg, rsc), 5),
               "ms_t128": device_ms(r128, 10),
               "plain_ms_t128": cuda_ms(lambda: fused_rollout_reference(
                   sp, s0, s128, False), 1),
               "observe_ms": device_ms(ro, 100,
                                       kernel="fused_observe_kernel"),
               "observe_plain_ms": cuda_ms(
                   lambda: fused_observe_reference(sp, s0), 5),
               "launch_geometry": dataclasses.asdict(launch_geometry(
                   BATCH, sp.width, sp.height, sv, sms))}
        out["bound_ms_t1"], out["bound_by_t1"] = bound_ms(
            launch_bytes(s0, s1, r1(), rg, rsc), BATCH, sv)
        out["bound_ms_t128"], out["bound_by_t128"] = bound_ms(
            launch_bytes(s0, s128, r128()), BATCH * 128, sv)
        out["observe_bound_ms"], out["observe_bound_by"] = observe_bound_ms(
            s0, ro(), sv)
        out["t1_reset_row"] = with_row
        print(f"  {name} ({sp.width}x{sp.height}, see_through_walls="
              f"{sp.see_through_walls}), B={BATCH}, "
              f"{geometry(BATCH, sp.width, sp.height, sv)}: T=1 "
              f"{'with' if with_row else 'without'} reset row "
              f"{out['ms_t1'] * 1e3:.2f} us (bound "
              f"{out['bound_ms_t1'] * 1e3:.2f} us, plain "
              f"{out['plain_ms_t1'] * 1e3:.1f} us); T=128 "
              f"{out['ms_t128'] * 1e3:.2f} us (bound "
              f"{out['bound_ms_t128'] * 1e3:.2f} us, plain "
              f"{out['plain_ms_t128'] * 1e3:.1f} us); observe "
              f"{out['observe_ms'] * 1e3:.2f} us (bound "
              f"{out['observe_bound_ms'] * 1e3:.2f} us, plain "
              f"{out['observe_plain_ms'] * 1e3:.1f} us)")
        return out

    shapes = {}
    for name, env_id, with_row in SHAPES:
        t0 = time.perf_counter()
        shapes[name] = shape_times(name, env_id, with_row)
        if env_id in WFC_IDS:
            wfc_secs["5 kernel times"] = time.perf_counter() - t0
    # the 64-bit view rows at B=4096: DoorKey-8x8 at V=33, MultiRoom-N6's
    # 25x25 at V=63
    wide_shapes = {name: shape_times(name, env_id, True, view)
                   for name, env_id, view in WIDE_SHAPES}

    # generation on the card at full width: one warm-up batch, then one
    # timed batch with the loop counters set to 0 before and read after
    def generation(env_id):
        genv = mt.make(env_id, device="cuda").packed()
        gg = genv.generator(SEED + 10)
        genv._gen_grid(gg, 256)
        torch.cuda.synchronize()
        RG.COUNTERS.reset()
        t0 = time.perf_counter()
        if isinstance(genv, RoomGridLevel):
            gst, ok, attempts = genv.generate(gg, BATCH)
        else:
            gst, ok, attempts = genv._gen_grid(gg, BATCH), None, None
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        c = RG.COUNTERS
        bi = torch.arange(BATCH, device="cuda")
        ap = gst.agent_pos.long()
        if not (gst.grid[bi, ap[:, 0], ap[:, 1], 0] == 1).all():
            raise AssertionError(f"{env_id}: an agent not on an empty cell")
        if not (gst.mission[:, 0] != 0).all():
            raise AssertionError(f"{env_id}: an empty mission")
        out = {"s_per_batch": secs, "host_syncs": c.host_syncs,
               "connect_draws_max": c.connect_draws_max,
               "attempts_max": c.attempts_max if ok is not None else None,
               "not_ok": int((~ok).sum()) if ok is not None else None}
        print(f"generation, {short(env_id)} B={BATCH} on the card: "
              f"{secs:.3f} s per batch, {c.host_syncs} counted host syncs, "
              f"connect_all draws at most {c.connect_draws_max}, attempts at "
              f"most {out['attempts_max']}, {out['not_ok']} levels not valid "
              f"(host clock; {card})")
        return out

    generated = {short(env_id): generation(env_id) for env_id in GENERATION}
    # WFC generation at full width, the support product's two operand
    # types, and the benchmark tool on one WFC ID
    t0 = time.perf_counter()
    wfc["generation"] = {}
    for env_id in WFC_GENERATION:
        r = wfc["generation"][short(env_id)] = wfc_generation(env_id, "cuda")
        print(f"generation, {short(env_id)} B={BATCH} on the card: "
              f"{r['s_per_batch']:.3f} s per batch, {r['host_syncs']} counted "
              f"host syncs, {r['ticks']} ticks; collapses at most "
              f"{r['collapses_max']}, passes at most {r['passes_max']}, "
              f"attempts at most {r['attempts_max']}, {r['not_ok']} not ok "
              f"(host clock; {card})")
    wfc["product"] = wfc_product_ms()
    pr = wfc["product"]
    print(f"WFC support product, ObstaclesAngular (P=42) B={BATCH} 23x23: "
          f"one pass {pr['pass_ms_bfloat16']:.3f} ms in bf16 (the solver's), "
          f"{pr['pass_ms_float32']:.3f} ms in f32; one product "
          f"{pr['product_ms_bfloat16']:.3f} / {pr['product_ms_float32']:.3f} "
          f"ms ({pr['product_flop'] / 1e9:.2f} GFLOP; CUDA events; {card})")
    zero_counts()
    wfc["benchmark"] = benchmark(WFC_IDS[0], num_resets=4, num_frames=200,
                                 batch=BATCH, chunk=ROLLOUT_LEN,
                                 device="cuda")
    wfc["benchmark"]["launches"] = KERNEL.launches
    print(f"benchmark, {short(WFC_IDS[0])}: {json.dumps(wfc['benchmark'])} "
          f"(host clock; {card})")
    wfc_secs["5 generation, product, benchmark"] = time.perf_counter() - t0
    wfc["script_s"] = wfc_secs
    print(f"the WFC additions on the script's clock: "
          f"{sum(wfc_secs.values()):.1f} s in all; "
          + ", ".join(f"{k} {v:.1f} s" for k, v in wfc_secs.items()))

    # rendering at full width: device time per call (every kernel the call
    # launches, profiler) beside the byte bound (the state read once, the
    # atlas read once, the frames written once, at the HBM rate)
    def render_time(variant, tile=8):
        kw = RENDER_VARIANTS[variant]
        fn = lambda: get_frame(p, render_states, tile_size=tile, **kw)
        out = fn()
        ms, kernels = device_ms_all(fn, 20)
        moved = (nbytes(render_states.grid, render_states.agent_pos,
                        render_states.agent_dir, render_states.carrying, out)
                 + get_atlas(tile).nbytes)
        res = {"ms": ms, "call_ms": cuda_ms(fn, 20),
               "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by":
               "bytes", "frame_mb": out.numel() / 1e6,
               "device_kernels": kernels}
        print(f"render, DoorKey-8x8 B={BATCH} {variant} tile {tile}: device "
              f"{ms * 1e3:.2f} us in {kernels:.0f} kernels (bound "
              f"{res['bound_ms'] * 1e3:.2f} us by bytes, "
              f"{res['frame_mb']:.1f} MB written; "
              f"{res['call_ms'] * 1e3:.1f} us per call back to back; {card})")
        return res

    render_times = {f"{v} tile {t}": render_time(v, t)
                    for t in (8, 32) for v in RENDER_VARIANTS}

    # wrapped stepping at full width (B=4096, T=128 pooled steps of random
    # actions, packed, staggered; JAX bench.py:400-417), beside the bare
    # DoorKey-8x8 pooled stepping: env-steps/s (host clock around a
    # synchronised pass after a warm-up), launches a step, and the device
    # kernels a step (profiled at the end)
    def wrapped_stepping(env_id, wrap):
        senv = mt.make(env_id, device="cuda").packed()
        w = senv if wrap is None else wrap(senv)
        sg = senv.generator(SEED + 13)
        spool = w.make_pool(sg, POOL_SIZE)
        _, sst = w.reset_staggered(sg, BATCH)
        rows = presample_reset_states(sg, spool, ROLLOUT_LEN)
        keys = random_keys(sg, (ROLLOUT_LEN, BATCH, 2), "cuda")
        acts = torch.randint(0, 7, (ROLLOUT_LEN, BATCH), generator=sg,
                             device="cuda", dtype=torch.int32)

        def run(s):
            for t in range(ROLLOUT_LEN):
                s = w.step_autoreset_presampled(keys[t], s, acts[t],
                                                rows.rows(t))[1]
            return s

        sst = run(sst)  # warm-up
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        sst = run(sst)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        per_step = (KERNEL.launches // ROLLOUT_LEN,
                    KERNEL.observe_launches // ROLLOUT_LEN)
        res = {"env_steps_per_s": BATCH * ROLLOUT_LEN / secs,
               "launches_per_step": per_step[0],
               "observe_launches_per_step": per_step[1],
               "wide_launches": KERNEL.wide_launches,
               "wide_observe_launches": KERNEL.wide_observe_launches}
        return res, lambda: cuda_events(lambda: run(sst))

    stepping, profile_stepping = {}, {}
    for key, env_id, wrap in (
            ("DoorKey-8x8 pooled", ENV_ID, None),
            ("ImgObs(DoorKey-8x8) pooled", ENV_ID, WR.ImgObsWrapper),
            ("NoDeath(LavaCrossingS9N2) pooled", LAVA_ID,
             lambda e: WR.NoDeath(e, no_death_types=("lava",))),
            # the 64-bit view rows on a user's path: an env made with a
            # 33-wide view (the step entry with the pooled row) and a
            # 63-wide ViewSizeWrapper (the observe entry after each step)
            ("DoorKey-8x8 view 33 pooled", ENV_ID,
             lambda e: e.replace_params(view_size=33)),
            ("ViewSize 63(DoorKey-8x8) pooled", ENV_ID,
             lambda e: WR.ViewSizeWrapper(e, 63))):
        stepping[key], profile_stepping[key] = wrapped_stepping(env_id, wrap)
        print(f"stepping, {key}: {stepping[key]['env_steps_per_s']:.0f} "
              f"env-steps/s (B={BATCH}, T={ROLLOUT_LEN}, random actions; "
              f"{stepping[key]['launches_per_step']} step + "
              f"{stepping[key]['observe_launches_per_step']} observe "
              f"launches a step, {stepping[key]['wide_launches']} + "
              f"{stepping[key]['wide_observe_launches']} of the 64-bit "
              f"rows; host clock; {card})")
    wide_main = (stepping["DoorKey-8x8 view 33 pooled"]["wide_launches"],
                 stepping["ViewSize 63(DoorKey-8x8) pooled"][
                     "wide_observe_launches"])
    if wide_main != (ROLLOUT_LEN, ROLLOUT_LEN):
        raise AssertionError(f"64-bit rows: (step, observe) launches "
                             f"{wide_main} on their paths, expected "
                             f"{ROLLOUT_LEN} each")

    # pure packed stepping: one T=128 launch per chunk, the state carried
    # from chunk to chunk (host clock around the synchronised chunks)
    env_state = st0
    chunks = 10
    acts = [torch.randint(0, 7, (128, BATCH), generator=g, device="cuda",
                          dtype=torch.int32) for _ in range(chunks)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for a in acts:
        env_state, o, *_ = _fused_rollout_cuda(p, env_state, a, False, None,
                                               None)
    torch.cuda.synchronize()
    pure_rate = chunks * 128 * BATCH / (time.perf_counter() - t0)
    print(f"pure packed stepping: {pure_rate:.0f} env-steps/s (B={BATCH}, "
          f"T=128 per launch; {card})")

    # device kernels per rollout step of each train step's rollout
    for key, later in profile_later.items():
        kernels, copies = later()
        train[key]["device_kernels_per_rollout_step"] = kernels / ROLLOUT_LEN
        train[key]["copies_per_rollout_step"] = copies / ROLLOUT_LEN
        print(f"rollout of the {key} train step under the profiler: "
              f"{kernels / ROLLOUT_LEN:.1f} device kernels + "
              f"{copies / ROLLOUT_LEN:.1f} copies per step ({card})")
    for key, later in profile_stepping.items():
        kernels, copies = later()
        stepping[key]["device_kernels_per_step"] = kernels / ROLLOUT_LEN
        stepping[key]["copies_per_step"] = copies / ROLLOUT_LEN
        print(f"stepping, {key} under the profiler: "
              f"{kernels / ROLLOUT_LEN:.1f} device kernels + "
              f"{copies / ROLLOUT_LEN:.1f} copies per step ({card})")
    del profile_later

    # --- 6. learning on the card ----------------------------------------
    def learn(env_id, updates, resets, packed, num_epochs=2, num_envs=128,
              ent_coef=0.01):
        """tests/test_learning.py::run_ppo's configuration on the card."""
        env = mt.make(env_id, device="cuda")
        if packed:
            env = env.packed()
        lcfg = PPOConfig(num_envs=num_envs, rollout_len=64,
                         num_epochs=num_epochs, num_minibatches=4, lr=1e-3,
                         ent_coef=ent_coef)
        g = env.generator(SEED)
        model = init_params(ActorCritic(hidden=64, device="cuda"), g)
        opt = make_optimizer(model, lcfg)
        reset = env.reset if resets == "regen" else env.reset_staggered
        obs, st = reset(g, num_envs)
        pool = env.make_pool(g, 256) if resets == "pooled" else None
        step = make_train_step(env, model, lcfg, opt, resets=resets)
        rewards = []
        t0 = time.perf_counter()
        for u in range(updates):
            st, obs, m = step(st, obs, g, pool)
            rewards.append(float(m["mean_reward"]))
            if pool is not None and u % 8 == 7:
                pool = env.make_pool(g, 256)
        return rewards, env, model, time.perf_counter() - t0

    for name, args, kw in (
            ("Empty-5x5 regen", ("regen", False), {}),
            ("Empty-5x5 pooled+packed", ("pooled", True), {}),
            ("Empty-5x5 fresh", ("fresh", True), {"num_epochs": 1})):
        r, *_, secs = learn("MiniGrid-Empty-5x5-v0", 30, *args, **kw)
        first, last = sum(r[:5]) / 5, sum(r[-5:]) / 5
        print(f"learning, {name}: mean reward first5 {first:.4f} -> last5 "
              f"{last:.4f} over 30 updates ({secs:.1f} s)")
        if not (last > 0.10 and last > 5 * max(first, 1e-4)):
            raise AssertionError(f"{name} did not learn: {r}")
    r, dk_env, dk_model, secs = learn("MiniGrid-DoorKey-5x5-v0", 120,
                                      "regen", False, num_envs=256,
                                      ent_coef=0.02)
    first, last = sum(r[:10]) / 10, sum(r[-10:]) / 10
    print(f"learning, DoorKey-5x5 regen B=256: mean reward first10 "
          f"{first:.4f} -> last10 {last:.4f} over 120 updates ({secs:.1f} s)")
    if not last > max(3 * first, 0.05):
        raise AssertionError(f"DoorKey-5x5 did not learn: {r}")
    rate = evaluate_success(dk_env, dk_model, 256, dk_env.generator(SEED + 7))
    print(f"  greedy success rate of the DoorKey-5x5 policy: {rate:.4f} "
          f"(256 fresh episodes)")

    # the JAX package's two wrapped learning guards on the card: an
    # ImgObsWrapper stack with a policy over the packed array (JAX
    # tests/test_learning.py:105) and NoDeath on LavaGapS5 (:270), pooled
    class ArrayPolicy(torch.nn.Module):
        """JAX tests/test_learning.py:105's ArrayPolicy: the packed view's
        one-hot features, two bf16 dense layers, f32 heads."""

        num_actions = 7

        def __init__(self, view_size, hidden=64):
            super().__init__()
            dev = "cuda"
            self.d1 = torch.nn.Linear(view_size ** 2 * 24, hidden,
                                      device=dev)
            self.d2 = torch.nn.Linear(hidden, hidden, device=dev)
            self.pi = torch.nn.Linear(hidden, 7, device=dev)
            self.v = torch.nn.Linear(hidden, 1, device=dev)
            with torch.no_grad():  # Flax's Dense initialisation
                for layer in (self.d1, self.d2, self.pi, self.v):
                    std = math.sqrt(1 / layer.in_features) / .87962566103423978
                    torch.nn.init.trunc_normal_(layer.weight, std=std,
                                                a=-2 * std, b=2 * std)
                    torch.nn.init.zeros_(layer.bias)

        def forward(self, arr):
            bf = torch.bfloat16
            x = encode_packed(arr, bf)
            x = torch.relu(torch.nn.functional.linear(
                x, self.d1.weight.to(bf), self.d1.bias.to(bf)))
            x = torch.relu(torch.nn.functional.linear(
                x, self.d2.weight.to(bf), self.d2.bias.to(bf)))
            x = x.float()
            return self.pi(x), self.v(x).squeeze(-1)

    def learn_wrapped(env, model, updates=30):
        lcfg = PPOConfig(num_envs=128, rollout_len=64, num_epochs=2,
                         num_minibatches=4, lr=1e-3)
        g = env.generator(SEED)
        opt = make_optimizer(model, lcfg)
        obs, st = env.reset_staggered(g, lcfg.num_envs)
        pool = env.make_pool(g, 256)
        step = make_train_step(env, model, lcfg, opt, resets="pooled")
        rewards = []
        t0 = time.perf_counter()
        for _ in range(updates):
            st, obs, m = step(st, obs, g, pool)
            rewards.append(float(m["mean_reward"]))
        return rewards, time.perf_counter() - t0

    torch.manual_seed(SEED)
    img_env = WR.ImgObsWrapper(mt.make("MiniGrid-Empty-5x5-v0",
                                      device="cuda").packed())
    r, secs = learn_wrapped(img_env, ArrayPolicy(img_env.params.view_size))
    first, last = sum(r[:5]) / 5, sum(r[-5:]) / 5
    print(f"learning, ImgObs(Empty-5x5) pooled, array policy: mean reward "
          f"first5 {first:.4f} -> last5 {last:.4f} over 30 updates "
          f"({secs:.1f} s)")
    if not (last > 0.10 and last > 5 * max(first, 1e-4)):
        raise AssertionError(f"ImgObs pooled did not learn: {r}")
    lava_env = WR.NoDeath(mt.make("MiniGrid-LavaGapS5-v0",
                                 device="cuda").packed(),
                         no_death_types=("lava",), death_cost=-0.2)
    r, secs = learn_wrapped(lava_env, init_params(ActorCritic(
        hidden=64, device="cuda"), lava_env.generator(SEED + 1)))
    first, last = sum(r[:5]) / 5, sum(r[-5:]) / 5
    print(f"learning, NoDeath(LavaGapS5) pooled: mean reward first5 "
          f"{first:.4f} -> last5 {last:.4f} over 30 updates ({secs:.1f} s)")
    if not (last > 0.02 and last > first + 0.02):
        raise AssertionError(f"NoDeath pooled did not learn: {r}")

    # the recurrent guard of JAX tests/test_learning.py:194-222: Empty-5x5
    # packed, fresh resets, ActorCriticRNN(hidden=64) bf16, B=128, T=64,
    # lr 1e-3, 30 train steps
    renv = mt.make("MiniGrid-Empty-5x5-v0", device="cuda").packed()
    rcfg = PPOConfig(num_envs=128, rollout_len=64, lr=1e-3)
    rg = renv.generator(SEED)
    rmodel = init_params_rnn(ActorCriticRNN(hidden=64, device="cuda"), rg)
    ropt = make_optimizer(rmodel, rcfg)
    obs, st = renv.reset_staggered(rg, rcfg.num_envs)
    h = rmodel.initial_state(rcfg.num_envs)
    rstep = make_train_step(renv, rmodel, rcfg, ropt, resets="fresh")
    r = []
    t0 = time.perf_counter()
    for _ in range(30):
        st, obs, h, m = rstep(st, obs, h, rg)
        r.append(float(m["mean_reward"]))
    first, last = sum(r[:5]) / 5, sum(r[-5:]) / 5
    print(f"learning, Empty-5x5 fresh, ActorCriticRNN(hidden=64): mean "
          f"reward first5 {first:.4f} -> last5 {last:.4f} over 30 updates "
          f"({time.perf_counter() - t0:.1f} s)")
    if not (last > 0.10 and last > 5 * max(first, 1e-4)):
        raise AssertionError(f"the recurrent policy did not learn: {r}")

    # the imitation pipeline of JAX tests/test_learning.py:252-272: 300 bot
    # demos of GoToRedBallGrey generated on the card (64 seeds a batch),
    # behaviour cloning of ActorCritic(hidden=128) for 60 epochs at batch
    # 256, then the greedy success rate on 256 fresh episodes with the
    # eval's cap derived from their budgets (no max_steps)
    ienv = mt.make("BabyAI-GoToRedBallGrey-v0", device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reset_seeds(ienv, range(16))  # each seed's layout from its own generator
    torch.cuda.synchronize()
    seed_reset_s = (time.perf_counter() - t0) / 16
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    demos = generate_demos(ienv, 300)
    demo_s = time.perf_counter() - t0
    demo_launches = (KERNEL.launches, KERNEL.observe_launches)
    ig = ienv.generator(SEED)
    bc_model = init_params(ActorCritic(hidden=128, device="cuda"), ig)
    t0 = time.perf_counter()
    hist = behavior_clone(bc_model, demos, epochs=60, batch_size=256,
                          generator=ig)
    bc_s = time.perf_counter() - t0
    eg = ienv.generator(SEED + 8)
    eobs, est = ienv.reset(clone_generator(eg), 256)
    cap = episode_budget(ienv, est)
    rate = evaluate_success(ienv, bc_model, n_episodes=256, generator=eg)
    print(f"imitation, GoToRedBallGrey: {len(demos.length)} demos "
          f"({int(demos.length.sum())} steps, seeds up to "
          f"{int(demos.seed.max())}) generated on the "
          f"card in {demo_s:.2f} s ({seed_reset_s * 1e3:.1f} ms a seed's "
          f"B=1 reset; {demo_launches[0]} step + "
          f"{demo_launches[1]} observe launches); behaviour cloning 60 "
          f"epochs in {bc_s:.1f} s: loss {hist[0]['loss']:.4f} -> "
          f"{hist[-1]['loss']:.4f}, accuracy {hist[-1]['accuracy']:.4f}; "
          f"greedy success {rate:.4f} on 256 episodes, the eval's cap "
          f"{cap} steps derived from their budgets (host clock; {card})")
    if not hist[-1]["accuracy"] > 0.9:
        raise AssertionError(f"behaviour cloning accuracy {hist[-1]}")
    if not rate > 0.5:
        raise AssertionError(f"the cloned policy's success rate {rate}")
    if not cap < 1 << 16:
        raise AssertionError(f"the eval's cap {cap} was not derived")

    main_steps = sum(t["launches"] for t in train.values())
    main_observes = sum(t["observe_launches"] for t in train.values())
    kernels = [{
        "name": "fused_step",
        "route": "cuda",
        "source": "minigrid_tpu_torch/csrc/fused_step.cu",
        "replaces": "minigrid_tpu/ops/fused_step.py:58",
        "launches": main_steps,
        "launches_per_train_step": {k: t["launches_per_step"]
                                    for k, t in train.items()},
        "launches_pooled_rollout": launches,
        # the bot's batches and the demos' (the hook path, one a step)
        "launches_bot": {short(k): v["launches"][0]
                         for k, v in bot_runs.items()},
        "launches_demos": demo_launches[0],
        # 32 pooled steps of a WFC ID (the step entry with the row)
        "launches_wfc_stepping": wfc_launched[0],
        # the launch sites this slice added: a wrapper stack's step and
        # pooled stepping at full width, and the wrapper replays
        "launches_per_wrapped_step": {
            k: t["launches_per_step"] for k, t in stepping.items()}
        | {f"{k} (B=256 replay)": w["launches_per_step"][0]
           for k, w in wrappers.items()},
        "max_abs_err": max_err,
        "ms": ms1,
        "plain_ms": plain_ms1,
        "bound_ms": bound1,
        "bound_by": by1,
        "library_ms": None,
        "call_ms": call_ms1,
        "ms_t128": ms128,
        "plain_ms_t128": plain_ms128,
        "bound_ms_t128": bound128,
        "ms_t128_b65536": ms_big,
        "bound_ms_t128_b65536": bound_big,
        "plain_ms_t128_b65536": plain_ms_big,
        "group_lanes": groups,
        "shapes": {k: {kk: vv for kk, vv in v.items()
                       if not kk.startswith("observe")}
                   for k, v in shapes.items()},
    }, {
        "name": "fused_step_observe",
        "route": "cuda",
        "source": "minigrid_tpu_torch/csrc/fused_step.cu",
        "replaces": "minigrid_tpu/ops/fused_step.py:144",
        "launches": main_observes,
        "launches_per_train_step": {k: t["observe_launches_per_step"]
                                    for k, t in train.items()},
        "launches_per_wrapped_step": {
            k: t["observe_launches_per_step"] for k, t in stepping.items()}
        | {f"{k} (B=256 replay)": w["launches_per_step"][1]
           for k, w in wrappers.items()},
        "launches_per_frame": frame_launches,
        "launches_bot": {short(k): v["launches"][1]
                         for k, v in bot_runs.items()},
        "launches_demos": demo_launches[1],
        "max_abs_err": observe_err,
        "ms": ms_o,
        "plain_ms": plain_ms_o,
        "bound_ms": bound_o,
        "bound_by": by_o,
        "library_ms": None,
        "shapes": {k: {"ms": v["observe_ms"],
                       "plain_ms": v["observe_plain_ms"],
                       "bound_ms": v["observe_bound_ms"],
                       "bound_by": v["observe_bound_by"],
                       "launch_geometry": v["launch_geometry"]}
                   for k, v in shapes.items()},
    }]
    # the 64-bit-row family (views 33-63): launches on its paths (an env of
    # view 33 pooled, a ViewSizeWrapper of 63), times at DoorKey-8x8 view 33
    # and at MultiRoom-N6's 25x25 view 63
    dk33 = wide_shapes["DoorKey-8x8 view 33"]
    kernels += [{
        "name": "fused_step (64-bit view rows)",
        "route": "cuda",
        "source": "minigrid_tpu_torch/csrc/fused_step.cu",
        "replaces": "minigrid_tpu/ops/fused_step.py:58",
        "launches": wide_main[0],
        "max_abs_err": wide_err,
        "ms": dk33["ms_t1"],
        "plain_ms": dk33["plain_ms_t1"],
        "bound_ms": dk33["bound_ms_t1"],
        "bound_by": dk33["bound_by_t1"],
        "library_ms": None,
        "shapes": {k: {kk: vv for kk, vv in v.items()
                       if not kk.startswith("observe")}
                   for k, v in wide_shapes.items()},
    }, {
        "name": "fused_step_observe (64-bit view rows)",
        "route": "cuda",
        "source": "minigrid_tpu_torch/csrc/fused_step.cu",
        "replaces": "minigrid_tpu/ops/fused_step.py:144",
        "launches": wide_main[1],
        "max_abs_err": wide_observe_err,
        "ms": dk33["observe_ms"],
        "plain_ms": dk33["observe_plain_ms"],
        "bound_ms": dk33["observe_bound_ms"],
        "bound_by": dk33["observe_bound_by"],
        "library_ms": None,
        "shapes": {k: {"ms": v["observe_ms"],
                       "plain_ms": v["observe_plain_ms"],
                       "bound_ms": v["observe_bound_ms"],
                       "bound_by": v["observe_bound_by"],
                       "launch_geometry": v["launch_geometry"]}
                   for k, v in wide_shapes.items()},
    }]
    print(json.dumps({"train_step": {k: {kk: vv for kk, vv in t.items()
                                         if kk != "metrics"}
                                     for k, t in train.items()},
                      "update_max_abs_err": update_err,
                      "rnn_update_max_abs_err": rnn_update_err,
                      "bot": bot_runs,
                      "generation": generated, "render": render_times,
                      "wrapped_stepping": stepping,
                      "wrappers": wrappers, "wfc": wfc}))
    print(f"chip_smoke: {time.perf_counter() - script_t0:.1f} s from the "
          f"import of torch to the result")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
