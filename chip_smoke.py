#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``minigrid_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. the card (name, power limit) and the kernel build (ptxas report);
2. the fused step kernel against its plain PyTorch version on the card,
   bit-exact on every output, for every case below (another view size and
   every group width G among them); then its observe entry against plain
   ``gen_obs`` on states taken after interaction steps, bit-exact (views 3,
   7 and 9, every G on 8x8 and on 25x25 with ragged batches, 25x25 and
   22x22 at full width, see-through walls at view 33); then
   both entries on states of each of the 14 other families (B=1024, T=32,
   the interaction stream; MultiRoom's 25x25, RedBlueDoors' 16x8 and the
   see-through families among them), the step entry with and without a
   reset row; then both entries on states of Unlock, KeyCorridorS6R3,
   ObstructedMaze-Full (16x16), BabyAI-GoToObj and BabyAI-BossLevel (22x22)
   with the uniform and the interaction streams, the step entry without a
   row (their hook path); then the 64-bit view rows: both entries at views
   33 and 63 on DoorKey-8x8 and MultiRoom-N6 (25x25), B=1024, at every
   group width that fits;
2b. the BabyAI post-step kernel (``csrc/babyai_post_step.cu``) against its
   plain version on the same card inputs, bit for bit in both done-action
   modes, 32 steps of PutNextLocal and of BossLevel (22x22) at B=4096, its
   launches counted (``post_step_phase``); its device time, byte bound,
   host cost a call and plain time at the end of phase 5;
2c. the fresh select kernel (``csrc/fresh_select.cu``) against its plain
   version (``fresh_candidates`` then ``select_reset_states``) on the same
   card inputs, bit for bit, 16 steps of DoorKey-8x8 and of BossLevel
   (22x22, 28 tensors) at B=4096, its launches counted
   (``select_phase``); its device time, byte bound, host cost a call and
   plain time at the end of phase 5;
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
4b. the package surface: the names of the six packages' ``__all__``
   resolve (the JAX package's lists), then ``env.vector(4096)`` on the
   card: DoorKey-8x8 for 128 steps, BabyAI-GoToObj (a hook env) and
   ActionBonus(DoorKey-8x8) (a stack's own pair) for 32, uniform actions,
   the regen layouts drawn on the card and given to the step, each
   (step, observe) launch count (T, T), and each run replayed on the CPU
   from the same layouts, keys and actions, bit for bit; the DoorKey-8x8
   rate beside phase 4's regen rollout;
5. timings: the rollout, pure packed stepping, and the kernel's device
   time per launch (profiler) at T=1 and T=128 for B=4096 and at T=128 for
   B=65536, with the group width G chosen for each, and the observe
   entry's at B=4096, beside their bounds (the larger of the byte and the
   integer-operation bound; the observe entry's from the bytes its
   windows need, beside the bound had it read whole grids, and the time of
   ``zero_()`` on its output, the launch floor) and the plain versions'
   times (CUDA events);
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
   with the eval's cap derived from the episodes' budgets;
7. the multi-device layer (``parallel/``) on the one card: 2 ranks sharing
   it over gloo, each rolling out its 2048 envs of a pooled, a regen and a
   fresh DoorKey-8x8 rollout (B=4096, T=128, uniform actions; in the regen
   and fresh ones the first rank's envs all finish) bit-exact against its
   rows of the one-process rollout, with no collective call but the fresh
   routing's one a step (its time measured apart), the launches and host
   ms of each mode by rank; one update of
   ActorCritic(256) in f32 and bf16 on a fixed trajectory over the 2 ranks
   against one process (the ranks' parameters bit-equal; f32 within 1e-5,
   bf16 by the update's relative error, which a known-wrong control must
   fail), with the gradient all-reduce's time; the distributed train step
   on the 2 ranks (its launches) and how many actions of a policy-driven
   rollout differ; ``train(devices=2)`` for 3 updates beside one process
   (ranks sharing a card: no scaling number); the train step in a world
   of one rank over NCCL, bit-equal to gloo, against the step without a
   mesh in f32 and bf16 (on 2 cards also the update and ``train`` over
   NCCL); ``dryrun_multichip`` on (2, 1) and (2, 2) meshes, its metrics
   equal on every rank, and on the (2, 2) mesh the regen and fresh
   rollouts (B=1024, T=32) bit-exact against the data ranks' rows of one
   process (phase 5 times the kernel at a rank's B=2048).

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
          ("WFC-MazeSimple 25x25", "MiniGrid-WFC-MazeSimple-v0", True),
          # grids of W*H*5 bytes that are no multiple of 16: JAX bench.py's
          # FourRooms and LavaCrossingS9N2, the learning guard's Empty-5x5
          ("FourRooms 19x19", "MiniGrid-FourRooms-v0", True),
          ("LavaCrossingS9N2 9x9", "MiniGrid-LavaCrossingS9N2-v0", True),
          ("Empty-5x5", "MiniGrid-Empty-5x5-v0", True)]
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


def zero_ms(out, reps: int) -> float:
    """Device time of ``out.zero_()``, one fill kernel: the floor of a
    launch that writes ``out`` (``device_ms`` over every device kernel of
    the calls, with its retries for dropped records)."""
    return device_ms(out.zero_, reps, kernel="")


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


def observe_window_bytes(states, view_size: int) -> int:
    """Bytes the observe entry needs for these states: per env the in-grid
    cells of its V x V window (5 bytes each; the window is V consecutive
    grid columns by V rows, placed by the env's position and direction),
    its 17 bytes of scalars (position, direction, carried cell) and the
    4 V^2 bytes of the view it writes."""
    V = view_size
    B, W, H = states.grid.shape[:3]
    d = states.agent_dir.long()
    pos = states.agent_pos.long()
    ofx = (d == 0).long() - (d == 2).long()
    ofy = (d == 1).long() - (d == 3).long()
    orx, ory = -ofy, ofx
    # view cell (vx, vy) is world (tlx + orx*vx - ofx*vy, tly + ory*vx -
    # ofy*vy): the window's first column and row
    x0 = (pos[:, 0] + ofx * (V - 1) - orx * (V // 2)
          + (orx.clamp(max=0) + (-ofx).clamp(max=0)) * (V - 1))
    y0 = (pos[:, 1] + ofy * (V - 1) - ory * (V // 2)
          + (ory.clamp(max=0) + (-ofy).clamp(max=0)) * (V - 1))
    nx = ((x0 + V).clamp(max=W) - x0.clamp(min=0)).clamp(min=0)
    ny = ((y0 + V).clamp(max=H) - y0.clamp(min=0)).clamp(min=0)
    return 5 * int((nx * ny).sum()) + B * (17 + 4 * V * V)


def observe_window_bound_ms(states, view_size: int):
    """The observe entry's bound from what these states need: the window
    bytes (``observe_window_bytes``) over the HBM rate, or the operations
    of ``observe_bound_ms``, whichever is larger."""
    by_bytes = (observe_window_bytes(states, view_size) / HBM_BYTES_PER_S
                * 1e3)
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
    from minigrid_tpu_torch.ops.native import COUNTERS

    for field in dataclasses.fields(COUNTERS):
        setattr(COUNTERS, field.name, 0)


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
    from minigrid_tpu_torch.ops.native import COUNTERS

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
    return n_done, (COUNTERS.launches, COUNTERS.observe_launches)


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


# --- phase 2b: the BabyAI post-step kernel ----------------------------------
# csrc/babyai_post_step.cu against its plain version on the same card inputs,
# bit for bit in both done-action modes, at B=4096 on PutNextLocal (8x8, the
# benchmark's train_fresh level) and BossLevel (22x22, the tallest masks),
# its launches counted; its device time, byte bound, host cost a call and
# plain time measured at the end of phase 5, after the fused kernel's
# profiled timings (profiler sessions before those have cost them records)
POST_STEP_LEVELS = ("BabyAI-PutNextLocal-v0", "BabyAI-BossLevel-v0")
POST_STEP_T = 32  # steps a level is checked over, each in both modes


def post_step_bytes(B: int, H: int) -> int:
    """Bytes one launch of the post-step kernel has to move: each input read
    once and each output written once. In: the two (8, H) int32 mask arrays,
    per state the position, direction and carried object and the one grid
    cell in front (5 bytes), the step count, the action, the InstrState's
    other fields (root 4, two flags 2, kinds 16, strict 4, carried 8, memory
    4 x 4, two flags 2), the budget, the reward and terminated. Out: the two
    mask arrays, status, reward and the 28 flag bytes."""
    state = 8 + 4 + 5 + 5
    scalars_in = 2 * state + 4 + 4 + (4 + 2 + 16 + 4 + 8 + 16 + 2) + 4 + 4 + 1
    masks = 2 * 8 * H * 4
    return B * (masks + scalars_in + masks + 4 + 4 + 28)


def host_us(fn, reps: int = 200, rounds: int = 5) -> float:
    """Host microseconds a call of ``fn`` (``time.perf_counter`` over
    ``reps`` calls, the device synchronised before and after; the best of
    ``rounds``): what the host spends, the device's time hidden under it."""
    import torch

    fn()
    best = math.inf
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        best = min(best, time.perf_counter() - t0)
        torch.cuda.synchronize()
    return 1e6 * best / reps


def post_step_case(env_id: str, B: int = BATCH, T: int = POST_STEP_T):
    """``T`` steps of ``env_id`` at ``B``: the core transition by the step
    entry, then the post-step by the kernel and by its plain version on the
    same inputs in both done-action modes, every output equal (the reward by
    its bits), the inputs unchanged, one launch a kernel call; the batch
    goes on from the kernel's outputs. Returns (the case's counts, a
    function that times the kernel on the last step's inputs)."""
    import torch

    import minigrid_tpu_torch as mt
    from minigrid_tpu_torch.envs.babyai.core import post_step as PS
    from minigrid_tpu_torch.ops.fused_step import fused_rollout
    from minigrid_tpu_torch.ops.native import COUNTERS

    env = mt.make(env_id, device="cuda").packed()
    g = env.generator(SEED + 17)
    _, st = env.reset(g, B)
    ms = st.extra["max_steps"]
    st = st.replace(step_count=(ms - 1 - torch.arange(
        B, device="cuda") % (2 * T)).clamp(min=0).to(torch.int32))
    # every action, interactions twice as often as turns and moves
    choice = torch.tensor([0, 1, 2, 3, 3, 4, 4, 5, 5, 6, 6], device="cuda")
    ended = {False: 0, True: 0}
    truncated = calls = 0
    zero_counts()
    for t in range(T):
        a = choice[torch.randint(0, len(choice), (B,), generator=g,
                                 device="cuda")].to(torch.int32)
        new, _, reward, term, _ = fused_rollout(env.params, st, a[None])
        args = (env.params, st, new, a, reward[0], term[0])
        inputs = PS._inputs(*args[1:])
        before = [x.clone() for x in inputs]
        for mode in (True, False):
            got = PS._babyai_post_step_cuda(*args, mode)
            calls += 1
            want = PS.babyai_post_step_reference(*args, mode)
            where = f"{short(env_id)} post-step {t}, done actions {mode}"
            assert_same(f"{where} status", got[0], want[0])
            assert_same(f"{where} reward bits", got[2].view(torch.int32),
                        want[2].view(torch.int32))
            assert_same(f"{where} terminated", got[3], want[3])
            assert_same(f"{where} truncated", got[4], want[4])
            assert_same(f"{where} instr",
                        {k: got[1].get(k, st.extra[k]) for k in want[1]},
                        want[1])
            ended[mode] += int((got[0] != 0).sum())
        for (name, _, _), x, y in zip(
                PS._specs(B, env.params.width, env.params.height), inputs,
                before):
            assert_same(f"{short(env_id)} post-step {t} input {name}", x, y)
        _, instr, _, te, tr = got
        truncated += int(tr.sum())
        st = new.replace(terminated=te, truncated=tr,
                         extra={**new.extra, **instr})
    torch.cuda.synchronize()
    if COUNTERS.verify_launches != calls:
        raise AssertionError(f"{env_id}: {COUNTERS.verify_launches} "
                             f"post-step launches over {calls} calls")
    # (a put-next seldom succeeds by chance: the default mode may end none)
    if not (ended[True] and truncated):
        raise AssertionError(f"{env_id}: ended {ended}, {truncated} "
                             f"truncated: the case tests too little")
    H = env.params.height
    moved = post_step_bytes(B, H)
    args = (*args, False)
    level_args = args[1:6]

    def times() -> dict:
        return {
            "ms": device_ms(lambda: PS._babyai_post_step_cuda(*args), 200,
                            kernel="babyai_post_step_kernel"),
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "bytes": moved,
            "plain_ms": cuda_ms(
                lambda: PS.babyai_post_step_reference(*args), 20),
            "wrapper_host_us": host_us(
                lambda: PS._babyai_post_step_cuda(*args)),
            "post_step_host_us": host_us(
                lambda: env._post_step(*level_args)),
        }

    return {"B": B, "H": H, "steps": T, "launches": calls,
            "not_continue": ended, "truncated": truncated}, times


def post_step_phase(card: str):
    """The post-step kernel's check on every level of
    :data:`POST_STEP_LEVELS`, printed; returns a function that times it on
    each and returns its ``kernels`` entry."""
    from minigrid_tpu_torch.envs.babyai.core import post_step as PS

    t0 = time.perf_counter()
    PS.LIBRARY.load()
    print(f"post-step kernel built in {time.perf_counter() - t0:.2f} s")
    for line in PS.LIBRARY.build_log.splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print("  " + line.strip())
    shapes, timers = {}, {}
    for env_id in POST_STEP_LEVELS:
        case, timers[short(env_id)] = post_step_case(env_id)
        shapes[short(env_id)] = case
        print(f"post-step kernel, {short(env_id)} B={case['B']} "
              f"H={case['H']}: {case['launches']} launches over "
              f"{case['steps']} steps in both done-action modes == plain "
              f"bit for bit (statuses other than continue "
              f"{case['not_continue']}, {case['truncated']} "
              f"truncated)")

    def times() -> dict:
        for name, case in shapes.items():
            case.update(timers[name]())
            print(f"post-step kernel, {name} B={case['B']}: "
                  f"{1e3 * case['ms']:.2f} us a launch against a "
                  f"{1e3 * case['bound_ms']:.2f} us byte bound, plain "
                  f"{case['plain_ms']:.3f} ms; host "
                  f"{case['wrapper_host_us']:.1f} us a wrapper call, "
                  f"{case['post_step_host_us']:.1f} us a _post_step "
                  f"({card})")
        first = shapes[short(POST_STEP_LEVELS[0])]
        return {
            "name": "babyai_post_step",
            "route": "cuda",
            "source": "minigrid_tpu_torch/csrc/babyai_post_step.cu",
            # the JAX package's verifier is jnp under jit: no Pallas kernel
            "replaces": None,
            "launches": sum(c["launches"] for c in shapes.values()),
            "max_abs_err": 0.0,
            "ms": first["ms"],
            "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"],
            "library_ms": None,
            "host_us": first["wrapper_host_us"],
            "shapes": shapes,
        }

    return times


# --- phase 2c: the fresh select kernel ---------------------------------------
# csrc/fresh_select.cu against its plain version on the same card inputs, bit
# for bit, at B=4096 on DoorKey-8x8 (the benchmark's fresh DoorKey cell, 9
# tensors) and BossLevel (28 tensors, 22x22), its launches counted; its device
# time, byte bound, host cost a call and plain time measured at the end of
# phase 5, as the post-step's are
SELECT_ENVS = ("MiniGrid-DoorKey-8x8-v0", "BabyAI-BossLevel-v0")
SELECT_T = 16  # steps a state is checked over


def select_bytes(state, done) -> int:
    """Bytes one launch of the select kernel has to move: the stepped
    state read once and the selected state written once, and for each
    finished env its buffer row (its rng from its step key); the done
    flags."""
    from minigrid_tpu_torch.ops import fresh_select as FS

    row = sum(f.row_bytes for f in FS.field_table(state))
    B = state.batch_size
    return 2 * B * row + int(done.sum()) * row + B


def select_case(env_id: str, B: int = BATCH, T: int = SELECT_T):
    """``T`` steps of ``env_id`` at ``B`` (staggered below the episode
    budget, so that envs finish every step): the transition by the hook
    path, then the fresh select by the kernel and by its plain version on
    the same inputs, every tensor, the overflow and the cursor equal, the
    inputs unchanged, one launch a call; the batch goes on from the
    kernel's state. Returns (the case's counts, a function that times the
    kernel on the last step's inputs)."""
    import torch

    import minigrid_tpu_torch as mt
    from minigrid_tpu_torch.envs import base as EB
    from minigrid_tpu_torch.envs.base import random_keys
    from minigrid_tpu_torch.ops import fresh_select as FS
    from minigrid_tpu_torch.ops.native import COUNTERS

    env = mt.make(env_id, device="cuda").packed()
    g = env.generator(SEED + 19)
    _, st = env.reset(g, B)
    ms = (st.extra["max_steps"] if st.extra is not None
          else env.params.max_steps)
    st = st.replace(step_count=(ms - 1 - torch.arange(
        B, device="cuda") % (2 * T)).clamp(min=0).to(torch.int32))
    n_buf, window = B // 2 + 256, 2 * B // (2 * T)
    buffer = env.presample_fresh(g, n_buf)
    cursor = torch.zeros((), dtype=torch.int32, device="cuda")
    finished = overflow = 0
    zero_counts()
    for t in range(T):
        keys = random_keys(g, (B, 2), "cuda")
        a = torch.randint(0, 7, (B,), generator=g, device="cuda",
                          dtype=torch.int32)
        new, _, _, term, trunc = EB.hooked_step(env, keys, st, a)
        done = term | trunc
        args = (keys, done, new, buffer, cursor, window, None,
                EB._SALT_WORDS)
        inputs = [keys, done, cursor, *new.tensors().values()]
        before = [x.clone() for x in inputs]
        got, got_overflow, got_cursor = FS.fresh_select_cuda(*args)
        cand, want_overflow, want_cursor = EB.fresh_candidates(
            keys, done, buffer, cursor, window)
        want = EB.select_reset_states(done, new, cand)
        where = f"{short(env_id)} select {t}"
        assert_same(f"{where} state", got.tensors(), want.tensors())
        assert_same(f"{where} reset_overflow", got_overflow, want_overflow)
        assert_same(f"{where} cursor", got_cursor, want_cursor)
        assert_same(f"{where} inputs", dict(enumerate(inputs)),
                    dict(enumerate(before)))
        finished += int(done.sum())
        overflow += int(got_overflow)
        st, cursor = got, got_cursor
    torch.cuda.synchronize()
    if COUNTERS.select_launches != T:
        raise AssertionError(f"{env_id}: {COUNTERS.select_launches} select "
                             f"launches over {T} calls")
    if finished < B // 4:
        raise AssertionError(f"{env_id}: {finished} envs finished in {T} "
                             "steps: the case tests too little")
    moved = select_bytes(new, done)

    def plain():
        cand, overflow, cursor = EB.fresh_candidates(*args[:2], *args[3:6])
        return EB.select_reset_states(done, new, cand), overflow, cursor

    def times() -> dict:
        return {
            "ms": device_ms(lambda: FS.fresh_select_cuda(*args), 200,
                            kernel="fresh_select_kernel"),
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "bytes": moved,
            "plain_ms": cuda_ms(plain, 20),
            "wrapper_host_us": host_us(lambda: FS.fresh_select_cuda(*args)),
            "plain_host_us": host_us(plain, reps=20),
        }

    return {"B": B, "tensors": len(new.tensors()), "steps": T,
            "launches": T, "finished": finished, "n_buf": n_buf,
            "window": window, "cursor": int(cursor),
            "reset_overflow": overflow}, times


def select_phase(card: str):
    """The select kernel's check on each env of :data:`SELECT_ENVS`,
    printed; returns a function that times it on each and returns its
    ``kernels`` entry."""
    from minigrid_tpu_torch.ops import fresh_select as FS

    t0 = time.perf_counter()
    FS.LIBRARY.load()
    print(f"select kernel built in {time.perf_counter() - t0:.2f} s")
    for line in FS.LIBRARY.build_log.splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print("  " + line.strip())
    shapes, timers = {}, {}
    for env_id in SELECT_ENVS:
        case, timers[short(env_id)] = select_case(env_id)
        shapes[short(env_id)] = case
        print(f"select kernel, {short(env_id)} B={case['B']} "
              f"({case['tensors']} tensors): {case['launches']} launches "
              f"over {case['steps']} steps == plain bit for bit "
              f"({case['finished']} finished, buffer {case['n_buf']} rows, "
              f"window {case['window']}, cursor {case['cursor']}, overflow "
              f"{case['reset_overflow']})")

    def times() -> dict:
        for name, case in shapes.items():
            case.update(timers[name]())
            print(f"select kernel, {name} B={case['B']}: "
                  f"{1e3 * case['ms']:.2f} us a launch against a "
                  f"{1e3 * case['bound_ms']:.2f} us byte bound, plain "
                  f"{case['plain_ms']:.3f} ms; host "
                  f"{case['wrapper_host_us']:.1f} us a wrapper call, "
                  f"{case['plain_host_us']:.1f} us a plain call ({card})")
        first = shapes[short(SELECT_ENVS[0])]
        return {
            "name": "fresh_select",
            "route": "cuda",
            "source": "minigrid_tpu_torch/csrc/fresh_select.cu",
            # the JAX package's fresh select is jnp under jit: no Pallas
            # kernel
            "replaces": None,
            "launches": sum(c["launches"] for c in shapes.values()),
            "max_abs_err": 0.0,
            "ms": first["ms"],
            "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"],
            "library_ms": None,
            "host_us": first["wrapper_host_us"],
            "shapes": shapes,
        }

    return times


# --- phase 4b: the package surface -------------------------------------------
# the JAX package's public names on the port, and ``vector(n)`` at full width:
# (env id, wrapper or None, steps); each batch's step counts are set 1 to
# ``steps`` short of its episode budget, so every env resets in the run
SURFACE_CASES = [(ENV_ID, None, ROLLOUT_LEN), ("BabyAI-GoToObj-v0", None, 32),
                 (ENV_ID, "ActionBonus", 32)]


def surface_vector_run(env_id, wrapper, T, B=BATCH):
    """``reset, step = env.vector(B)`` on the card, T steps of uniform
    actions with the regen layouts drawn on the card and given to ``step``,
    launches counted from 0 just before the steps and read just after;
    then the same layouts, keys and actions replayed on the CPU through the
    CPU env's ``vector(B)``: observations, states, rewards and flags bit
    for bit. Returns the run's numbers."""
    import torch

    import minigrid_tpu_torch as mt
    from minigrid_tpu_torch import wrappers as WR
    from minigrid_tpu_torch.envs.base import random_keys
    from minigrid_tpu_torch.ops.native import COUNTERS

    def stack(device):
        env = mt.make(env_id, device=device).packed()
        return env, (env if wrapper is None else getattr(WR, wrapper)(env))

    base, env = stack("cuda")
    cpu_base, cpu_env = stack("cpu")
    reset, step = env.vector(B)
    g = base.generator(SEED + 11)
    obs, st = reset(g)
    want_shapes = {k: (B,) + v for k, v in env.obs_shape().items()}
    if {k: tuple(v.shape) for k, v in obs.items()} != want_shapes:
        raise AssertionError(f"vector({B}) reset: shapes differ from "
                             f"obs_shape() {want_shapes}")
    inner = st.inner if wrapper else st
    budget = (inner.extra["max_steps"] if inner.extra is not None
              and "max_steps" in inner.extra
              else torch.full((B,), base.params.max_steps, device="cuda"))
    inner = inner.replace(step_count=(budget - 1 - torch.arange(
        B, device="cuda") % T).to(torch.int32))
    st = st.replace(inner=inner) if wrapper else inner
    st0 = st.map(lambda x: x.cpu())
    record = []
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    for _ in range(T):
        keys = random_keys(g, (B, 2), "cuda")
        a = torch.randint(0, 7, (B,), generator=g, device="cuda",
                          dtype=torch.int32)
        layouts = base._gen_grid(g, B)
        out = step(keys, st, a, g, layouts)
        st = out[1]
        record.append((keys, a, layouts, out))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = (COUNTERS.launches, COUNTERS.observe_launches)
    name = short(env_id) if wrapper is None else f"{wrapper}({short(env_id)})"
    if launches != (T, T):
        raise AssertionError(f"{name} vector({B}): (step, observe) launches "
                             f"{launches}, expected ({T}, {T})")
    # the CPU replay
    _, cpu_step = cpu_env.vector(B)
    cg = cpu_base.generator(SEED)
    st_c, resets, bonus_steps = st0, 0, 0
    for t, (keys, a, layouts, out) in enumerate(record):
        ref = cpu_step(keys.cpu(), st_c, a.cpu(), cg,
                       layouts.map(lambda x: x.cpu()))
        for what, x, y in zip(("obs", "state", "reward", "terminated",
                               "truncated"), out[:5], ref[:5]):
            assert_same(f"{name} vector step {t} {what}", x, y)
        for k, v in out[0].items():
            if v.shape != want_shapes[k]:
                raise AssertionError(f"{name} step {t}: obs {k} shape")
        if not torch.isfinite(out[2]).all():
            raise AssertionError(f"{name} step {t}: reward not finite")
        resets += int((out[3] | out[4]).sum())
        # the stack's own reward: ActionBonus adds 1/sqrt(N) > 0 to every
        # env's, the bare env's is 0 but at the goal
        bonus_steps += int((out[2] > 0).all())
        st_c = ref[1]
    if resets < B:
        raise AssertionError(f"{name}: {resets} resets in {T} steps")
    if wrapper is not None and (bonus_steps != T or not isinstance(
            st, WR.WrappedState)):
        raise AssertionError(f"{name}: vector() did not step the stack "
                             f"({bonus_steps} of {T} steps with a bonus "
                             f"everywhere, state {type(st).__name__})")
    rate = B * T / secs
    print(f"  {name} vector({B}): {T} steps in {secs * 1e3:.1f} ms, "
          f"{rate:.0f} env-steps/s (host clock, the regen layouts drawn in "
          f"the loop); {launches[0]} step + {launches[1]} observe launches; "
          f"{resets} resets; card == CPU replay bit for bit")
    return {"steps": T, "batch": B, "seconds": secs, "env_steps_per_s": rate,
            "launches": launches[0], "observe_launches": launches[1],
            "resets": resets}


def surface_phase(card: str, regen_rollout_rate: float) -> dict:
    """Phase 4b: the re-exports resolve, then :data:`SURFACE_CASES`
    through ``vector(4096)`` (:func:`surface_vector_run`); the DoorKey-8x8
    rate is printed beside ``regen_rollout_rate``, the regen rollout's
    env-steps/s of phase 4 in the same call."""
    import importlib

    import minigrid_tpu_torch as mt
    from minigrid_tpu_torch.envs import DoorKeyEnv

    t0 = time.perf_counter()
    names = 0
    for package in ("", ".models", ".utils", ".envs", ".ops", ".core"):
        mod = importlib.import_module("minigrid_tpu_torch" + package)
        for name in mod.__all__:
            getattr(mod, name)
            names += 1
    from minigrid_tpu_torch import MissionSpace, refresh_layout_pool  # noqa
    from minigrid_tpu_torch.models import PPOConfig, train  # noqa: F401
    from minigrid_tpu_torch.ops import fused_rollout, fused_step
    from minigrid_tpu_torch.utils import BabyAIBot  # noqa: F401

    env = mt.make(ENV_ID, device="cuda")
    if not (fused_rollout is fused_step.fused_rollout
            and isinstance(env, DoorKeyEnv) and type(env).name == "DoorKey"):
        raise AssertionError("the package surface does not resolve")
    print(f"package surface: the {names} names of the six packages' "
          f"__all__ resolve")
    runs = {}
    for env_id, wrapper, T in SURFACE_CASES:
        name = (short(env_id) if wrapper is None
                else f"{wrapper}({short(env_id)})")
        runs[name] = surface_vector_run(env_id, wrapper, T)
    secs = time.perf_counter() - t0
    dk = runs[short(ENV_ID)]
    print(f"vector({BATCH}) of {short(ENV_ID)}: {dk['env_steps_per_s']:.0f} "
          f"env-steps/s against the regen rollout's "
          f"{regen_rollout_rate:.0f} (phase 4, the policy in the loop); "
          f"phase 4b took {secs:.1f} s (host clock; {card})")
    return {"vector": runs, "regen_rollout_env_steps_per_s":
            regen_rollout_rate, "seconds": secs}


# --- phase 7: the multi-device layer -----------------------------------------
# the ranks of a 2-rank group sharing the card (gloo) and this process run
# the same functions with the same seeds; each rank keeps its block of B
P7_RANKS = 2
P7_DTYPES = ("float32", "bfloat16")
# an update (or a train step) against its one-process counterpart from the
# same parameters. float32: the max abs parameter difference within 1e-5
# (summation order; the CPU tests hold the same). bfloat16: forwards at
# B/2 rows may round a gradient element otherwise, and Adam turns a
# gradient near its eps into a step of order lr, so no abs bound tells a
# right update from a wrong one; it is held by the update's relative
# error |p - p_one| / |p_one - p_init| over all parameters. The bound lies
# between the sound runs' readings and those of a known-wrong control
# (each rank's update of its own block without the collectives: local
# advantage statistics, local means, no gradient all-reduce), and the
# control must fail the check of its dtype in every run. On an H100 80GB
# HBM3 at 700 W the sound bf16 runs read 3.5e-05 to 0.0225 and the
# control 0.658 (f32: 0.665, 1.89e-03 abs)
P7_F32_TOL = 1e-5
P7_BF16_REL = 0.1
# 7a/7e: the regen and fresh reset modes, their rollouts held to one
# process's rows; 7e runs them on the (2, 2) mesh at this batch and length
P7_RESET_MODES = ("regen", "fresh")
P7E_BATCH, P7E_LEN = 1024, 32


class CountDistCalls:
    """Counts the calls of every public function of ``torch.distributed``
    while in its ``with`` block."""

    def __enter__(self):
        import inspect

        import torch.distributed as dist

        self.dist, self.calls = dist, 0
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
            setattr(self.dist, k, f)


def p7_env():
    import minigrid_tpu_torch as mt

    return mt.make(ENV_ID, device="cuda").packed()


def p7_timed_rollout(env, mesh, resets, st, obs, seed, pool=None, T=None):
    """A random-policy rollout of ``T`` steps (``ROLLOUT_LEN``) after a
    4-step warm-up from the same state (its set-up outside the clock), the
    launches counted from 0 and the torch.distributed calls counted just
    around it: ((state, obs, chunk), (step, observe) launches, calls, host
    ms)."""
    import torch

    from minigrid_tpu_torch.ops.native import COUNTERS
    from minigrid_tpu_torch.parallel.rollout import make_rollout

    make_rollout(env, None, 4, resets=resets, mesh=mesh)(
        None, st, obs, env.generator(seed + 1000), pool)
    rollout = make_rollout(env, None, T or ROLLOUT_LEN, resets=resets,
                           mesh=mesh)
    torch.cuda.synchronize()
    zero_counts()
    with CountDistCalls() as calls:
        t0 = time.perf_counter()
        out = rollout(None, st, obs, env.generator(seed), pool)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    return out, (COUNTERS.launches, COUNTERS.observe_launches), calls.calls, ms


def p7_random_rollout(mesh=None):
    """7a: DoorKey-8x8's pooled rollout (B=4096 staggered, T=128, a 1024
    pool) with uniform actions, of the mesh's data rank or of this
    process: (chunk as numpy, (step, observe) launches, torch.distributed
    calls, host ms)."""
    from minigrid_tpu_torch.parallel import mesh as M

    env = p7_env()
    g = env.generator(SEED + 70)
    pool = env.make_pool(g, POOL_SIZE)
    obs, st = env.reset_staggered(g, BATCH)
    if mesh is not None:
        obs, st = M.shard_batch(mesh, (obs, st))
    (st, obs, chunk), launched, calls, ms = p7_timed_rollout(
        env, mesh, "pooled", st, obs, SEED + 71, pool)
    out = {"reward": chunk.reward, "action": chunk.action,
           "done": chunk.done, "packed": chunk.obs["packed"],
           "pool": pool.grid}
    return ({k: v.cpu().numpy() for k, v in out.items()}, launched, calls,
            ms)


def p7_reset_rollout(resets: str, mesh=None, B: int = BATCH,
                     T: int = ROLLOUT_LEN):
    """7a and 7e: DoorKey-8x8's regen or fresh rollout of ``B`` staggered
    envs, ``T`` steps of uniform actions, the first half of the envs (the
    first data rank's) moved into the last ``T`` steps of their budget, so
    that all of them finish in the rollout: the fresh buffer, sized for a
    staggered batch, runs out, and the routing must rank the first data
    rank's finishers before the second's. Of the mesh's data rank or of
    this process: (chunk and final state as numpy, (step, observe)
    launches, torch.distributed calls, host ms)."""
    import torch

    from minigrid_tpu_torch.parallel import mesh as M

    env = p7_env()
    g = env.generator(SEED + 76)
    obs, st = env.reset_staggered(g, B)
    ms = env.params.max_steps
    first = torch.arange(B, device="cuda") < B // 2
    st = st.replace(step_count=torch.where(
        first, ms - 1 - st.step_count % T, st.step_count))
    if mesh is not None:
        obs, st = M.shard_batch(mesh, (obs, st))
    (st, obs, chunk), launched, calls, host_ms = p7_timed_rollout(
        env, mesh, resets, st, obs, SEED + 77, T=T)
    out = {"reward": chunk.reward, "action": chunk.action,
           "done": chunk.done, "packed": chunk.obs["packed"],
           "grid": st.grid, "agent_pos": st.agent_pos,
           "step_count": st.step_count}
    return ({k: v.cpu().numpy() for k, v in out.items()}, launched, calls,
            host_ms)


def p7_check_rows(name: str, got: list, want: dict, rows_of) -> None:
    """Each rank's chunk and final state (``got[r]``) against its rows
    (``rows_of(r)``) of the one-process ones ``want``, bit for bit: (T, B,
    ...) chunk entries, (B, ...) state entries."""
    import numpy as np

    for r, chunk in enumerate(got):
        rows = rows_of(r)
        for k, w in want.items():
            w = w[rows] if k in ("grid", "agent_pos", "step_count") \
                else w[:, rows]
            if not np.array_equal(chunk[k], w):
                raise AssertionError(f"{name}: rank {r}'s {k} differs from "
                                     "its rows of the one-process rollout")


def p7_update(dtype_name: str, mesh=None, collectives: bool = True):
    """7b: one update (PPOConfig(): 1 epoch of 4 rotate minibatches) of
    ActorCritic(256) on a fixed pooled DoorKey-8x8 trajectory (B=4096,
    T=128) that its initial weights collected; on the mesh's data rank's
    block of envs or in this process. ``collectives=False`` is the
    known-wrong control: the rank updates its block alone. Returns the
    parameters after and before (numpy), the trajectory's digest and the
    update's seconds."""
    import torch

    from minigrid_tpu_torch.models import ppo as P
    from minigrid_tpu_torch.models.actor_critic import (ActorCritic,
                                                        init_params)
    from minigrid_tpu_torch.parallel import mesh as M

    dtype = getattr(torch, dtype_name)
    env = p7_env()
    g = env.generator(SEED + 72)
    model = init_params(ActorCritic(hidden=256, dtype=dtype, device="cuda"),
                        g)
    init = {k: v.cpu().numpy() for k, v in model.state_dict().items()}
    pool = env.make_pool(g, POOL_SIZE)
    obs, st = env.reset_staggered(g, BATCH)
    noise = P.sample_rollout_noise(g, pool, BATCH, ROLLOUT_LEN,
                                   model.num_actions)
    st, obs, traj, _ = P.rollout(model, env, st, obs, noise, "pooled")
    digest = (int(traj.action.sum()), int(traj.done.sum()),
              float(traj.log_prob.double().sum()),
              float(traj.value.double().sum()))
    if mesh is not None:
        rows = mesh.batch_slice(BATCH)
        traj = P.Transition(
            {k: v[:, rows] for k, v in traj.obs.items()},
            *(v[:, rows] for v in traj[1:6]))
        obs = M.shard_batch(mesh, obs)
    cfg = P.PPOConfig(num_envs=BATCH, rollout_len=ROLLOUT_LEN)
    opt = P.make_optimizer(model, cfg)
    shared = torch.Generator(device="cuda").manual_seed(SEED + 73)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    P.ppo_update(model, opt, cfg, traj, obs, shared,
                 mesh=mesh if collectives else None)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return {"params": {k: v.cpu().numpy()
                       for k, v in model.state_dict().items()},
            "init": init, "digest": digest, "secs": secs}


def p7_policy_actions(mesh=None):
    """The first rollout of a pooled DoorKey-8x8 train step at full width
    (bf16 ActorCritic(256)): its actions, of the data rank or of this
    process."""
    import torch

    from minigrid_tpu_torch.models import ppo as P
    from minigrid_tpu_torch.models.actor_critic import (ActorCritic,
                                                        init_params)
    from minigrid_tpu_torch.parallel import mesh as M

    env = p7_env()
    g = env.generator(SEED + 74)
    model = init_params(ActorCritic(hidden=256, device="cuda"), g)
    pool = env.make_pool(g, POOL_SIZE)
    obs, st = env.reset_staggered(g, BATCH)
    noise = P.sample_rollout_noise(g, pool, BATCH, ROLLOUT_LEN,
                                   model.num_actions)
    if mesh is not None:
        obs, st = M.shard_batch(mesh, (obs, st))
        noise = noise.shard(mesh.batch_slice(BATCH))
    traj = P.rollout(model, env, st, obs, noise, "pooled")[2]
    return traj.action.cpu().numpy()


def p7_all_reduce_ms(mesh, numel: int, reps: int = 20) -> float:
    """Host ms of one all-reduce of a float32 bucket of ``numel`` entries
    on the card over the data ranks (synchronised, after a warm-up)."""
    import torch
    import torch.distributed as dist

    flat = torch.zeros(numel, device="cuda")
    dist.all_reduce(flat, group=mesh.data_group)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        dist.all_reduce(flat, group=mesh.data_group)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def p7_finishers_ms(mesh, reps: int = 100) -> float:
    """Host ms of one call of the fresh routing's per-step collective
    (``models/ppo.py::finisher_counts``: an all-reduce of the data ranks'
    finisher counts, (n,) int32 on the card; synchronised, after a
    warm-up)."""
    import torch

    from minigrid_tpu_torch.models.ppo import finisher_counts

    finishers = finisher_counts(mesh)
    count = torch.tensor(7, dtype=torch.int32, device="cuda")
    finishers(count)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        offset, total = finishers(count)
    torch.cuda.synchronize()
    if int(total) != 7 * mesh.data_size or int(offset) != 7 * mesh.data_rank:
        raise AssertionError(f"finisher counts {int(offset)}, {int(total)}")
    return (time.perf_counter() - t0) / reps * 1e3


def multi_device_rank(parts=("a", "b", "step", "actions",
                             "dryrun")) -> dict:
    """Phase 7 on one rank of a group of 2 (spawned by ``parallel.mesh.
    spawn``): the pooled, regen and fresh random-policy rollouts and the
    fresh routing's collective (7a), the f32 and bf16 updates and
    their controls (7b), the gradient all-reduce's time, the distributed
    train step, the policy's actions, and the dry run on the (2, 1) mesh
    (7e)."""
    import torch

    from minigrid_tpu_torch.parallel import mesh as M
    from minigrid_tpu_torch.parallel.dryrun import dryrun_multichip

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = M.make_mesh(P7_RANKS)
    out = {"rank": mesh.rank}
    if "a" in parts:
        out["a"] = p7_random_rollout(mesh)
        t0 = time.perf_counter()
        for resets in P7_RESET_MODES:
            out[resets] = p7_reset_rollout(resets, mesh)
        out["finishers_ms"] = p7_finishers_ms(mesh)
        out["reset_secs"] = time.perf_counter() - t0
    if "b" in parts:
        out["b"] = {d: p7_update(d, mesh) for d in P7_DTYPES}
        out["b_control"] = {d: p7_update(d, mesh, collectives=False)
                            ["params"] for d in P7_DTYPES}
        numel = sum(v.size for v in out["b"]["float32"]["params"].values())
        out["all_reduce"] = (numel * 4, p7_all_reduce_ms(mesh, numel))
    if "step" in parts:
        out["step"] = p7_train_step(mesh)
    if "actions" in parts:
        out["actions"] = p7_policy_actions(mesh)
    if "dryrun" in parts:
        out["dryrun"] = dryrun_multichip(P7_RANKS, device="cuda")[0]
    return out


def multi_device_mesh22_rank() -> dict:
    """7e on one rank of 4 sharing the card: ``dryrun_multichip(4)`` (its
    (2, 2) mesh) and the regen and fresh rollouts of ``p7_reset_rollout``
    (B=1024, T=32) on a (2, 2) mesh."""
    from minigrid_tpu_torch.parallel import mesh as M
    from minigrid_tpu_torch.parallel.dryrun import dryrun_multichip

    out = {"dryrun": dryrun_multichip(4, device="cuda")[0]}
    mesh = M.make_mesh(4, model_parallel=2)
    out["data_rank"] = mesh.data_rank
    t0 = time.perf_counter()
    for resets in P7_RESET_MODES:
        out[resets] = p7_reset_rollout(resets, mesh, P7E_BATCH, P7E_LEN)
    out["reset_secs"] = time.perf_counter() - t0
    return out


def p7_train_step(mesh=None, dtype_name: str = "bfloat16"):
    """One pooled DoorKey-8x8 train step at full width (ActorCritic(256)
    in ``dtype_name``, PPOConfig()), distributed over ``mesh`` or not: the
    parameters after and before (numpy) and the (step, observe) launches
    counted from 0 just before the step."""
    import torch

    from minigrid_tpu_torch.models import ppo as P
    from minigrid_tpu_torch.models.actor_critic import (ActorCritic,
                                                        init_params)
    from minigrid_tpu_torch.ops.native import COUNTERS
    from minigrid_tpu_torch.parallel import mesh as M

    env = p7_env()
    g = env.generator(SEED + 75)
    model = init_params(ActorCritic(hidden=256,
                                    dtype=getattr(torch, dtype_name),
                                    device="cuda"), g)
    init = {k: v.cpu().numpy() for k, v in model.state_dict().items()}
    cfg = P.PPOConfig(num_envs=BATCH, rollout_len=ROLLOUT_LEN)
    opt = P.make_optimizer(model, cfg)
    pool = env.make_pool(g, POOL_SIZE)
    obs, st = env.reset_staggered(g, BATCH)
    if mesh is not None:
        obs, st = M.shard_batch(mesh, (obs, st))
    step = P.make_train_step(env, model, cfg, opt, resets="pooled",
                             mesh=mesh)
    torch.cuda.synchronize()
    zero_counts()
    step(st, obs, g, pool)
    torch.cuda.synchronize()
    return {"params": {k: v.cpu().numpy()
                       for k, v in model.state_dict().items()},
            "init": init,
            "launches": (COUNTERS.launches, COUNTERS.observe_launches)}


def p7_world_of_one(backend: str) -> dict:
    """7d: the distributed train step, f32 and bf16, in a world of one
    rank over ``backend``."""
    import torch.distributed as dist

    from minigrid_tpu_torch.parallel import mesh as M

    M.init_ranks(1, backend, "cuda")
    try:
        mesh = M.make_mesh(1)
        return {d: p7_train_step(mesh, d) for d in P7_DTYPES}
    finally:
        dist.destroy_process_group()


def max_abs_diff(a: dict, b: dict) -> float:
    import numpy as np

    return max(float(np.abs(a[k].astype(np.float64) - b[k]).max())
               for k in a)


def update_rel_err(got: dict, want: dict, init: dict) -> float:
    """|got - want| / |want - init| over all parameters (L2, float64)."""
    import numpy as np

    num = sum(float(((got[k].astype(np.float64) - want[k]) ** 2).sum())
              for k in want)
    den = sum(float(((want[k].astype(np.float64) - init[k]) ** 2).sum())
              for k in want)
    return math.sqrt(num / den)


def p7_compare(got: dict, want: dict, dtype_name: str) -> tuple:
    """(max abs param diff, relative error, whether the dtype's check
    holds) of ``got`` against ``want`` (dicts of params and init)."""
    diff = max_abs_diff(got["params"], want["params"])
    rel = update_rel_err(got["params"], want["params"], want["init"])
    ok = (diff <= P7_F32_TOL if dtype_name == "float32"
          else rel <= P7_BF16_REL)
    return diff, rel, ok


def p7_bound(dtype_name: str) -> str:
    return (f"max abs diff <= {P7_F32_TOL:.0e}" if dtype_name == "float32"
            else f"relative error <= {P7_BF16_REL}")


def multi_device_phase(card: str, kind: str) -> dict:
    """Phase 7: the multi-device layer on the card (module docstring). Every
    run is on the card: 2 ranks sharing it over gloo, a world of one over
    NCCL, the dry run's (2, 1) and (2, 2) meshes; the seconds on the
    script's clock are ``multi_device_secs``. Returns the numbers."""
    import numpy as np
    import torch

    from minigrid_tpu_torch.models.ppo import PPOConfig
    from minigrid_tpu_torch.models.train import TrainConfig, train
    from minigrid_tpu_torch.parallel import mesh as M

    t7 = time.perf_counter()
    ref_chunk, ref_launches, ref_calls, ref_ms = p7_random_rollout()
    t_refs = time.perf_counter()
    ref_resets = {m: p7_reset_rollout(m) for m in P7_RESET_MODES}
    ref_resets_e = {m: p7_reset_rollout(m, None, P7E_BATCH, P7E_LEN)
                    for m in P7_RESET_MODES}
    added_secs = time.perf_counter() - t_refs
    ref_update = {d: p7_update(d) for d in P7_DTYPES}
    ref_actions = p7_policy_actions()
    ranks = M.spawn(multi_device_rank, P7_RANKS, "gloo", "cuda",
                    timeout=900)
    Bl = BATCH // P7_RANKS
    # 7a: each rank's block of the one-process rollout, bit for bit
    rank_launches, rank_ms = [], []
    for r, res in enumerate(ranks):
        chunk, launched, calls, ms = res["a"]
        rank_ms.append(ms)
        rows = slice(r * Bl, (r + 1) * Bl)
        for k in ("reward", "action", "done", "packed"):
            if not np.array_equal(chunk[k], ref_chunk[k][:, rows]):
                raise AssertionError(f"7a: rank {r}'s {k} differs from its "
                                     "rows of the one-process rollout")
        if not np.array_equal(chunk["pool"], ref_chunk["pool"]):
            raise AssertionError(f"7a: rank {r}'s layout pool differs")
        if calls != 0:
            raise AssertionError(f"7a: rank {r}'s rollout made {calls} "
                                 "torch.distributed calls")
        if launched != (ROLLOUT_LEN, 0):
            raise AssertionError(f"7a: rank {r} launched {launched}")
        rank_launches.append(launched)
    print(f"7a. pooled random-policy rollout of {short(ENV_ID)}, B={BATCH} "
          f"over {P7_RANKS} gloo ranks sharing {kind} (B={Bl} a rank, "
          f"T={ROLLOUT_LEN}): each rank's block equals the one-process "
          f"rollout bit for bit (reward, action, done, packed obs; "
          f"{int(ref_chunk['done'].sum())} episodes ended), the layout "
          f"pools are equal, 0 torch.distributed calls; (step, observe) "
          f"launches by rank {rank_launches}, one process {ref_launches}; "
          f"host ms by rank {[round(m, 3) for m in rank_ms]}, one process "
          f"{ref_ms:.3f}")
    # 7a, regen and fresh: each rank's rows of the one-process rollout,
    # bit for bit; the collective calls a rank: 0 (regen), one a step
    # (fresh: the finisher counts)
    reset_report = {}
    for m in P7_RESET_MODES:
        want, want_launched, want_calls, want_ms = ref_resets[m]
        p7_check_rows(f"7a {m}", [res[m][0] for res in ranks], want,
                      lambda r: slice(r * Bl, (r + 1) * Bl))
        launched = [res[m][1] for res in ranks]
        calls = [res[m][2] for res in ranks]
        expect_calls = ROLLOUT_LEN if m == "fresh" else 0
        if calls != [expect_calls] * P7_RANKS or want_calls != 0:
            raise AssertionError(f"7a {m}: torch.distributed calls {calls}, "
                                 f"one process {want_calls}")
        if any(n != (ROLLOUT_LEN, ROLLOUT_LEN) for n in launched):
            raise AssertionError(f"7a {m}: ranks launched {launched}")
        rank_launches += launched
        reset_report[m] = {
            "ms_by_rank": [res[m][3] for res in ranks],
            "ms_one_process": want_ms, "dist_calls_by_rank": calls,
            "launches_by_rank": launched, "launches_one_process":
            want_launched, "episodes_ended": int(want["done"].sum())}
        print(f"7a. {m} random-policy rollout of {short(ENV_ID)}, B={BATCH} "
              f"over {P7_RANKS} gloo ranks sharing {kind} (T={ROLLOUT_LEN}; "
              f"the first rank's {Bl} envs all finish inside it, "
              f"{int(want['done'].sum())} episodes ended): each rank's rows "
              f"equal the one-process rollout bit for bit (reward, action, "
              f"done, packed obs, final grid, agent_pos, step_count); "
              f"torch.distributed calls by rank {calls}; (step, observe) "
              f"launches by rank {launched}, one process {want_launched}; "
              f"host ms by rank "
              f"{[round(x, 3) for x in reset_report[m]['ms_by_rank']]}, one "
              f"process {want_ms:.3f} (pooled: {rank_ms[0]:.3f} on rank 0; "
              f"{card})")
    finishers_ms = ranks[0]["finishers_ms"]
    added_secs += ranks[0]["reset_secs"]
    print(f"  the fresh routing's collective (an all-reduce of the "
          f"{P7_RANKS} ranks' finisher counts, int32 on the card, gloo): "
          f"{finishers_ms:.4f} ms host time a call, {ROLLOUT_LEN} a "
          f"rollout ({card})")
    # 7b: the update over 2 ranks against one process, and the control
    update_diff, update_rel, control = {}, {}, {}
    for d in P7_DTYPES:
        want = ref_update[d]
        got = [res["b"][d] for res in ranks]
        for r, res_b in enumerate(got):
            if res_b["digest"] != want["digest"]:
                raise AssertionError(
                    f"7b {d}: rank {r}'s trajectory {res_b['digest']} is "
                    f"not this process's {want['digest']}")
        if max_abs_diff(got[0]["params"], got[1]["params"]) != 0:
            raise AssertionError(f"7b {d}: the ranks' parameters differ")
        update_diff[d], update_rel[d], ok = p7_compare(got[0], want, d)
        c_diff, c_rel, c_ok = p7_compare(
            {"params": ranks[0]["b_control"][d]}, want, d)
        control[d] = (c_diff, c_rel)
        print(f"7b. one update of ActorCritic(256) {d} on a {short(ENV_ID)} "
              f"pooled trajectory (B={BATCH}, T={ROLLOUT_LEN}, PPOConfig()) "
              f"over {P7_RANKS} ranks against one process: max abs param "
              f"diff {update_diff[d]:.3e}, relative error "
              f"{update_rel[d]:.3e} (check: {p7_bound(d)}); the control "
              f"(rank 0's block updated alone): {c_diff:.3e}, "
              f"{c_rel:.3e}; the ranks' parameters bit-equal; update "
              f"{got[0]['secs'] * 1e3:.1f} ms on rank 0 against "
              f"{want['secs'] * 1e3:.1f} ms in one process (ranks sharing "
              f"{card})")
        if not ok:
            raise AssertionError(f"7b {d}: fails {p7_bound(d)}")
        if c_ok:
            raise AssertionError(f"7b {d}: the known-wrong control passes "
                                 f"{p7_bound(d)}")
    grad_bytes, grad_ms = ranks[0]["all_reduce"]
    print(f"  the gradient all-reduce: one {grad_bytes} B f32 bucket a "
          f"minibatch, {grad_ms:.3f} ms host time over gloo between 2 "
          f"ranks on one card (+ 2 scalar all-reduces a minibatch, 1 for "
          f"the metrics an update; {card})")
    # the distributed train step on the 2 ranks, each rank's launches
    # counted from 0 just before its step
    step_launches = [res["step"]["launches"] for res in ranks]
    if max_abs_diff(ranks[0]["step"]["params"],
                    ranks[1]["step"]["params"]) != 0:
        raise AssertionError("the 2 ranks' train steps left different "
                             "parameters")
    if any(n != (ROLLOUT_LEN, 0) for n in step_launches):
        raise AssertionError(f"the 2-rank train step launched "
                             f"{step_launches}")
    actions = np.concatenate([res["actions"] for res in ranks], axis=1)
    differ = int((actions != ref_actions).sum())
    print(f"  actions of a policy-driven train step's rollout (bf16, "
          f"B={BATCH}, T={ROLLOUT_LEN}) that differ between {P7_RANKS} "
          f"ranks and one process: {differ} of {actions.size} (the "
          f"policy's GEMMs at B={Bl} rows round otherwise; not asserted)")
    # 7c: train(devices=2) over gloo on the one card, and in one process
    tcfg = TrainConfig(total_env_steps=3 * BATCH * ROLLOUT_LEN,
                       ppo=PPOConfig(num_envs=BATCH,
                                     rollout_len=ROLLOUT_LEN), log_every=1)
    _, h2 = train(ENV_ID, dataclasses.replace(tcfg, devices=P7_RANKS),
                  backend="gloo")
    _, h1 = train(ENV_ID, tcfg)
    for h in (h1, h2):
        if len(h) != 3 or not all(math.isfinite(v) for m in h
                                  for v in m.values()):
            raise AssertionError(f"7c: history {h}")
    train_rates = (h2[-1]["env_steps_per_s"], h1[-1]["env_steps_per_s"])
    print(f"7c. train({short(ENV_ID)}, devices={P7_RANKS}, num_envs="
          f"{BATCH}), 3 updates, {P7_RANKS} gloo ranks SHARING one card "
          f"(not a scaling number): {train_rates[0]:.0f} env-steps/s; one "
          f"process: {train_rates[1]:.0f} env-steps/s (spawn and set-up "
          f"outside the clock, the first update's warm-up inside; host "
          f"clock; {card})")
    # 7d: a world of one rank over NCCL, and over gloo, bit for bit; each
    # against the step without a mesh, f32 and bf16
    nccl, gloo = p7_world_of_one("nccl"), p7_world_of_one("gloo")
    plain = {d: p7_train_step(None, d) for d in P7_DTYPES}
    step_rel = update_rel_err(ranks[0]["step"]["params"],
                              plain["bfloat16"]["params"],
                              plain["bfloat16"]["init"])
    print(f"  the train step (bf16) over {P7_RANKS} ranks against one "
          f"process: relative error {step_rel:.3e} (a reading: the "
          f"policy's actions may differ); (step, observe) launches by "
          f"rank {step_launches}")
    world_launches, world = [], {}
    for d in P7_DTYPES:
        if max_abs_diff(nccl[d]["params"], gloo[d]["params"]) != 0:
            raise AssertionError(f"7d {d}: a world of one over NCCL differs "
                                 "from gloo")
        diff, rel, ok = p7_compare(nccl[d], plain[d], d)
        world[d] = (diff, rel)
        world_launches += [nccl[d]["launches"], gloo[d]["launches"]]
        print(f"7d. the distributed pooled train step of {short(ENV_ID)} "
              f"{d} at B={BATCH} in a world of one rank: NCCL == gloo bit "
              f"for bit; against the step without a mesh: max abs param "
              f"diff {diff:.3e}, relative error {rel:.3e} (check: "
              f"{p7_bound(d)}); (step, observe) launches NCCL "
              f"{nccl[d]['launches']}, gloo {gloo[d]['launches']}")
        if not ok:
            raise AssertionError(f"7d {d}: fails {p7_bound(d)}")
    if torch.cuda.device_count() >= 2:
        nccl_ranks = M.spawn(multi_device_rank, P7_RANKS, "nccl", "cuda",
                             args=(("b",),), timeout=900)
        for d in P7_DTYPES:
            diff, rel, ok = p7_compare(nccl_ranks[0]["b"][d],
                                       ref_update[d], d)
            print(f"  7b over NCCL on {P7_RANKS} cards, {d}: max abs param "
                  f"diff {diff:.3e}, relative error {rel:.3e}")
            if not ok:
                raise AssertionError(f"7b NCCL {d}: fails {p7_bound(d)}")
        _, hn = train(ENV_ID, dataclasses.replace(tcfg, devices=P7_RANKS))
        print(f"  7c over NCCL on {P7_RANKS} cards: "
              f"{hn[-1]['env_steps_per_s']:.0f} env-steps/s ({card})")
    else:
        print(f"  the 2-card NCCL runs of 7b and 7c were not made: this "
              f"machine has {torch.cuda.device_count()} card")
    # 7e: the dry run on the (2, 1) mesh (in the group above) and the
    # (2, 2) mesh (4 gloo ranks on the card): finite metrics, equal on
    # every rank (global, and the model ranks of a data rank hold the
    # same envs)
    mesh22 = M.spawn(multi_device_mesh22_rank, 4, "gloo", "cuda",
                     timeout=900)
    dry = {"(2, 1)": [res["dryrun"] for res in ranks],
           "(2, 2)": [res["dryrun"] for res in mesh22]}
    for mesh_shape, res in dry.items():
        if not all(math.isfinite(v) for m in res[0].values()
                   for v in m.values()):
            raise AssertionError(f"7e {mesh_shape}: {res[0]}")
        if any(r != res[0] for r in res):
            raise AssertionError(f"7e {mesh_shape}: the ranks' metrics "
                                 f"differ: {res}")
        print(f"7e. dryrun_multichip on a {mesh_shape} mesh of gloo ranks "
              f"sharing the card: {', '.join(res[0])} OK, the metrics "
              f"equal on all {len(res)} ranks")
    # 7e: the regen and fresh rollouts on the (2, 2) mesh, each rank's rows
    # those of its data rank in one process (the model ranks of a data
    # rank hold the same envs)
    Be = P7E_BATCH // P7_RANKS
    for m in P7_RESET_MODES:
        want = ref_resets_e[m][0]
        p7_check_rows(f"7e {m}", [res[m][0] for res in mesh22], want,
                      lambda r: slice(mesh22[r]["data_rank"] * Be,
                                      (mesh22[r]["data_rank"] + 1) * Be))
        calls = [res[m][2] for res in mesh22]
        if calls != [P7E_LEN if m == "fresh" else 0] * 4:
            raise AssertionError(f"7e {m}: torch.distributed calls {calls}")
        if any(res[m][1] != (P7E_LEN, P7E_LEN) for res in mesh22):
            raise AssertionError(f"7e {m}: launches "
                                 f"{[res[m][1] for res in mesh22]}")
        print(f"7e. {m} random-policy rollout of {short(ENV_ID)}, "
              f"B={P7E_BATCH}, T={P7E_LEN} on a (2, 2) mesh of gloo ranks "
              f"sharing the card: each rank's rows equal its data rank's "
              f"rows of one process bit for bit "
              f"({int(want['done'].sum())} episodes ended); "
              f"torch.distributed calls by rank {calls}; (step, observe) "
              f"launches by rank {[res[m][1] for res in mesh22]}")
    added_secs += mesh22[0]["reset_secs"]
    rank_launches += [res[m][1] for m in P7_RESET_MODES for res in mesh22]
    print(f"  the regen/fresh additions of 7a and 7e on the script's clock: "
          f"{added_secs:.1f} s (the one-process references, rank 0's "
          f"rollouts in the 2-rank group and on the (2, 2) mesh)")
    multi_device_secs = time.perf_counter() - t7
    print(f"7. multi-device on the script's clock: {multi_device_secs:.1f} "
          f"s")
    multi_device = {
        "ranks_launches": rank_launches,
        "reset_rollouts": reset_report, "finishers_ms": finishers_ms,
        "reset_additions_secs": added_secs,
        "ranks_step_launches": step_launches,
        "world_of_one_launches": world_launches,
        "update_max_abs_diff": update_diff,
        "update_rel_err": update_rel, "control": control,
        "all_reduce_bytes": grad_bytes, "all_reduce_ms": grad_ms,
        "actions_differ": differ, "actions": int(actions.size),
        "step_rel_err_2_ranks": step_rel,
        "train_env_steps_per_s_2_ranks_one_card": train_rates[0],
        "train_env_steps_per_s_one_process": train_rates[1],
        "world_of_one_vs_plain": world,
        "multi_device_secs": multi_device_secs}
    return multi_device


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
    from minigrid_tpu_torch.envs.base import has_step_hooks
    from minigrid_tpu_torch.ops import fused_step as F
    from minigrid_tpu_torch.ops.fused_step import (
        GROUP_LANES, _fused_observe_cuda, _fused_rollout_cuda,
        fused_observe_reference, fused_rollout_reference, launch_geometry,
        observe_launch_geometry, sm_count)
    from minigrid_tpu_torch.ops.native import COUNTERS

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
    F.LIBRARY.load()
    print(f"kernel built in {time.perf_counter() - t0:.2f} s")
    for line in F.LIBRARY.build_log.splitlines():
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
    for view in (7, 33, 63):
        geo = observe_launch_geometry(BATCH, view, sms)
        print(f"  observe entry B={BATCH} view {view} (any grid): "
              f"G={geo.group_lanes}, {geo.envs_per_block} envs x "
              f"{geo.blocks} blocks, {geo.threads} threads, "
              f"{geo.shared_memory_bytes} bytes of shared memory per block")

    # --- 2. kernel against plain version -------------------------------
    def check(name, env_id, B, T, hint=None, reset=False, native=False,
              view=None, group_lanes=None, skip=0):
        # skip: the state is the contiguous view of envs skip.. of a batch
        # of B + skip, whose grid starts off a 16-byte boundary
        env = mt.make(env_id, device="cuda").packed()
        if view is not None:
            env = env.replace_params(view_size=view)
        g = env.generator(SEED + 1)
        if reset:
            _, st = env.reset_staggered(g, B + skip)
        else:
            _, st = env.reset(g, B + skip)
        if skip:
            st = st.map(lambda t: t[skip:])
            assert st.grid.is_contiguous() and st.grid.data_ptr() % 16, name
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
    # the step entry's state copy, a block's run of grids in and out by one
    # bulk copy each way: grids of W*H*5 bytes that are no multiple of 16
    # (25x25, 22x22, 19x19, 9x9), a ragged last block, and grid inputs
    # that start off a 16-byte boundary (the output's offsets then differ)
    multiroom, bosslevel = "MiniGrid-MultiRoom-N6-v0", "BabyAI-BossLevel-v0"
    errs += [
        check("MultiRoom-N6 25x25 B=4096 T=32 reset-row entry", multiroom,
              BATCH, 32, hint="interact", reset=True),
        check("BossLevel 22x22 B=4096 T=32", bosslevel, BATCH, 32,
              hint="interact"),
        check("FourRooms 19x19 B=4096 T=32 reset-row entry",
              "MiniGrid-FourRooms-v0", BATCH, 32, hint="interact",
              reset=True),
        check("LavaCrossingS9N2 9x9 B=4096 T=32 reset-row entry", LAVA_ID,
              BATCH, 32, hint="interact", reset=True),
        check("MultiRoom-N6 25x25 ragged B=1001 T=32 reset-row entry",
              multiroom, 1001, 32, hint="interact", reset=True),
        check("MultiRoom-N6 25x25 unaligned grid B=1001 T=32 reset-row "
              "entry", multiroom, 1001, 32, hint="interact", reset=True,
              skip=1),
        check("BossLevel 22x22 unaligned grid B=4096 T=16", bosslevel,
              BATCH, 16, hint="interact", skip=1),
        check("LavaCrossingS9N2 9x9 unaligned grid B=1001 T=16 reset-row "
              "entry", LAVA_ID, 1001, 16, reset=True, skip=3),
    ]

    # the observe entry against plain gen_obs, on states after 16
    # interaction steps (doors opened, keys carried)
    # (at the picked G, or at each G of ``widths`` on the same states)
    def check_observe(name, env_id, B, view=None, widths=(None,)):
        env = mt.make(env_id, device="cuda").packed()
        if view is not None:
            env = env.replace_params(view_size=view)
        g = env.generator(SEED + 3)
        _, st = env.reset(g, B)
        choice = torch.tensor([0, 1, 2, 2, 3, 4, 5, 5], device="cuda")
        acts = choice[torch.randint(0, 8, (16, B), generator=g,
                                    device="cuda")].to(torch.int32)
        st = _fused_rollout_cuda(env.params, st, acts, False, None, None)[0]
        want = fused_observe_reference(env.params, st)
        carried = int((st.carrying[:, 0] != 1).sum())
        errs = []
        for G in widths:
            got = _fused_observe_cuda(env.params, st, G)
            torch.cuda.synchronize()
            err = (got.double() - want.double()).abs().max().item()
            at = "" if G is None else f" G={G}"
            if not torch.equal(got, want):
                raise AssertionError(f"observe entry: {name}{at} differs "
                                     f"from plain gen_obs (max abs {err})")
            print(f"observe == plain: {name}{at} ({carried} envs carrying; "
                  f"max_abs_err {err})")
            errs.append(err)
        return max(errs)

    observe_errs = [
        check_observe("DoorKey-8x8 B=4096", ENV_ID, BATCH),
        check_observe("Empty-8x8 B=4096 see-through",
                      "MiniGrid-Empty-8x8-v0", BATCH),
        check_observe("DoorKey-5x5 B=4096", "MiniGrid-DoorKey-5x5-v0", BATCH),
        check_observe("DoorKey-8x8 ragged B=4000", ENV_ID, 4000),
        check_observe("DoorKey-8x8 view size 9 B=4096", ENV_ID, BATCH,
                      view=9),
        check_observe("DoorKey-8x8 B=1001", ENV_ID, 1001,
                      widths=GROUP_LANES),
        # the window read from device memory: view 3, 25x25 at full width
        # and at every G with a ragged last block, 22x22 ragged, the wide
        # views' early stop with see-through walls (which never stop)
        check_observe("DoorKey-8x8 view size 3 B=4096", ENV_ID, BATCH,
                      view=3),
        check_observe("MultiRoom-N6 25x25 B=4096",
                      "MiniGrid-MultiRoom-N6-v0", BATCH),
        check_observe("MultiRoom-N6 25x25 B=1001",
                      "MiniGrid-MultiRoom-N6-v0", 1001, widths=GROUP_LANES),
        check_observe("BossLevel 22x22 ragged B=1001", "BabyAI-BossLevel-v0",
                      1001),
        check_observe("Fetch-8x8-N3 see-through view 33 B=1024",
                      "MiniGrid-Fetch-8x8-N3-v0", 1024, view=33),
    ]
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
    # 25x25 at view 63 takes G=32, 8 envs a block: a 25,000-byte run, no
    # multiple of 16, and a ragged last block of 5 envs
    wide_errs = [check("MultiRoom-N6 25x25 view 63 G=32 B=4093 T=8 "
                       "reset-row entry", "MiniGrid-MultiRoom-N6-v0", 4093,
                       8, hint="interact", reset=True, view=63,
                       group_lanes=32)]
    wide_observe_errs = []
    for env_id in (ENV_ID, "MiniGrid-MultiRoom-N6-v0"):
        wp = mt.make(env_id, device="cpu").params
        for view in WIDE_VIEWS:
            name = f"{short(env_id)} view {view}"
            wide_errs.append(check(f"{name} B=1024 T=32 reset-row entry",
                                   env_id, 1024, 32, hint="interact",
                                   reset=True, view=view))
            widths = [None]
            for G in GROUP_LANES:
                # one warp of G-lane envs may not fit: the step entry's
                # block holds their grids, the observe entry's their views
                try:
                    launch_geometry(1024, wp.width, wp.height, view, sms, G)
                except ValueError:
                    print(f"  {name}: G={G} does not fit the step entry's "
                          f"shared memory")
                else:
                    wide_errs.append(check(f"{name} G={G} B=1024 T=8",
                                           env_id, 1024, 8, hint="interact",
                                           reset=True, view=view,
                                           group_lanes=G))
                try:
                    observe_launch_geometry(1024, view, sms, G)
                except ValueError:
                    print(f"  {name}: G={G} does not fit the observe "
                          f"entry's shared memory")
                else:
                    widths.append(G)
            wide_observe_errs.append(check_observe(
                f"{name} B=1024", env_id, 1024, view=view, widths=widths))
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

    # --- 2b. the BabyAI post-step kernel against its plain version ------
    post_step_times = post_step_phase(card)

    # --- 2c. the fresh select kernel against its plain version ----------
    select_times = select_phase(card)

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
    launches = COUNTERS.launches
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
        if (COUNTERS.launches, COUNTERS.observe_launches) != (T, T):
            raise AssertionError(f"{mode}: expected {T} step and {T} observe "
                                 "launches")
        if COUNTERS.select_launches != (T if mode == "fresh" else 0):
            raise AssertionError(f"{mode}: {COUNTERS.select_launches} select "
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
        want = (T, T if level else T // 2, T if level else 0)
        launched = (COUNTERS.launches, COUNTERS.observe_launches,
                    COUNTERS.verify_launches)
        if launched != want:
            raise AssertionError(f"{env_id}: (step, observe, post-step) "
                                 f"launches {launched}, expected {want}")
        if n_done < B // 2:
            raise AssertionError(f"{env_id}: only {n_done} episodes ended")
        mode = ", done actions" if done_actions else ""
        print(f"hook path, {short(env_id)}{mode} (B={B}, T={T}): {n_done} "
              f"episodes ended, {n_success} rewarded; {want[0]} step + "
              f"{want[1]} observe + {want[2]} post-step launches; card == "
              f"CPU replay, extra included")

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
                launched[variant].append(COUNTERS.observe_launches)
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
        launched = (COUNTERS.launches, COUNTERS.observe_launches)
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
        launched = (COUNTERS.launches, COUNTERS.observe_launches,
                    COUNTERS.verify_launches)
        if launched != (len(trace),) * 3:
            raise AssertionError(f"{level}: (step, observe, post-step) "
                                 f"launches {launched} over {len(trace)} "
                                 f"steps")
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
              f"step + {launched[1]} observe + {launched[2]} post-step "
              f"launches; the CPU replay bit-exact (host clock; {card})")

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
        launches_t = COUNTERS.launches, COUNTERS.observe_launches
        verify_launches = COUNTERS.verify_launches
        select_launches = COUNTERS.select_launches
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
        # a BabyAI level's post-step: one kernel launch an env step
        if verify_launches != (reps * ROLLOUT_LEN if budget else 0):
            raise AssertionError(f"{short(env_id)} {mode} train steps: "
                                 f"{verify_launches} post-step launches")
        # the fresh reset's routing and select: one kernel launch a step
        if select_launches != (reps * ROLLOUT_LEN if mode == "fresh" else 0):
            raise AssertionError(f"{short(env_id)} {mode} train steps: "
                                 f"{select_launches} select launches")
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
                "verify_launches_per_step": verify_launches // reps,
                "select_launches_per_step": select_launches // reps,
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

    # --- 4b. the package surface: the re-exports, vector(4096) ------------
    surface = surface_phase(card, BATCH * ROLLOUT_LEN
                            / train["regen"]["rollout_s"])
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
        launches_t = COUNTERS.launches, COUNTERS.observe_launches
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
    loop1 = (ms128 - ms1) / 127
    print(f"  B={BATCH} T=128 pure, G={groups[f't128_b{BATCH}']}: "
          f"{ms128 * 1e3:.2f} us (bound {bound128 * 1e3:.2f} us by "
          f"{by128}, plain version {plain_ms128 * 1e3:.1f} us); loop "
          f"{loop1 * 1e3:.3f} us a step ((T=128 - T=1) / 127)")
    print(f"  B={big} T=128 pure, G={groups[f't128_b{big}']}: "
          f"{ms_big * 1e3:.2f} us (bound {bound_big * 1e3:.2f} us by "
          f"{by_big}, plain version {plain_ms_big * 1e3:.1f} us)")

    # the observe entry at B=4096 (the fresh and regen rollouts' shape)
    run_o = lambda: _fused_observe_cuda(p, st0)
    ms_o = device_ms(run_o, 200, kernel="fused_observe_kernel")
    plain_ms_o = cuda_ms(lambda: fused_observe_reference(p, st0), 10)
    bound_o, by_o = observe_bound_ms(st0, run_o(), V)
    window_o, window_by_o = observe_window_bound_ms(st0, V)
    obs_o = run_o()
    floor_o = zero_ms(obs_o, 200)
    print(f"  observe entry B={BATCH}, G="
          f"{observe_launch_geometry(BATCH, V, sms).group_lanes}: "
          f"{ms_o * 1e3:.2f} us (window bound {window_o * 1e3:.2f} us by "
          f"{window_by_o}, {observe_window_bytes(st0, V) / 1e6:.2f} MB; "
          f"whole-grid bound {bound_o * 1e3:.2f} us by {by_o}, "
          f"{observe_bytes(st0, obs_o) / 1e6:.2f} MB; zero_() of its "
          f"output {floor_o * 1e3:.2f} us; plain version "
          f"{plain_ms_o * 1e3:.1f} us)")

    # the shape each of phase 7's 2 ranks launches: B=2048 (a profiler
    # session late in the script drops records, so it is timed here)
    Bl = BATCH // P7_RANKS
    _, st_half = env.reset(g, Bl)
    a_half = torch.randint(0, 7, (1, Bl), generator=g, device="cuda",
                           dtype=torch.int32)
    run_half = lambda: _fused_rollout_cuda(p, st_half, a_half, False,
                                           rows1.grid, rows1.scal)
    ms_half = device_ms(run_half, 200)
    bound_half, by_half = bound_ms(launch_bytes(
        st_half, a_half, run_half(), rows1.grid, rows1.scal), Bl, V)
    a_half128 = torch.randint(0, 7, (128, Bl), generator=g, device="cuda",
                              dtype=torch.int32)
    run_half128 = lambda: _fused_rollout_cuda(p, st_half, a_half128, False,
                                              None, None)
    ms_half128 = device_ms(run_half128, 20)
    bound_half128, _ = bound_ms(launch_bytes(st_half, a_half128,
                                             run_half128()), Bl * 128, V)
    run_half_o = lambda: _fused_observe_cuda(p, st_half)
    ms_half_o = device_ms(run_half_o, 200, kernel="fused_observe_kernel")
    bound_half_o, _ = observe_bound_ms(st_half, run_half_o(), V)
    window_half_o, _ = observe_window_bound_ms(st_half, V)
    plain_half = cuda_ms(lambda: fused_rollout_reference(
        p, st_half, a_half, False, rows1.grid, rows1.scal), 10)
    plain_half128 = cuda_ms(lambda: fused_rollout_reference(
        p, st_half, a_half128, False), 1)
    plain_half_o = cuda_ms(lambda: fused_observe_reference(p, st_half), 10)
    g_half = launch_geometry(Bl, 8, 8, V, sms).group_lanes
    print(f"  a rank's B={Bl} (phase 7), {geometry(Bl)}: T=1 + row "
          f"{ms_half * 1e3:.2f} us (bound {bound_half * 1e3:.2f} us by "
          f"{by_half}, plain {plain_half * 1e3:.1f} us), T=128 "
          f"{ms_half128 * 1e3:.2f} us (bound {bound_half128 * 1e3:.2f} us, "
          f"plain {plain_half128 * 1e3:.1f} us), observe "
          f"{ms_half_o * 1e3:.2f} us (window bound "
          f"{window_half_o * 1e3:.2f} us, whole-grid bound "
          f"{bound_half_o * 1e3:.2f} us, plain {plain_half_o * 1e3:.1f} "
          f"us)")
    del st_half, a_half128

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
        # what one more step of the loop costs, apart from the launch and
        # the state copy in and out
        out["loop_ms_per_step"] = (out["ms_t128"] - out["ms_t1"]) / 127
        out["observe_bound_ms"], out["observe_bound_by"] = observe_bound_ms(
            s0, ro(), sv)
        (out["observe_window_bound_ms"],
         out["observe_window_bound_by"]) = observe_window_bound_ms(s0, sv)
        out["observe_floor_ms"] = zero_ms(ro(), 100)
        out["observe_launch_geometry"] = dataclasses.asdict(
            observe_launch_geometry(BATCH, sv, sms))
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
              f"{out['plain_ms_t128'] * 1e3:.1f} us); loop "
              f"{out['loop_ms_per_step'] * 1e3:.3f} us a step "
              f"((T=128 - T=1) / 127); observe, G="
              f"{out['observe_launch_geometry']['group_lanes']} "
              f"{out['observe_ms'] * 1e3:.2f} us (window bound "
              f"{out['observe_window_bound_ms'] * 1e3:.2f} us, whole-grid "
              f"bound {out['observe_bound_ms'] * 1e3:.2f} us, zero_() of "
              f"its output {out['observe_floor_ms'] * 1e3:.2f} us, plain "
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
    wfc["benchmark"]["launches"] = COUNTERS.launches
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
        per_step = (COUNTERS.launches // ROLLOUT_LEN,
                    COUNTERS.observe_launches // ROLLOUT_LEN)
        res = {"env_steps_per_s": BATCH * ROLLOUT_LEN / secs,
               "launches_per_step": per_step[0],
               "observe_launches_per_step": per_step[1],
               "wide_launches": COUNTERS.wide_launches,
               "wide_observe_launches": COUNTERS.wide_observe_launches}
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
    post_step_kernel = post_step_times()
    select_kernel = select_times()

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
    demo_launches = (COUNTERS.launches, COUNTERS.observe_launches)
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

    # --- 7. multi-device ------------------------------------------------
    multi_device = multi_device_phase(card, kind)
    # phase 7's launches, each counted from 0 just before its run: the
    # ranks' rollouts (7a: pooled, regen and fresh on 2 ranks; 7e: regen
    # and fresh on the (2, 2) mesh's 4) and train steps, and the
    # world-of-one train steps (7d: NCCL and gloo, f32 and bf16)
    p7_launches = (multi_device["ranks_launches"]
                   + multi_device["ranks_step_launches"]
                   + multi_device["world_of_one_launches"])

    # the train steps' launches, with phase 4b's and phase 7's
    vector_runs = surface["vector"]
    main_steps = (sum(t["launches"] for t in train.values())
                  + sum(v["launches"] for v in vector_runs.values())
                  + sum(n[0] for n in p7_launches))
    main_observes = (sum(t["observe_launches"] for t in train.values())
                     + sum(v["observe_launches"]
                           for v in vector_runs.values())
                     + sum(n[1] for n in p7_launches))

    def observe_shape(v):
        return {"ms": v["observe_ms"], "plain_ms": v["observe_plain_ms"],
                "bound_ms": v["observe_window_bound_ms"],
                "bound_by": v["observe_window_bound_by"],
                "grid_bound_ms": v["observe_bound_ms"],
                "grid_bound_by": v["observe_bound_by"],
                "floor_ms": v["observe_floor_ms"],
                "launch_geometry": v["observe_launch_geometry"]}

    kernels = [{
        "name": "fused_step",
        "route": "cuda",
        "source": "minigrid_tpu_torch/csrc/fused_step.cu",
        "replaces": "minigrid_tpu/ops/fused_step.py:58",
        "launches": main_steps,
        "launches_per_train_step": {k: t["launches_per_step"]
                                    for k, t in train.items()},
        "launches_pooled_rollout": launches,
        # phase 4b: each env.vector(4096) run (128 or 32 steps)
        "launches_vector": {k: v["launches"] for k, v in vector_runs.items()},
        # phase 7: each rank's rollout and train step at B=2048, and the
        # world-of-one steps (NCCL f32, gloo f32, NCCL bf16, gloo bf16)
        "launches_multi_device": {
            "rank_rollouts": [n[0] for n in multi_device["ranks_launches"]],
            "rank_train_steps": [n[0] for n in
                                 multi_device["ranks_step_launches"]],
            "world_of_one_train_steps": [
                n[0] for n in multi_device["world_of_one_launches"]]},
        "ms_b2048": ms_half, "bound_ms_b2048": bound_half,
        "plain_ms_b2048": plain_half,
        "ms_t128_b2048": ms_half128, "bound_ms_t128_b2048": bound_half128,
        "plain_ms_t128_b2048": plain_half128, "group_lanes_b2048": g_half,
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
        "loop_ms_per_step": loop1,
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
        "launches_vector": {k: v["observe_launches"]
                            for k, v in vector_runs.items()},
        "launches_bot": {short(k): v["launches"][1]
                         for k, v in bot_runs.items()},
        "launches_demos": demo_launches[1],
        # phase 7: the observe entry at a rank's B=2048
        "ms_b2048": ms_half_o, "bound_ms_b2048": window_half_o,
        "grid_bound_ms_b2048": bound_half_o,
        "plain_ms_b2048": plain_half_o,
        "max_abs_err": observe_err,
        "ms": ms_o,
        "plain_ms": plain_ms_o,
        # the bound from the bytes these states' windows need; beside it
        # the bound had the whole grid been read, and the device time of
        # zero_() on the same output (the launch floor)
        "bound_ms": window_o,
        "bound_by": window_by_o,
        "grid_bound_ms": bound_o,
        "floor_ms": floor_o,
        "library_ms": None,
        "shapes": {k: observe_shape(v) for k, v in shapes.items()},
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
        "bound_ms": dk33["observe_window_bound_ms"],
        "bound_by": dk33["observe_window_bound_by"],
        "grid_bound_ms": dk33["observe_bound_ms"],
        "floor_ms": dk33["observe_floor_ms"],
        "library_ms": None,
        "shapes": {k: observe_shape(v) for k, v in wide_shapes.items()},
    }]
    post_step_kernel["launches_per_train_step"] = {
        k: t["verify_launches_per_step"] for k, t in train.items()
        if "verify_launches_per_step" in t}  # the recurrent step's has none
    kernels.append(post_step_kernel)
    select_kernel["launches_per_train_step"] = {
        k: t["select_launches_per_step"] for k, t in train.items()
        if "select_launches_per_step" in t}
    kernels.append(select_kernel)
    print(json.dumps({"train_step": {k: {kk: vv for kk, vv in t.items()
                                         if kk != "metrics"}
                                     for k, t in train.items()},
                      "update_max_abs_err": update_err,
                      "rnn_update_max_abs_err": rnn_update_err,
                      "bot": bot_runs,
                      "generation": generated, "render": render_times,
                      "wrapped_stepping": stepping,
                      "wrappers": wrappers, "wfc": wfc,
                      "surface": surface,
                      "multi_device": multi_device}))
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
