#!/usr/bin/env python3
"""Where the port's time goes on one GPU: the main-path rollout under
``torch.profiler``, the PPO train step in each reset mode, the fused step
kernel at the main path's batch and at a batch that fills the card, and a
sweep of the kernel's group width G.

    python3 port_probes/rollout_profile.py [--steps 16] [--train-only]
                                           [--sweep-only]
                                           [--span-split [--seed N]
                                            [--cell NAME]]

Prints the card, the host time per rollout step, the device busy share
(union of kernel intervals over the profiled wall time), the top device
kernels by total time, and the kernel's time per launch (CUDA events) at
T=1 and T=128, with the public and the kernel-native observation layout,
and pure stepping throughput at B=4096 and B=65536 (device time, one T=128
launch). Then the sweep: the kernel's device time per launch (profiler) at
every group width G, at B=4096, 16384 and 65536, T=1 with a reset row and
T=128, beside the G that ``launch_geometry`` picks; and the same at shapes whose
blocks take most of an SM's shared memory: the 64-bit view rows' timed
shapes (``chip_smoke.WIDE_SHAPES``: DoorKey-8x8 at view 33, MultiRoom-N6's
25x25 at view 63) at B=4096 and MultiRoom-N6 at view 7 at B=16384 and
65536, at every G whose block fits. Last the observe entry at every G its
own geometry takes, on ``chip_smoke``'s timed shapes at B=4096 and on
DoorKey-8x8 at B=2048 and 65536. ``--sweep-only`` runs the sweeps alone.
``--train-only``
profiles only the train step: one step of DoorKey-8x8 at B=4096, T=128,
bf16 hidden=256, ``PPOConfig()`` per reset mode, with its host time, device
kernels, device busy share and top kernels; ``--families`` adds the train
steps of ``chip_smoke.FAMILY_TRAIN`` (MultiRoom-N6 pooled,
Dynamic-Obstacles-16x16 pooled, Fetch-8x8-N3 fresh, BabyAI-GoToObj and
BabyAI-PutNextLocal fresh, KeyCorridorS6R3 pooled; a BabyAI batch staggered
and its fresh buffer sized as ``chip_smoke.stagger_budget`` does). Needs a
CUDA device. ``--span-split`` runs only a PutNextLocal fresh train step as
the benchmark's ``train_fresh`` cell runs it (B=4096, T=128, ``PPOConfig()``,
bf16 ``ActorCritic(256)``, staggered and buffered by
``chip_smoke.stagger_budget``), one warm-up and ``--steps`` timed under
``trace.enable()`` (no profiler): the host ms a step of each program span,
and the BabyAI post-step kernel's launches against the level's
``_post_step`` calls, as one JSON line; it needs nothing newer than the
program's spans, so a copy of this file splits an older checkout's step.
With ``--cell NAME`` it splits the train step of the benchmark's cell
``NAME`` instead (``port_bench/``'s driver builds it from ``--seed``, its
checked steps are the warm-up), and adds the moves of the program's
``policy.*`` and ``kernel.*`` counters where it has them.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def busy_share(events, wall_us: float) -> float:
    """Fraction of ``wall_us`` covered by at least one device kernel."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    covered, end = 0.0, -1.0
    for s, e in spans:
        if e <= end:
            continue
        covered += e - max(s, end)
        end = e
    return covered / wall_us


def profile_rollout(env, g, pool, B: int, T: int, card: str) -> None:
    """The rollout under the profiler, then the kernel alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import device_ms
    from minigrid_tpu_torch.models.actor_critic import ActorCritic, init_params
    from minigrid_tpu_torch.models.ppo import rollout, sample_rollout_noise
    from minigrid_tpu_torch.ops import fused_step as F

    obs, st = env.reset_staggered(g, B)
    model = init_params(ActorCritic(device="cuda"), g)
    st, obs, _, _ = rollout(model, env, st, obs,
                            sample_rollout_noise(g, pool, B, 8, 7))
    noise = sample_rollout_noise(g, pool, B, T, 7)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st, obs, _, _ = rollout(model, env, st, obs, noise)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    print(f"rollout B={B} T={T} under the profiler: "
          f"{wall / T * 1e3:.3f} ms/step host, "
          f"{len(dev) / T:.1f} device kernels/step, device busy "
          f"{busy_share(dev, wall * 1e6):.3f} of wall ({card})")
    totals = {}
    for e in dev:
        n, us = totals.get(e.name, (0, 0.0))
        totals[e.name] = (n + 1, us + e.time_range.elapsed_us())
    top = sorted(totals.items(), key=lambda kv: -kv[1][1])[:12]
    for name, (n, us) in top:
        print(f"  {us / T:9.2f} us/step  {n / T:5.1f}/step  {name[:90]}")

    def ms_per_launch(fn, reps):
        fn()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    _, st0 = env.reset(g, B)
    row = pool.rows(0)
    a1 = torch.randint(0, 7, (1, B), generator=g, device="cuda",
                       dtype=torch.int32)
    a128 = torch.randint(0, 7, (128, B), generator=g, device="cuda",
                         dtype=torch.int32)
    for native in (False, True):
        t1 = ms_per_launch(lambda: F._fused_rollout_cuda(
            env.params, st0, a1, native, row.grid, row.scal), 200)
        t128 = ms_per_launch(lambda: F._fused_rollout_cuda(
            env.params, st0, a128, native, None, None), 20)
        print(f"kernel, {'native' if native else 'public'} obs layout: "
              f"T=1 with reset row {t1 * 1e3:.2f} us, T=128 "
              f"{t128 * 1e3:.2f} us (CUDA events, back to back; {card})")
    for batch in (4096, 65536):
        _, stb = env.reset(g, batch)
        ab = torch.randint(0, 7, (128, batch), generator=g, device="cuda",
                           dtype=torch.int32)
        ms = device_ms(lambda: F._fused_rollout_cuda(
            env.params, stb, ab, False, None, None), 5)
        print(f"kernel device time, B={batch} T=128: {ms * 1e3:.1f} us = "
              f"{batch * 128 / ms * 1e3:.3e} env-steps/s ({card})")


def profile_train_steps(card: str, cases) -> None:
    """One full-width train step per (env id, reset mode, fresh buffer
    rows) case under the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import minigrid_tpu_torch as mt
    from chip_smoke import stagger_budget
    from minigrid_tpu_torch.models.actor_critic import ActorCritic, init_params
    from minigrid_tpu_torch.models.ppo import (PPOConfig, make_optimizer,
                                               make_train_step)

    cfg = PPOConfig()
    for env_id, mode, fresh_buffer in cases:
        env = mt.make(env_id, device="cuda").packed()
        g = env.generator(0)
        model = init_params(ActorCritic(device="cuda"), g)
        opt = make_optimizer(model, cfg)
        pool = env.make_pool(g, 1024) if mode == "pooled" else None
        obs, st = env.reset_staggered(g, cfg.num_envs)
        st, fresh_buffer = stagger_budget(env, st, g, fresh_buffer)
        step = make_train_step(env, model, cfg, opt, resets=mode,
                               fresh_buffer=fresh_buffer)
        st, obs, _ = step(st, obs, g, pool)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            st, obs, _ = step(st, obs, g, pool)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(e.time_range.elapsed_us() for e in dev)
        print(f"train step, {env_id} {mode} resets, B={cfg.num_envs} "
              f"T={cfg.rollout_len} under the profiler: {wall * 1e3:.1f} ms "
              f"host, {len(dev)} device kernels, device busy "
              f"{busy_share(dev, wall * 1e6):.3f} of wall "
              f"({busy_us / 1e3:.2f} ms of kernels; {card})")
        totals = {}
        for e in dev:
            n, us = totals.get(e.name, (0, 0.0))
            totals[e.name] = (n + 1, us + e.time_range.elapsed_us())
        top = sorted(totals.items(), key=lambda kv: -kv[1][1])[:8]
        for name, (n, us) in top:
            print(f"  {us / 1e3:8.3f} ms  {n:6d}x  {name[:90]}")
        del model, opt, step, st, obs


def sweep_group_lanes(env, g, pool, card: str) -> None:
    """Device time per launch at every G, three batches, T=1 and T=128."""
    import torch

    from chip_smoke import device_ms
    from minigrid_tpu_torch.ops import fused_step as F

    sms = F.sm_count(torch.device("cuda"))
    row = pool.rows(0)
    print(f"group-width sweep, DoorKey-8x8, device time per launch in us "
          f"({card}, {sms} SMs):")
    for batch in (4096, 16384, 65536):
        _, stb = env.reset(g, batch)
        for steps in (1, 128):
            ab = torch.randint(0, 7, (steps, batch), generator=g,
                               device="cuda", dtype=torch.int32)
            rg, rs = (row.grid, row.scal) if steps == 1 else (None, None)
            times = []
            for G in F.GROUP_LANES:
                ms = device_ms(lambda: F._fused_rollout_cuda(
                    env.params, stb, ab, False, rg, rs, G),
                    50 if steps == 1 else 5)
                times.append(f"G={G} {ms * 1e3:.2f}")
            picked = F.launch_geometry(batch, 8, 8, 7, sms).group_lanes
            reset = " with reset row" if steps == 1 else ""
            print(f"  B={batch} T={steps}{reset}: {', '.join(times)}; "
                  f"picked G={picked}")


def sweep_big_blocks(card: str) -> None:
    """The step entry's device time per launch at every G that fits, at
    shapes whose blocks take most of an SM's shared memory: T=1 with a
    reset row, T=128."""
    import torch

    import minigrid_tpu_torch as mt
    from chip_smoke import WIDE_SHAPES, device_ms
    from minigrid_tpu_torch.ops import fused_step as F

    sms = F.sm_count(torch.device("cuda"))
    print(f"group-width sweep at large blocks, device time per launch in us "
          f"({card}, {sms} SMs):")
    multiroom = "MiniGrid-MultiRoom-N6-v0"
    shapes = [(name, env_id, view, 4096) for name, env_id, view in WIDE_SHAPES]
    shapes += [("MultiRoom-N6 25x25 view 7", multiroom, 7, b)
               for b in (16384, 65536)]
    for name, env_id, view, batch in shapes:
        env = mt.make(env_id, device="cuda").packed().replace_params(
            view_size=view)
        p, g = env.params, env.generator(0)
        _, stb = env.reset(g, batch)
        row = env.make_pool(g, 16).rows(0)
        a1, a128 = (torch.randint(0, 7, (t, batch), generator=g,
                                  device="cuda", dtype=torch.int32)
                    for t in (1, 128))
        for G in F.GROUP_LANES:
            try:
                geo = F.launch_geometry(batch, p.width, p.height, view, sms,
                                        G)
            except ValueError:
                continue
            t1 = device_ms(lambda: F._fused_rollout_cuda(
                p, stb, a1, False, row.grid, row.scal, G), 50)
            t128 = device_ms(lambda: F._fused_rollout_cuda(
                p, stb, a128, False, None, None, G), 5)
            print(f"  {name}, B={batch}: G={G} ({geo.envs_per_block} envs, "
                  f"{geo.threads // 32} warps, {geo.shared_memory_bytes} B a "
                  f"block): T=1 with reset row {t1 * 1e3:.2f}, T=128 "
                  f"{t128 * 1e3:.2f}")
        picked = F.launch_geometry(batch, p.width, p.height, view, sms)
        print(f"  {name}, B={batch}: picked G={picked.group_lanes} "
              f"({picked.envs_per_block} envs a block)")


def sweep_observe(card: str) -> None:
    """The observe entry's device time per launch at every G its geometry
    takes (``observe_launch_geometry``), at B=4096 on the timed shapes of
    ``chip_smoke`` (8x8, ``SHAPES``, ``WIDE_SHAPES``) and on DoorKey-8x8
    at a rank's B=2048 and at B=65536, beside the G it picks."""
    import torch

    import minigrid_tpu_torch as mt
    from chip_smoke import ENV_ID, SHAPES, WIDE_SHAPES, device_ms
    from minigrid_tpu_torch.ops import fused_step as F

    sms = F.sm_count(torch.device("cuda"))
    print(f"observe entry, group-width sweep, device time per launch in us "
          f"({card}, {sms} SMs):")
    shapes = [("DoorKey-8x8", ENV_ID, None, b) for b in (4096, 2048, 65536)]
    shapes += [(name, env_id, None, 4096) for name, env_id, _ in SHAPES]
    shapes += [(name, env_id, view, 4096)
               for name, env_id, view in WIDE_SHAPES]
    for name, env_id, view, batch in shapes:
        env = mt.make(env_id, device="cuda").packed()
        if view is not None:
            env = env.replace_params(view_size=view)
        p = env.params
        _, stb = env.reset(env.generator(0), batch)
        times = []
        for G in F.GROUP_LANES:
            try:
                geo = F.observe_launch_geometry(batch, p.view_size, sms, G)
            except ValueError:
                continue
            ms = device_ms(lambda: F._fused_observe_cuda(p, stb, G), 50,
                           kernel="fused_observe_kernel")
            times.append(f"G={G} ({geo.envs_per_block} envs) "
                         f"{ms * 1e3:.2f}")
        picked = F.observe_launch_geometry(batch, p.view_size, sms)
        print(f"  {name}, B={batch}: {', '.join(times)}; picked "
              f"G={picked.group_lanes} ({picked.envs_per_block} envs)")


def span_split(card: str, steps: int, seed: int) -> dict:
    """The host split of a PutNextLocal fresh train step by the program's
    spans (see the module's docstring)."""
    import torch

    import chip_smoke as cs
    import minigrid_tpu_torch as mt
    from minigrid_tpu_torch.models.actor_critic import (ActorCritic,
                                                        init_params)
    from minigrid_tpu_torch.models.ppo import (PPOConfig, make_optimizer,
                                               make_train_step)
    from minigrid_tpu_torch.utils import trace

    env = mt.make("BabyAI-PutNextLocal-v0", device="cuda").packed()
    g = env.generator(seed)
    cfg = PPOConfig()
    model = init_params(ActorCritic(hidden=256, dtype=torch.bfloat16,
                                    device="cuda"), g)
    opt = make_optimizer(model, cfg)
    obs, st = env.reset_staggered(g, cfg.num_envs)
    st, fresh_buffer = cs.stagger_budget(env, st, g, "budget")
    step = make_train_step(env, model, cfg, opt, resets="fresh",
                           fresh_buffer=fresh_buffer)
    post_steps = [0]
    level_post_step = env._post_step

    def counted(*a):
        post_steps[0] += 1
        return level_post_step(*a)

    env._post_step = counted
    st, obs, _ = step(st, obs, g)                              # warm-up
    torch.cuda.synchronize()
    launches = trace.counters().get("kernel.verify_launches", 0)
    post_steps[0] = 0
    trace.clear()
    trace.enable()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        st, obs, _ = step(st, obs, g)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    trace.disable()
    summary = trace.summary()
    trace.clear()
    hooks = summary["env.hooks"]
    return {"card": card, "seed": seed, "steps": steps,
            "step_ms": sorted(1e3 * t for t in times),
            "spans_ms_a_step": {k: {"calls": v["calls"] / steps,
                                    "ms": v["ms"] / steps,
                                    "self_ms": v["self_ms"] / steps}
                                for k, v in summary.items()},
            "verify_launches": trace.counters().get(
                "kernel.verify_launches", 0) - launches,
            "post_step_calls": post_steps[0],
            "env_kernel_host_us": 1e3 * summary["env.kernel"]["ms"]
            / summary["env.kernel"]["calls"],
            "hooks_host_us_a_call": 1e3 * hooks["ms"] / hooks["calls"]}


def cell_span_split(card: str, cell: str, steps: int, seed: int) -> dict:
    """The host split of a train step of the benchmark's cell ``cell`` by
    the program's spans, after the cell's own set-up."""
    import torch

    from minigrid_tpu_torch.utils import trace

    root = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root / "port_bench"))
    from harness.manifest import Bench
    from harness.runner import Run, pin_caches

    pin_caches(root)
    bench = Bench(root)
    entry = bench.cell(cell)
    run = Run(bench=bench, cell=entry, seed=seed, seconds=0.0, trace=False,
              device="cuda", t_start=time.perf_counter())
    loop = bench.driver(entry["driver"]).make(run)
    loop.setup()
    torch.cuda.synchronize()
    before = trace.counters()
    trace.clear()
    trace.enable()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        loop.st, loop.obs, _ = loop.step(loop.st, loop.obs, loop.g,
                                         loop.pool)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    trace.disable()
    summary = trace.summary()
    trace.clear()
    after = trace.counters()
    return {"card": card, "cell": cell, "seed": seed, "steps": steps,
            "step_ms": sorted(1e3 * t for t in times),
            "spans_ms_a_step": {k: {"calls": v["calls"] / steps,
                                    "ms": v["ms"] / steps,
                                    "self_ms": v["self_ms"] / steps}
                                for k, v in summary.items()},
            "counters_a_step": {k: (after[k] - before.get(k, 0)) / steps
                                for k in after
                                if k.startswith(("policy.", "gen.levels",
                                                 "kernel."))}}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--train-only", action="store_true")
    ap.add_argument("--families", action="store_true")
    ap.add_argument("--sweep-only", action="store_true")
    ap.add_argument("--span-split", action="store_true")
    ap.add_argument("--seed", type=int, default=2718281829)
    ap.add_argument("--cell", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1

    import minigrid_tpu_torch as mt

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}")
    if args.span_split:
        print(json.dumps(
            span_split(card, args.steps, args.seed) if args.cell is None
            else cell_span_split(card, args.cell, args.steps, args.seed)))
        return 0
    env = mt.make("MiniGrid-DoorKey-8x8-v0", device="cuda").packed()
    g = env.generator(0)
    pool = env.make_pool(g, 1024)
    if args.sweep_only:
        sweep_group_lanes(env, g, pool, card)
        sweep_big_blocks(card)
        sweep_observe(card)
        return 0
    cases = [("MiniGrid-DoorKey-8x8-v0", mode, None)
             for mode in ("pooled", "fresh", "regen")]
    if args.families:
        from chip_smoke import FAMILY_TRAIN
        cases += FAMILY_TRAIN
    profile_train_steps(card, cases)
    if args.train_only:
        return 0
    profile_rollout(env, g, pool, 4096, args.steps, card)
    sweep_group_lanes(env, g, pool, card)
    sweep_big_blocks(card)
    sweep_observe(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
