"""Benchmark CLI (reference minigrid/benchmark.py:13-133, extended).

Counterpart of ``minigrid_tpu/benchmark.py``. Reports the reference tool's
three single-env metrics (reset latency, full-frame render FPS, agent-view
step FPS) and the batched headline: env-steps/s of the port's pooled
auto-reset stepping at ``batch`` envs (the fused kernel's broadcast-row
entry on the card, one launch a step for an env without step hooks). On the
card every clock is read after a synchronisation::

    python -m minigrid_tpu_torch.benchmark --env-id MiniGrid-WFC-MazeSimple-v0
    python -m minigrid_tpu_torch.benchmark --device cpu --batch 64
"""

from __future__ import annotations

import argparse
import time

import torch

import minigrid_tpu_torch
from minigrid_tpu_torch.envs.base import random_keys
from minigrid_tpu_torch.render import get_frame


def _clock(device) -> float:
    """The host clock after the device's queued work has finished."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def benchmark(env_id: str, num_resets: int = 200, num_frames: int = 5000,
              batch: int = 4096, chunk: int = 128, device=None, profile_dir: str | None = None):
    """Run the metric suite on ``device`` (the card unless given). The
    batched phase draws resets from a pool of ``min(1024, batch)`` layouts.
    With ``profile_dir`` the batched phase runs under ``torch.profiler`` and its
    trace is written there (Chrome trace format)."""
    env = minigrid_tpu_torch.make(env_id, device=device)
    dev = env.device

    # reset latency (benchmark.py:16-21): one env from its seed's generator
    env.reset(env.generator(0), 1)
    t0 = _clock(dev)
    for i in range(num_resets):
        obs, state = env.reset(env.generator(i), 1)
    reset_ms = (_clock(dev) - t0) * 1000 / num_resets

    # full-frame rendering FPS (benchmark.py:23-29)
    get_frame(env.params, state)
    t0 = _clock(dev)
    for _ in range(num_frames):
        img = get_frame(env.params, state)
    render_fps = num_frames / (_clock(dev) - t0)
    del img

    # single-env step + agent-view RGB FPS (benchmark.py:31-43)
    g = env.generator(1)
    acts = torch.randint(0, env.num_actions, (num_frames, 1), generator=g,
                         device=dev, dtype=torch.int32)
    keys = random_keys(g, (num_frames, 1, 2), dev)
    st = state
    t0 = _clock(dev)
    for t in range(num_frames):
        _, st, *_ = env.step(keys[t], st, acts[t])
        img = get_frame(env.params, st, tile_size=8, agent_pov=True)
    view_fps = num_frames / (_clock(dev) - t0)

    # batched throughput: pooled auto-reset stepping of packed observations
    benv = env.packed()
    g = benv.generator(2)
    pool = benv.make_pool(g, min(1024, batch))  # the trainer's default pool
    _, bst = benv.reset_staggered(g, batch)
    acts = torch.randint(0, benv.num_actions, (chunk, batch), generator=g,
                         device=dev, dtype=torch.int32)
    keys = random_keys(g, (chunk, batch, 2), dev)

    def run(s):
        for t in range(chunk):
            s = benv.step_autoreset_pooled(keys[t], s, acts[t], pool, g)[1]
        return s

    bst = run(bst)  # warm-up
    repeats = 3
    if profile_dir is not None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=activities) as prof:
            bst = run(bst)
        trace = f"{profile_dir}/benchmark_trace.json"
        prof.export_chrome_trace(trace)
        print(f"profiler trace written to {trace}")
    t0 = _clock(dev)
    for _ in range(repeats):
        bst = run(bst)
    agg = repeats * chunk * batch / (_clock(dev) - t0)

    print(f"Env: {env_id} ({dev})")
    print(f"reset latency      : {reset_ms:.2f} ms")
    print(f"full render        : {render_fps:,.0f} FPS")
    print(f"agent-view steps   : {view_fps:,.0f} FPS (single env, tile 8)")
    print(f"batched throughput : {agg:,.0f} env-steps/s ({batch} envs, "
          f"pooled auto-reset)")
    return {
        "reset_ms": reset_ms,
        "render_fps": render_fps,
        "agent_view_fps": view_fps,
        "batched_steps_per_s": agg,
    }


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--env-id", type=str,
                        default="MiniGrid-LavaGapS7-v0")
    parser.add_argument("--num-resets", type=int, default=200)
    parser.add_argument("--num-frames", type=int, default=5000)
    parser.add_argument("--batch", type=int, default=4096)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the card)")
    parser.add_argument("--profile", type=str, default=None, metavar="DIR",
                        help="write a torch.profiler trace of the batched "
                             "phase to DIR")
    args = parser.parse_args()
    benchmark(args.env_id, args.num_resets, args.num_frames, args.batch,
              device=args.device, profile_dir=args.profile)


if __name__ == "__main__":
    main()
