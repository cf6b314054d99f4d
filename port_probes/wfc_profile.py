#!/usr/bin/env python3
"""Where WFC generation's time goes on one GPU: one solver attempt of a
batch of each ID under ``torch.profiler``.

    python3 port_probes/wfc_profile.py [--batch 4096] [--ids A,B,...]

Prints the card, then for each ID the generation time and counters of
``chip_smoke.wfc_generation`` (seconds per batch, host syncs, ticks, the
most collapses, passes and attempts, envs not ok), and for one attempt of
the batch the device kernels and copies a tick, the device and host time a
tick, the device's busy share and the kernels by device time a tick.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

IDS = ("MiniGrid-WFC-MazeSimple-v0,MiniGrid-WFC-DungeonMazeScaled-v0,"
       "MiniGrid-WFC-RoomsFabric-v0,MiniGrid-WFC-ObstaclesBlackdots-v0,"
       "MiniGrid-WFC-ObstaclesAngular-v0,MiniGrid-WFC-ObstaclesHogs3-v0")


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("wfc_profile: no CUDA device", file=sys.stderr)
        return 1
    import minigrid_tpu_torch as mt
    from minigrid_tpu_torch.envs.base import random_keys
    from minigrid_tpu_torch.envs.wfc import solver as S

    from chip_smoke import wfc_generation

    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--ids", default=IDS)
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {card} | torch {torch.__version__}")
    for env_id in args.ids.split(","):
        print(f"{env_id} B={args.batch}: "
              f"{wfc_generation(env_id, 'cuda', args.batch)}")
        env = mt.make(env_id, device="cuda")
        g = env.generator(0)
        p = env.params
        keys = random_keys(g, (args.batch, 2), "cuda")
        c = env.config
        kw = dict(loc_heuristic=c.loc_heuristic,
                  choice_heuristic=c.choice_heuristic,
                  backtracking=c.backtracking,
                  global_constraint=c.global_constraint)
        shape = (p.height - 2, p.width - 2)
        S.COUNTERS.reset()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            S.solve(keys, env._adj, env._weights, shape, c.output_periodic,
                    **kw)
            torch.cuda.synchronize()
            host = time.perf_counter() - t0
        ticks = S.COUNTERS.ticks
        ev = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.time_range.elapsed_us() for e in ev) / 1e6
        copies = sum(e.name.startswith(("Memcpy", "Memset")) for e in ev)
        by_name = defaultdict(float)
        for e in ev:
            by_name[e.name[:60]] += e.time_range.elapsed_us()
        print(f"  one attempt under the profiler: {ticks} ticks, "
              f"{(len(ev) - copies) / ticks:.1f} device kernels + "
              f"{copies / ticks:.2f} copies a tick, device "
              f"{busy / ticks * 1e3:.3f} ms a tick, host "
              f"{host / ticks * 1e3:.3f} ms a tick, busy share "
              f"{busy / host:.3f} ({card})")
        for name, us in sorted(by_name.items(), key=lambda x: -x[1])[:8]:
            print(f"    {us / ticks:9.1f} us/tick  {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
