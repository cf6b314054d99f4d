#!/usr/bin/env python3
"""Device time per launch of the fused step kernel's entries at the shapes
``PERF.md`` §6 tracks, as one JSON line: the step entry at T=1 (with the
reset row where the family's pooled step takes one) and T=128, and the
observe entry, at B=4096 on DoorKey-8x8 and on ``chip_smoke``'s timed
shapes (``SHAPES``, ``WIDE_SHAPES``) and at ``BYTE_PATH_SHAPES`` (grids of
W*H*5 bytes that are no multiple of 16, added here too so that a copy run
in an older checkout times them), DoorKey-8x8 also at B=2048 and, T=128
only, B=65536. Each step-entry shape also gets the loop's cost a step,
(T=128 - T=1) / 127.

    python3 port_probes/kernel_times.py

It uses only names the kernel's wrapper has long had (``_fused_rollout_cuda``,
``_fused_observe_cuda``, ``chip_smoke.device_ms``), so a copy of it in an
older checkout's ``port_probes/`` times that checkout's kernel: two trees
are compared on one card in turns (parent, change, change, parent). Needs
a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

BYTE_PATH_SHAPES = [("FourRooms 19x19", "MiniGrid-FourRooms-v0", True),
                    ("LavaCrossingS9N2 9x9", "MiniGrid-LavaCrossingS9N2-v0",
                     True),
                    ("Empty-5x5", "MiniGrid-Empty-5x5-v0", True)]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import minigrid_tpu_torch as mt
    from chip_smoke import ENV_ID, SHAPES, WIDE_SHAPES, device_ms
    from minigrid_tpu_torch.ops import fused_step as F

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    F.LIBRARY.load()
    cases = [("DoorKey-8x8", ENV_ID, True, None, 4096),
             ("DoorKey-8x8 B=2048", ENV_ID, True, None, 2048)]
    cases += [(name, env_id, row, None, 4096)
              for name, env_id, row in SHAPES + [
                  s for s in BYTE_PATH_SHAPES if s not in SHAPES]]
    cases += [(name, env_id, True, view, 4096)
              for name, env_id, view in WIDE_SHAPES]
    times = {}
    for name, env_id, with_row, view, batch in cases:
        env = mt.make(env_id, device="cuda").packed()
        if view is not None:
            env = env.replace_params(view_size=view)
        g = env.generator(9)
        p = env.params
        _, st = env.reset(g, batch)
        row = env.make_pool(g, 16).rows(0)
        rg, rs = (row.grid, row.scal) if with_row else (None, None)
        a1, a128 = (torch.randint(0, 7, (t, batch), generator=g,
                                  device="cuda", dtype=torch.int32)
                    for t in (1, 128))
        times[name] = {
            "t1_us": 1e3 * device_ms(lambda: F._fused_rollout_cuda(
                p, st, a1, False, rg, rs), 100),
            "t128_us": 1e3 * device_ms(lambda: F._fused_rollout_cuda(
                p, st, a128, False, None, None), 10),
            "observe_us": 1e3 * device_ms(lambda: F._fused_observe_cuda(
                p, st), 100, kernel="fused_observe_kernel")}
        times[name]["loop_us"] = (times[name]["t128_us"]
                                  - times[name]["t1_us"]) / 127
    env = mt.make(ENV_ID, device="cuda").packed()
    g = env.generator(9)
    _, st = env.reset(g, 65536)
    a128 = torch.randint(0, 7, (128, 65536), generator=g, device="cuda",
                         dtype=torch.int32)
    times["DoorKey-8x8 B=65536"] = {"t128_us": 1e3 * device_ms(
        lambda: F._fused_rollout_cuda(env.params, st, a128, False, None,
                                      None), 5)}
    print(json.dumps({"card": card, "source": str(F.SOURCE),
                      "times": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
