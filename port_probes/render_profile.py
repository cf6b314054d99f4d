#!/usr/bin/env python3
"""Where a frame's time goes on one GPU: ``render.get_frame`` of DoorKey-8x8
states at B=4096, full (with and without the view cone) and POV, at tile 8
and 32, under ``torch.profiler``.

    python3 port_probes/render_profile.py [--batch 4096] [--reps 10]
        [--gathers]

Prints the card, then for each frame kind and tile size the device time of
a call (every kernel and copy it runs), its byte bound (the state and the
atlas read once, the frame written once, at 3.35 TB/s) and the device
kernels by total time, with their achieved bytes/s where the kernel writes
the frame. ``--gathers`` times, instead, ways of gathering the frame's
atlas rows (advanced indexing and ``index_select`` of pixel rows, or of
whole tiles followed by a transposing copy; in uint8, int32 and int64
words) at tile 8 and 32 by CUDA events, each checked equal to the first. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
VARIANTS = {"full": {}, "no highlight": {"highlight": False},
            "pov": {"agent_pov": True}}


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("render_profile: no CUDA device", file=sys.stderr)
        return 1
    import minigrid_tpu_torch as mt
    from minigrid_tpu_torch.render import get_atlas, get_frame

    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--gathers", action="store_true")
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {card} | torch {torch.__version__}")
    env = mt.make("MiniGrid-DoorKey-8x8-v0", device="cuda").packed()
    g = env.generator(0)
    _, st = env.reset(g, args.batch)
    if args.gathers:
        return gathers(torch, st, args.reps)
    for tile in (8, 32):
        for name, kw in VARIANTS.items():
            fn = lambda: get_frame(env.params, st, tile_size=tile, **kw)
            out = fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(args.reps):
                    fn()
                torch.cuda.synchronize()
            per_kernel = defaultdict(float)
            for e in prof.events():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    per_kernel[e.name] += e.time_range.elapsed_us()
            total = sum(per_kernel.values()) / args.reps
            moved = (sum(t.numel() * t.element_size() for t in (
                st.grid, st.agent_pos, st.agent_dir, st.carrying, out))
                + get_atlas(tile).nbytes)
            bound = moved / HBM_BYTES_PER_S * 1e6
            print(f"{name}, tile {tile}, B={args.batch}: {total:.2f} us of "
                  f"device time a call (bound {bound:.2f} us, "
                  f"{out.numel() / 1e6:.1f} MB written)")
            frame_bytes = out.numel()
            for k, us in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:5]:
                us /= args.reps
                rate = frame_bytes / (us * 1e-6) / 1e12
                print(f"  {us:9.2f} us  {k[:90]}  (frame bytes at "
                      f"{rate:.3f} TB/s)")
    return 0


def gathers(torch, st, reps: int) -> int:
    """Device time (CUDA events) of the frame's row gather, several ways."""
    from minigrid_tpu_torch.render.tiles import atlas_rows

    B, W, H = st.grid.shape[:3]
    for tile in (8, 32):
        rows_u8 = atlas_rows(tile, "cuda")
        n = rows_u8.shape[0]
        tiles = torch.randint(0, n // tile, (B, H, W), device="cuda")
        idx = (tiles[:, :, None, :] * tile + torch.arange(
            tile, device="cuda")[None, None, :, None]).contiguous()
        flat = idx.reshape(-1)
        want = None
        for word in (torch.uint8, torch.int32, torch.int64):
            src = rows_u8.view(word)
            whole = src.reshape(n // tile, -1)        # one tile a row
            ways = {"index": lambda: src[idx],
                    "index_select": lambda: src.index_select(0, flat),
                    "tiles, then permute": lambda: whole.index_select(
                        0, tiles.reshape(-1)).reshape(
                            B, H, W, tile, -1).transpose(2, 3).contiguous()}
            for name, fn in ways.items():
                out = fn()
                got = out.reshape(-1).view(torch.uint8)
                if want is None:
                    want = got.clone()
                if not torch.equal(got, want):
                    raise AssertionError(f"{name} {word} differs")
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                start.record()
                for _ in range(reps):
                    fn()
                stop.record()
                torch.cuda.synchronize()
                ms = start.elapsed_time(stop) / reps
                nbytes = want.numel()
                print(f"tile {tile}, {word}, {name}: {ms * 1e3:.2f} us "
                      f"({nbytes / 1e6:.1f} MB at "
                      f"{nbytes / (ms * 1e-3) / 1e12:.3f} TB/s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
