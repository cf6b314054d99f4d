"""The yardstick's counts: the train step's FLOPs and the env step's
bytes, against the numbers the repository already stated."""

import itertools

import pytest
import torch

from bench_test_util import ROOT

from harness import counts as CT
from harness import peaks
from harness.manifest import Bench


def test_train_step_flops_of_doorkey():
    cfg = Bench(ROOT).cell("doorkey8x8.train_pooled")["config"]
    p, ppo = cfg["policy"], cfg["ppo"]
    # 1176*256 + 64*64 + 324*256 + 256*256 + 256*7 + 256 multiply-adds
    assert CT.policy_macs(7, 256, 64, 64, 7) == 455_680
    flops = CT.train_step_flops(p, ppo["num_envs"], ppo["rollout_len"],
                                ppo["num_epochs"])
    assert flops == 4 * 2 * 455_680 * 4096 * 128
    assert flops == pytest.approx(1.9e12, rel=0.01)


def test_step_bytes_give_the_kernels_stated_bound():
    # DoorKey-8x8, B=4096, T=1 with a reset row: 1.09 us at 3.35 TB/s
    moved = 4096 * CT.env_step_bytes(8, 8, 7) + CT.reset_row_bytes(8, 8)
    assert moved == 4096 * 890 + 288
    assert moved / peaks.HBM_BYTES_PER_S * 1e6 == pytest.approx(1.0883,
                                                                abs=1e-4)


def _window_cells_brute(W, H, V, pos, d):
    fx, fy = [(1, 0), (0, 1), (-1, 0), (0, -1)][d]
    rx, ry = -fy, fx
    tlx = pos[0] + fx * (V - 1) - rx * (V // 2)
    tly = pos[1] + fy * (V - 1) - ry * (V // 2)
    cells = {(tlx + rx * i - fx * j, tly + ry * i - fy * j)
             for i in range(V) for j in range(V)}
    return sum(0 <= x < W and 0 <= y < H for x, y in cells)


@pytest.mark.parametrize("W, H, V", [(8, 8, 7), (25, 25, 7), (16, 8, 9),
                                     (5, 5, 3)])
def test_window_cells_count_the_in_grid_cells(W, H, V):
    poses = list(itertools.product(range(W), range(H), range(4)))
    pos = torch.tensor([[x, y] for x, y, _ in poses])
    d = torch.tensor([k for _, _, k in poses])
    want = sum(_window_cells_brute(W, H, V, (x, y), k) for x, y, k in poses)
    assert CT.window_cells(W, H, V, pos, d) == want
    assert CT.observe_read_bytes(W, H, V, pos, d) == 5 * want + 17 * len(
        poses)
