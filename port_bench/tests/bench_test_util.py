"""Shared by the benchmark's tests: the import paths, the tiny sizes a CPU
run of each cell takes, and the fixture that skips a card test."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

# a CPU run of a cell: the same code at a size a test can hold
TINY = {
    "doorkey8x8.train_pooled": {"ppo": {"num_envs": 64, "rollout_len": 16},
                                "train": {"pool_size": 32,
                                          "pool_refresh_every": 2}},
    "doorkey8x8.vector_regen": {"traffic": {"num_envs": 64}},
    "putnextlocal.train_fresh": {"ppo": {"num_envs": 64, "rollout_len": 16}},
}


def run_tiny(cell, seed=3, seconds=0.5, trace=False, root=ROOT, sizes=None):
    import torch

    from harness.runner import run_cell

    torch.set_num_threads(2)
    return run_cell(root, cell, seed, seconds, trace, device="cpu",
                    sizes=TINY[cell] if sizes is None else sizes)


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
