"""The CUDA fused step kernel against its plain PyTorch version on the
card, bit-exact on every output. Marked ``gpu``: they skip without a CUDA
device. The file imports no JAX, so it also runs where only PyTorch is
installed (``pytest tests/test_torch_kernel_gpu.py -m gpu --noconftest``)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import minigrid_tpu_torch
from minigrid_tpu_torch.ops.fused_step import (GROUP_LANES, KERNEL,
                                               _fused_rollout_cuda,
                                               fused_rollout,
                                               fused_rollout_reference,
                                               launch_geometry, sm_count)

# interaction-biased action stream of tests/test_fused_step.py
INTERACT = np.array([0, 1, 2, 2, 3, 4, 5, 5], np.int32)


@pytest.fixture
def cuda_device():
    """The card; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("env_id,kind,B,reset", [
    ("MiniGrid-DoorKey-8x8-v0", "uniform", 4096, False),
    ("MiniGrid-Empty-8x8-v0", "uniform", 4096, False),
    ("MiniGrid-DoorKey-5x5-v0", "interact", 4096, False),
    ("MiniGrid-DoorKey-8x8-v0", "uniform", 4000, False),
    ("MiniGrid-DoorKey-8x8-v0", "uniform", 4096, True),
    ("MiniGrid-DoorKey-16x16-v0", "interact", 1000, True),
])
def test_kernel_matches_plain_on_card(cuda_device, env_id, kind, B, reset):
    _check_case(cuda_device, env_id, kind, B, reset)


@pytest.mark.gpu
@pytest.mark.parametrize("view,B,reset,group_lanes", [
    (3, 4096, False, None),
    (9, 4096, False, None),
    (9, 1001, True, None),
    (7, 4100, True, None),
    *[(7, 1001, True, g) for g in GROUP_LANES],
])
def test_kernel_view_sizes_and_group_widths_on_card(cuda_device, view, B,
                                                    reset, group_lanes):
    """DoorKey-8x8 at other view sizes, at batches that are not a multiple
    of the envs per block, and at every group width G."""
    env = minigrid_tpu_torch.make("MiniGrid-DoorKey-8x8-v0",
                                  device=cuda_device).packed()
    env = env.replace_params(view_size=view)
    if B != 4096:  # a ragged last block
        geo = launch_geometry(B, 8, 8, view, sm_count(cuda_device),
                              group_lanes)
        assert B % geo.envs_per_block != 0
    _check_case(cuda_device, env, "interact", B, reset, group_lanes)


def _check_case(device, env, kind, B, reset, group_lanes=None, T=32):
    """One launch of the kernel against the plain version, bit-exact."""
    if isinstance(env, str):
        env = minigrid_tpu_torch.make(env, device=device).packed()
    g = env.generator(0)
    _, st = (env.reset_staggered if reset else env.reset)(g, B)
    rng = np.random.default_rng(1)
    choices = INTERACT if kind == "interact" else np.arange(7)
    actions = torch.from_numpy(choices[rng.integers(0, len(choices), (T, B))]
                               .astype(np.int32)).to(device)
    rg = rs = None
    if reset:
        rows = env.make_pool(g, 64).rows(
            torch.randint(0, 64, (T,), generator=g, device=device))
        rg, rs = rows.grid, rows.scal
    launches = KERNEL.launches
    if group_lanes is None:
        got = fused_rollout(env.params, st, actions, False, rg, rs)
    else:
        got = _fused_rollout_cuda(env.params, st, actions, False, rg, rs,
                                  group_lanes)
    torch.cuda.synchronize()
    assert KERNEL.launches == launches + 1
    want = fused_rollout_reference(env.params, st, actions, False, rg, rs)
    for k, v in want[0].tensors().items():
        assert torch.equal(getattr(got[0], k), v), k
    for name, a, b in zip(("obs", "reward", "term", "trunc"), got[1:],
                          want[1:]):
        assert torch.equal(a, b), name
