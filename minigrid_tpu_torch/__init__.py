"""minigrid_tpu_torch — the PyTorch/CUDA port of minigrid_tpu.

Batched gridworld environments as tensors with a leading batch axis, stepped
on an NVIDIA GPU by a hand-written CUDA kernel (``csrc/fused_step.cu``) with a
plain PyTorch version for the CPU. Imports no JAX: the JAX package
``minigrid_tpu`` is its reference, and only the tests import both.
"""

from minigrid_tpu_torch.core.actions import Actions
from minigrid_tpu_torch.core.types import EnvParams, EnvState
from minigrid_tpu_torch.envs.base import (
    LayoutPool,
    make_layout_pool,
    refresh_layout_pool,
)
from minigrid_tpu_torch.registry import make, register, registered_ids
from minigrid_tpu_torch import register_envs as _register_envs

_register_envs.register_all()

__version__ = "0.1.0"

__all__ = [
    "Actions",
    "EnvParams",
    "EnvState",
    "LayoutPool",
    "MissionSpace",
    "make",
    "make_layout_pool",
    "refresh_layout_pool",
    "register",
    "registered_ids",
]


def __getattr__(name):
    # MissionSpace subclasses gymnasium's Space where gymnasium is
    # installed, so it is imported at its first use: the package itself
    # imports no gymnasium
    if name == "MissionSpace":
        from minigrid_tpu_torch.core.mission_space import MissionSpace

        return MissionSpace
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
