"""The fused step kernel (``csrc/fused_step.cu``) and its wrappers.

``fused_step.fused_rollout`` runs T steps of every env, transition and
observation, in one launch of the hand-written CUDA kernel on the card
(its plain PyTorch version on the CPU); the kernel is built at its first
launch, never at import.
"""

from minigrid_tpu_torch.ops.fused_step import (fused_rollout,
                                               require_core_dynamics)

__all__ = ["fused_rollout", "require_core_dynamics"]
