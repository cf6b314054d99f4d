from minigrid_tpu_torch.utils.baby_ai_bot import BabyAIBot
from minigrid_tpu_torch.utils.checkpoint import (
    restore_pytree,
    save_pytree,
    state_fingerprint,
)

__all__ = ["BabyAIBot", "save_pytree", "restore_pytree", "state_fingerprint"]
