from minigrid_tpu_torch.utils.checkpoint import (
    restore_pytree,
    save_pytree,
    state_fingerprint,
)

__all__ = ["BabyAIBot", "save_pytree", "restore_pytree", "state_fingerprint"]


def __getattr__(name):
    # the bot imports the envs, and the envs import utils.trace: so the bot
    # is imported at its first use
    if name == "BabyAIBot":
        from minigrid_tpu_torch.utils.baby_ai_bot import BabyAIBot

        return BabyAIBot
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
