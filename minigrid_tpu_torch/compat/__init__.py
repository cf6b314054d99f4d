"""The Gymnasium surface of the port (needs ``gymnasium``; not imported by
``minigrid_tpu_torch/__init__.py``)."""

from minigrid_tpu_torch.compat.gym_env import GymnasiumAdapter, gym_make

__all__ = ["GymnasiumAdapter", "gym_make"]
