from minigrid_tpu_torch.core import (constants, grid, mission, obs, place,
                                    step, types, visibility)

__all__ = [
    "constants", "grid", "mission", "obs", "place", "step", "types",
    "visibility",
]
