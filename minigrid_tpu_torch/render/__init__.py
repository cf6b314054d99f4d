"""RGB rendering of batched states: the tile atlas and frame gathers
(counterpart of ``minigrid_tpu/render``)."""

from minigrid_tpu_torch.render.frame import (
    compose_frame,
    get_frame,
    get_full_render,
    get_pov_render,
)
from minigrid_tpu_torch.render.tiles import get_atlas

__all__ = [
    "compose_frame", "get_frame", "get_full_render", "get_pov_render",
    "get_atlas",
]
