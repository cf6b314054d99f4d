"""WFC configuration presets (reference minigrid/envs/wfc/config.py).

The port's own copy of ``minigrid_tpu/envs/wfc/config.py``.

Pattern images are embedded arrays (pattern_data.py) instead of PNG assets;
preset parameters mirror the reference dicts (config.py:173-505).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from minigrid_tpu_torch.envs.wfc.pattern_data import PATTERNS


@dataclasses.dataclass(frozen=True)
class WFCConfig:
    pattern: str
    tile_size: int = 1
    pattern_width: int = 2
    rotations: int = 8
    output_periodic: bool = False
    input_periodic: bool = False
    loc_heuristic: str = "entropy"
    choice_heuristic: str = "weighted"
    backtracking: bool = False
    # reference execute_wfc's global_constraint parameter
    # (wfclogic/control.py:209-216); the only supported value is
    # "allpatterns" (solver.py:410-419)
    global_constraint: str | None = None

    @property
    def image(self) -> np.ndarray:
        return PATTERNS[self.pattern]


# Default presets, registered out of the box (reference config.py:173-247)
WFC_PRESETS = {
    "MazeSimple": WFCConfig(pattern="SimpleMaze", pattern_width=2),
    "DungeonMazeScaled": WFCConfig(pattern="ScaledMaze", pattern_width=2,
                                   output_periodic=True, input_periodic=True),
    "RoomsFabric": WFCConfig(pattern="Fabric", pattern_width=3),
    "ObstaclesBlackdots": WFCConfig(pattern="Blackdots", pattern_width=2),
    "ObstaclesAngular": WFCConfig(pattern="Angular", pattern_width=3,
                                  output_periodic=True, input_periodic=True),
    "ObstaclesHogs3": WFCConfig(pattern="Hogs", pattern_width=3,
                                output_periodic=True, input_periodic=True),
}

# Hard-to-satisfy presets (reference config.py:249-327)
WFC_PRESETS_INCONSISTENT = {
    "MazeKnot": WFCConfig(pattern="Knot", pattern_width=3,
                          output_periodic=True, input_periodic=True),
    "MazeWall": WFCConfig(pattern="SimpleWall", pattern_width=2,
                          output_periodic=True, input_periodic=True),
    "RoomsOffice": WFCConfig(pattern="Office", pattern_width=3,
                             output_periodic=True, input_periodic=True),
    "ObstaclesHogs2": WFCConfig(pattern="Hogs", pattern_width=2,
                                output_periodic=True, input_periodic=True),
    "Skew2": WFCConfig(pattern="Skew2", pattern_width=3,
                       output_periodic=True, input_periodic=True),
}

# Slow presets (reference config.py:329-503)
WFC_PRESETS_SLOW = {
    "Maze": WFCConfig(pattern="Maze", pattern_width=3, output_periodic=True,
                      input_periodic=True),
    "MazeSpirals": WFCConfig(pattern="Spirals", pattern_width=3,
                             output_periodic=True, input_periodic=True),
    "MazePaths": WFCConfig(pattern="Paths", pattern_width=3,
                           output_periodic=True, input_periodic=True),
    "Mazelike": WFCConfig(pattern="Mazelike", pattern_width=3,
                          output_periodic=True, input_periodic=True),
    "Dungeon": WFCConfig(pattern="DungeonExtr", pattern_width=3,
                         output_periodic=True, input_periodic=True),
    "DungeonRooms": WFCConfig(pattern="Rooms", pattern_width=3,
                              output_periodic=True, input_periodic=True),
    "DungeonLessRooms": WFCConfig(pattern="LessRooms", pattern_width=3,
                                  output_periodic=True, input_periodic=True),
    "DungeonSpirals": WFCConfig(pattern="SpiralsNeg", pattern_width=3,
                                output_periodic=True, input_periodic=True),
    "RoomsMagicOffice": WFCConfig(pattern="MagicOffice", pattern_width=3,
                                  output_periodic=True, input_periodic=True),
    "SkewCave": WFCConfig(pattern="Cave", pattern_width=3),
    "SkewLake": WFCConfig(pattern="Lake", pattern_width=3,
                          output_periodic=True, input_periodic=True),
}

WFC_PRESETS_ALL = {**WFC_PRESETS, **WFC_PRESETS_INCONSISTENT,
                   **WFC_PRESETS_SLOW}


def register_wfc_presets(presets: dict, register_fn) -> None:
    """Register a WFC env id per preset (reference config.py:533-541)."""
    from minigrid_tpu_torch.envs.wfc.wfcenv import WFCEnv

    for name in presets:
        register_fn(f"MiniGrid-WFC-{name}-v0", WFCEnv, wfc_config=name)
