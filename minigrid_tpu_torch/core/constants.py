"""Integer vocabularies and geometric constants of the gridworld.

The port's own copy of ``minigrid_tpu/core/constants.py`` (numpy only, so the
values are shared verbatim): the same integer encoding of the reference
vocabularies (``minigrid/core/constants.py:5-58``), which defines the
observation dtype contract, plus the capability tables that replace the
reference's per-object dynamic dispatch
(``minigrid/core/world_object.py:45-59``).
"""

from __future__ import annotations

import numpy as np

TILE_PIXELS = 32

# Color vocabulary (reference minigrid/core/constants.py:8-20).
COLORS = {
    "red": np.array([255, 0, 0], dtype=np.uint8),
    "green": np.array([0, 255, 0], dtype=np.uint8),
    "blue": np.array([0, 0, 255], dtype=np.uint8),
    "purple": np.array([112, 39, 195], dtype=np.uint8),
    "yellow": np.array([255, 255, 0], dtype=np.uint8),
    "grey": np.array([100, 100, 100], dtype=np.uint8),
}

COLOR_NAMES = sorted(COLORS.keys())  # blue green grey purple red yellow

COLOR_TO_IDX = {"red": 0, "green": 1, "blue": 2, "purple": 3, "yellow": 4, "grey": 5}
IDX_TO_COLOR = {v: k for k, v in COLOR_TO_IDX.items()}
NUM_COLORS = len(COLOR_TO_IDX)

# (NUM_COLORS, 3) uint8 RGB table, indexed by color id.
COLOR_RGB = np.stack([COLORS[IDX_TO_COLOR[i]] for i in range(NUM_COLORS)])

# Object-type vocabulary (reference minigrid/core/constants.py:25-37).
OBJECT_TO_IDX = {
    "unseen": 0,
    "empty": 1,
    "wall": 2,
    "floor": 3,
    "door": 4,
    "key": 5,
    "ball": 6,
    "box": 7,
    "goal": 8,
    "lava": 9,
    "agent": 10,
}
IDX_TO_OBJECT = {v: k for k, v in OBJECT_TO_IDX.items()}
NUM_OBJECTS = len(OBJECT_TO_IDX)

UNSEEN = OBJECT_TO_IDX["unseen"]
EMPTY = OBJECT_TO_IDX["empty"]
WALL = OBJECT_TO_IDX["wall"]
FLOOR = OBJECT_TO_IDX["floor"]
DOOR = OBJECT_TO_IDX["door"]
KEY = OBJECT_TO_IDX["key"]
BALL = OBJECT_TO_IDX["ball"]
BOX = OBJECT_TO_IDX["box"]
GOAL = OBJECT_TO_IDX["goal"]
LAVA = OBJECT_TO_IDX["lava"]
AGENT = OBJECT_TO_IDX["agent"]

# Door states (reference minigrid/core/constants.py:42-46).
STATE_TO_IDX = {"open": 0, "closed": 1, "locked": 2}
OPEN, CLOSED, LOCKED = 0, 1, 2

# Agent direction -> unit vector (x, y), reference constants.py:49-58.
# 0: +x (right), 1: +y (down), 2: -x (left), 3: -y (up).
DIR_TO_VEC = np.array([[1, 0], [0, 1], [-1, 0], [0, -1]], dtype=np.int32)

# ---------------------------------------------------------------------------
# Capability lookup tables, indexed by object type id. These replace the
# reference's per-object virtual methods (world_object.py:45-59,113,128,141,
# 164,177-182,243,265,277) with O(1) gathers usable inside jit/vmap.
# ---------------------------------------------------------------------------

def _table(true_types: set[int]) -> np.ndarray:
    t = np.zeros(NUM_OBJECTS, dtype=bool)
    for i in true_types:
        t[i] = True
    return t

# can_overlap: empty cell, floor, goal, lava (+ open door, handled separately).
CAN_OVERLAP_TABLE = _table({EMPTY, FLOOR, GOAL, LAVA})
# can_pickup: key, ball, box.
CAN_PICKUP_TABLE = _table({KEY, BALL, BOX})
# see_behind is False for wall and non-open door; table holds the base value
# (True everywhere except wall); door handled with its state separately.
OPAQUE_BASE_TABLE = _table({WALL})

# Channel layout of a grid cell in this framework: 5 uint8 channels.
#   0: object type  1: color  2: state  3: contained type  4: contained color
# Channels 0-2 match the reference ``WorldObj.encode`` triple exactly
# (world_object.py:65-67); channels 3-4 carry ``Box.contains``
# (world_object.py:275) so box-toggle is a pure array update.
NUM_CHANNELS = 5

# The encoding of an empty cell (reference grid.py:261-263: "empty",0,0).
EMPTY_CELL = np.array([EMPTY, 0, 0, 0, 0], dtype=np.uint8)
# Out-of-bounds cells read as grey walls (reference grid.py:139).
WALL_CELL = np.array([WALL, COLOR_TO_IDX["grey"], 0, 0, 0], dtype=np.uint8)
UNSEEN_CELL = np.array([UNSEEN, 0, 0, 0, 0], dtype=np.uint8)
