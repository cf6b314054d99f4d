"""ObstructedMaze environments (reference minigrid/envs/obstructedmaze.py
and obstructedmaze_v1.py).

Counterpart of ``minigrid_tpu/envs/obstructedmaze.py``, batched. Pick up
the blue ball behind locked doors whose keys hide in grey boxes, with green
balls blocking doorways. The v1 variants place every door and blocker
before any key, so a blocker never covers a key box
(obstructedmaze_v1.py:9-99)."""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid as G
from minigrid_tpu_torch.core import roomgrid as RG
from minigrid_tpu_torch.envs.common import permutations, take
from minigrid_tpu_torch.envs.roomgrid_base import (PickupTargetMixin,
                                                   RoomGridEnv)

# COLOR_NAMES[0..2] = blue, green, grey (obstructedmaze.py:114-120)
BALL_COLOR = C.COLOR_TO_IDX["blue"]
BLOCK_COLOR = C.COLOR_TO_IDX["green"]
BOX_COLOR = C.COLOR_TO_IDX["grey"]

SIDE_ROOMS = [(2, 1), (1, 2), (0, 1), (1, 0)]
CORNERS = [(2, 0), (2, 2), (0, 2), (0, 0)]


class ObstructedMazeEnv(PickupTargetMixin, RoomGridEnv):
    """A blue ball in a maze of locked doors, keys in boxes, blocked
    doorways."""

    def mission_space(self):
        """Reference obstructedmaze.py:93-96."""
        from minigrid_tpu_torch.core.mission_space import (MissionSpace,
                                                           TemplateMission)

        return MissionSpace(
            mission_func=TemplateMission("pick up the {} ball", 1),
            ordered_placeholders=[[C.COLOR_NAMES[0]]],
        )

    def __init__(self, num_rows, num_cols, num_rooms_visited, max_steps=None,
                 **kw):
        room_size = 6
        if max_steps is None:
            max_steps = 4 * num_rooms_visited * room_size**2
        super().__init__(room_size=room_size, num_rows=num_rows,
                         num_cols=num_cols, max_steps=max_steps, **kw)

    def default_mission(self) -> str:
        return "pick up the blue ball"

    def _target_extra(self, num_envs):
        full = lambda v: torch.full((num_envs,), v, dtype=torch.uint8,
                                    device=self.device)
        return {"target_type": full(C.BALL), "target_color": full(BALL_COLOR)}

    def _door_colors(self, generator, num_envs):
        """(B, 6) uint8: a random permutation of the sorted colour names
        per env (obstructedmaze.py:114 via _rand_subset)."""
        return take(RG.SORTED_COLORS, permutations(
            generator, num_envs, 6, self.device)).to(torch.uint8)

    def _key_cell(self, key_in_box, color):
        if key_in_box:
            return RG.cell(C.BOX, BOX_COLOR, 0, C.KEY, color,
                           device=self.device)
        return RG.cell(C.KEY, color, device=self.device)

    def _add_door(self, b, generator, i, j, door_idx: int, color,
                  locked=False, key_in_box=False, blocked=False,
                  with_key=True):
        """A door, an optional blocker ball in front of it and an optional
        (boxed) key in room (i, j) (obstructedmaze.py:134-166; v1's
        add_locked_door skips the key, obstructedmaze_v1.py:77-92)."""
        b, door_color, pos = RG.add_door(b, self.layout, generator, i, j,
                                         door_idx, color, locked=locked)
        if blocked:
            dx, dy = (int(v) for v in C.DIR_TO_VEC[door_idx])
            b = b.replace(grid=G.set_cell(
                b.grid, pos[:, 0] - dx, pos[:, 1] - dy,
                RG.cell(C.BALL, BLOCK_COLOR, device=self.device)))
        if locked and with_key:
            b, _ = RG.place_in_room(b, self.layout, generator, i, j,
                                    self._key_cell(key_in_box, door_color))
        return b


class ObstructedMaze_1Dlhb(ObstructedMazeEnv):
    """2x1 maze variant (obstructedmaze.py:169-196)."""

    def __init__(self, key_in_box=True, blocked=True, **kw):
        super().__init__(num_rows=1, num_cols=2, num_rooms_visited=2, **kw)
        self.key_in_box = key_in_box
        self.blocked = blocked

    def _gen_grid(self, generator, num_envs):
        L = self.layout
        b = self.builder(generator, num_envs)
        door_colors = self._door_colors(generator, num_envs)
        b = self._add_door(b, generator, 0, 0, 0, door_colors[:, 0],
                           locked=True, key_in_box=self.key_in_box,
                           blocked=self.blocked)
        b, *_ = RG.add_object(b, L, generator, 1, 0, kind=1, color=BALL_COLOR)
        b = RG.place_agent(b, L, generator, 0, 0)
        return self.finish(generator, b,
                           extra=self._target_extra(num_envs))


class ObstructedMaze_Full(ObstructedMazeEnv):
    """3x3 maze with quarters (obstructedmaze.py:198-255); set
    ``v1=True`` for the fixed placement order (obstructedmaze_v1.py)."""

    def __init__(self, agent_room=(1, 1), key_in_box=True, blocked=True,
                 num_quarters=4, num_rooms_visited=25, v1=False, **kw):
        super().__init__(num_rows=3, num_cols=3,
                         num_rooms_visited=num_rooms_visited, **kw)
        self.agent_room = agent_room
        self.key_in_box = key_in_box
        self.blocked = blocked
        self.num_quarters = num_quarters
        self.v1 = v1

    def _gen_grid(self, generator, num_envs):
        L, dev, B = self.layout, self.device, num_envs
        b = self.builder(generator, B)
        door_colors = self._door_colors(generator, B)
        for q in range(self.num_quarters):
            si, sj = SIDE_ROOMS[q]
            b, _, _ = RG.add_door(b, L, generator, 1, 1, q,
                                  door_colors[:, q], locked=False)
            sides = [((q + k) % 4, door_colors[:, (q + k) % 6])
                     for k in (-1, 1)]
            if self.v1:
                # every locked door and blocker first, then the keys
                # (obstructedmaze_v1.py:52-67)
                for d, color in sides:
                    b = self._add_door(b, generator, si, sj, d, color,
                                       locked=True, blocked=self.blocked,
                                       with_key=False)
                for _, color in sides:
                    b, _ = RG.place_in_room(
                        b, L, generator, si, sj,
                        self._key_cell(self.key_in_box, color))
            else:
                for d, color in sides:
                    b = self._add_door(b, generator, si, sj, d, color,
                                       locked=True,
                                       key_in_box=self.key_in_box,
                                       blocked=self.blocked)
        corner = RG.randint(generator, 0, self.num_quarters, B, dev)
        corners = torch.as_tensor(CORNERS[:self.num_quarters], device=dev)
        b, *_ = RG.add_object(b, L, generator, corners[corner, 0],
                              corners[corner, 1], kind=1, color=BALL_COLOR)
        b = RG.place_agent(b, L, generator, *self.agent_room)
        return self.finish(generator, b, extra=self._target_extra(B))
