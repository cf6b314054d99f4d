"""LockedRoom environment (reference minigrid/envs/lockedroom.py:24-173).

Counterpart of ``minigrid_tpu/envs/lockedroom.py``, batched."""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid as G
from minigrid_tpu_torch.core import place
from minigrid_tpu_torch.core.mission import mission_table
from minigrid_tpu_torch.core.types import EnvParams
from minigrid_tpu_torch.envs import common as X
from minigrid_tpu_torch.envs.base import MiniGridEnv, random_keys
from minigrid_tpu_torch.envs.envdoc import env_doc

# mission indexed by (locked room colour, key room colour): the locked
# colour names both the key and the door (lockedroom.py:165-172)
MISSIONS = mission_table([
    f"get the {C.IDX_TO_COLOR[lc]} key from the {C.IDX_TO_COLOR[kc]} room, "
    f"unlock the {C.IDX_TO_COLOR[lc]} door and go to the goal"
    for lc in range(6) for kc in range(6)
])


class LockedRoomEnv(MiniGridEnv):
    __doc__ = env_doc(
        """
        Six rooms open onto a central hallway; one of them is locked and
        contains the green goal square, while another (named in the
        mission) holds the key. The agent must parse the instruction to
        find the key room, fetch the key, unlock the door and reach the
        goal — very hard for plain RL without the language cue.
        Reference: minigrid/envs/lockedroom.py.
        """,
        '"get the {lockedroom_color} key from the {keyroom_color} room, '
        'unlock the {door_color} door and go to the goal"',
        mission_notes="""
        Each color placeholder draws from "red", "green", "blue",
        "purple", "yellow" or "grey".
        """,
        used=(0, 1, 2, 3, 5),
        termination=("The agent reaches the goal.",
                     "Timeout (see `max_steps`)."),
    )

    def mission_space(self):
        """Reference lockedroom.py:83-86."""
        from minigrid_tpu_torch.core.mission_space import (MissionSpace,
                                                           TemplateMission)

        return MissionSpace(
            mission_func=TemplateMission(
                "get the {} key from the {} room, "
                "unlock the {} door and go to the goal", 3),
            ordered_placeholders=[C.COLOR_NAMES] * 3,
        )

    def __init__(self, size=19, max_steps=None, device=None, **kw):
        if max_steps is None:
            max_steps = 10 * size
        super().__init__(EnvParams(width=size, height=size,
                                   max_steps=max_steps, **kw), device=device)

    def _gen_grid(self, generator, num_envs):
        p = self.params
        dev = self.device
        B, w, h = num_envs, p.width, p.height
        l_idx, r_idx = w // 2 - 2, w // 2 + 2
        rng = random_keys(generator, (B, 2), dev)

        grid = G.wall_rect(G.empty_grid(B, w, h, dev), 0, 0, w, h)
        grid = G.vert_wall(grid, l_idx, 0)
        grid = G.vert_wall(grid, r_idx, 0)
        # 6 rooms, (side, n) with tops (0 | r_idx, n*(h//3)); the door at
        # (wall_idx, top_y + 3) (lockedroom.py:123-135)
        room_tops, door_pos = [], []
        for n in range(3):
            y = n * (h // 3)
            grid = G.horz_wall(grid, 0, y, l_idx)
            grid = G.fill_rect(grid, r_idx, y, w - r_idx, 1, X.WALL_CELL)
            room_tops += [(0, y), (r_idx, y)]
            door_pos += [(l_idx, y + 3), (r_idx, y + 3)]
        room_w, room_h = l_idx + 1, h // 3 + 1
        room_tops = torch.tensor(room_tops, dtype=torch.int32, device=dev)
        door_pos = torch.tensor(door_pos, dtype=torch.int32, device=dev)

        locked_idx = X.randint(generator, 0, 6, B, dev).to(torch.int64)

        # the goal at a random interior cell of the locked room (:137-139)
        gx = X.randint(generator, 1, room_w - 1, B, dev)
        gy = X.randint(generator, 1, room_h - 1, B, dev)
        goal = room_tops[locked_idx] + torch.stack([gx, gy], dim=-1)
        grid = G.set_cell(grid, goal[:, 0], goal[:, 1], X.GOAL_CELL)

        # door colours: distinct, from the sorted names (:142-151)
        colors = X.take(X.SORTED_COLOR_IDS,
                        X.permutations(generator, B, 6, dev))    # (B, 6)
        for r in range(6):
            state = torch.where(locked_idx == r, C.LOCKED, C.CLOSED)
            grid = G.set_cell(grid, int(door_pos[r, 0]), int(door_pos[r, 1]),
                              X.cells(C.DOOR, colors[:, r], state,
                                      device=dev))

        def pick(idx):
            return colors.gather(1, idx[:, None])[:, 0]

        # the key room is not the locked room (:154-158)
        shift = X.randint(generator, 1, 6, B, dev).to(torch.int64)
        key_idx = (locked_idx + shift) % 6
        kx = X.randint(generator, 1, room_w - 1, B, dev)
        ky = X.randint(generator, 1, room_h - 1, B, dev)
        key_pos = room_tops[key_idx] + torch.stack([kx, ky], dim=-1)
        grid = G.set_cell(grid, key_pos[:, 0], key_pos[:, 1],
                          X.cells(C.KEY, pick(locked_idx), device=dev))

        # the agent in the hallway (:161-163)
        mask = G.free_mask(grid) & place.rect_mask(
            w, h, (l_idx, 0), (r_idx - l_idx, h), dev)
        agent_pos = place.sample_from_mask(generator, mask)
        agent_dir = X.randint(generator, 0, 4, B, dev)

        mission = X.take(MISSIONS, pick(locked_idx) * 6 + pick(key_idx))
        return self.make_state(grid, agent_pos, agent_dir, rng=rng,
                               mission=mission)
