"""FourRooms environment (reference minigrid/envs/fourrooms.py:78-126).

Counterpart of ``minigrid_tpu/envs/fourrooms.py``, batched."""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import grid as G
from minigrid_tpu_torch.core import place
from minigrid_tpu_torch.core.types import EnvParams
from minigrid_tpu_torch.envs import common as X
from minigrid_tpu_torch.envs.base import MiniGridEnv, random_keys
from minigrid_tpu_torch.envs.envdoc import env_doc


class FourRoomsEnv(MiniGridEnv):
    name = "FourRooms"
    __doc__ = env_doc(
        """
        The classic four-rooms layout from the options/HRL literature: a
        19x19 grid divided into four rooms connected through four gaps in
        the dividing walls. Agent and green goal square are each placed
        uniformly at random (any room), and the agent must navigate to the
        goal. Reference: minigrid/envs/fourrooms.py.
        """,
        '"reach the goal"',
        used=(0, 1, 2),
        termination=("The agent reaches the goal.",
                     "Timeout (see `max_steps`)."),
    )

    def __init__(self, agent_pos=None, goal_pos=None, max_steps=100,
                 device=None, **kw):
        super().__init__(EnvParams(width=19, height=19, max_steps=max_steps,
                                   **kw), device=device)
        self._agent_default_pos = agent_pos
        self._goal_default_pos = goal_pos

    def default_mission(self) -> str:
        return "reach the goal"

    def _gen_grid(self, generator, num_envs):
        p = self.params
        dev = self.device
        w, h = p.width, p.height
        room_w, room_h = w // 2, h // 2
        grid = G.wall_rect(G.empty_grid(num_envs, w, h, dev), 0, 0, w, h)
        rng = random_keys(generator, (num_envs, 2), dev)

        # interior walls with one random gap each, in the reference's loop
        # order (per room: vertical, then horizontal)
        for j in range(2):
            for i in range(2):
                xl, yt = i * room_w, j * room_h
                xr, yb = xl + room_w, yt + room_h
                if i + 1 < 2:
                    grid = G.vert_wall(grid, xr, yt, room_h)
                    gap_y = X.randint(generator, yt + 1, yb, num_envs, dev)
                    grid = G.set_cell(grid, xr, gap_y, X.EMPTY_CELL)
                if j + 1 < 2:
                    grid = G.horz_wall(grid, xl, yb, room_w)
                    gap_x = X.randint(generator, xl + 1, xr, num_envs, dev)
                    grid = G.set_cell(grid, gap_x, yb, X.EMPTY_CELL)

        if self._agent_default_pos is not None:
            ax, ay = self._agent_default_pos
            grid = G.set_cell(grid, ax, ay, X.EMPTY_CELL)
            agent_pos = torch.tensor([ax, ay], dtype=torch.int32, device=dev)
            agent_dir = X.randint(generator, 0, 4, num_envs, dev)
        else:
            agent_pos, agent_dir = place.place_agent(generator, grid)

        if self._goal_default_pos is not None:
            gx, gy = self._goal_default_pos
            grid = G.set_cell(grid, gx, gy, X.GOAL_CELL)
        else:
            grid, _ = place.place_obj(
                generator, grid, X.GOAL_CELL,
                agent_pos.expand(num_envs, 2))
        return self.make_state(grid, agent_pos, agent_dir, rng=rng)
