"""LavaGap environment (reference minigrid/envs/lavagap.py:100-135).

Counterpart of ``minigrid_tpu/envs/lavagap.py``, batched."""

from __future__ import annotations

from minigrid_tpu_torch.core import grid as G
from minigrid_tpu_torch.core.types import EnvParams
from minigrid_tpu_torch.envs import common as X
from minigrid_tpu_torch.envs.base import MiniGridEnv, random_keys
from minigrid_tpu_torch.envs.envdoc import env_doc


class LavaGapEnv(MiniGridEnv):
    __doc__ = env_doc(
        """
        The room is split by one vertical strip of deadly lava with a
        single safe opening; the agent starts in one corner and must pass
        through the gap to reach the green goal square in the opposite
        corner. Touching lava ends the episode with no reward — a compact
        safe-exploration task. Reference: minigrid/envs/lavagap.py.
        """,
        """
        - with lava (default): "avoid the lava and get to the green goal
          square"
        - otherwise: "find the opening and get to the green goal square"
        """,
        used=(0, 1, 2),
        termination=("The agent reaches the goal.",
                     "The agent falls into lava.",
                     "Timeout (see `max_steps`)."),
        configurations="S in the registered ids is the grid side length.",
    )

    def __init__(self, size, obstacle_type="lava", max_steps=None,
                 device=None, **kw):
        if max_steps is None:
            max_steps = 4 * size**2
        super().__init__(EnvParams(width=size, height=size,
                                   max_steps=max_steps,
                                   see_through_walls=False, **kw),
                         device=device)
        self.obstacle_type = obstacle_type

    def default_mission(self) -> str:
        if self.obstacle_type == "lava":
            return "avoid the lava and get to the green goal square"
        return "find the opening and get to the green goal square"

    def _gen_grid(self, generator, num_envs):
        p = self.params
        dev = self.device
        obstacle = X.LAVA_CELL if self.obstacle_type == "lava" \
            else X.WALL_CELL
        rng = random_keys(generator, (num_envs, 2), dev)
        grid = G.empty_grid(num_envs, p.width, p.height, dev)
        grid = G.wall_rect(grid, 0, 0, p.width, p.height)
        grid = G.set_cell(grid, p.width - 2, p.height - 2, X.GOAL_CELL)
        gap_x = X.randint(generator, 2, p.width - 2, num_envs, dev)
        gap_y = X.randint(generator, 1, p.height - 1, num_envs, dev)
        grid = G.fill_rect(grid, gap_x, 1, 1, p.height - 2, obstacle)
        grid = G.set_cell(grid, gap_x, gap_y, X.EMPTY_CELL)
        return self.make_state(grid, (1, 1), 0, rng=rng)
