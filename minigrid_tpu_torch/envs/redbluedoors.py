"""RedBlueDoors environment (reference minigrid/envs/redbluedoors.py:60-126).

Counterpart of ``minigrid_tpu/envs/redbluedoors.py``, batched. The grid is
2s x s; the door positions ((B, 2) int32) live in ``state.extra``."""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid as G
from minigrid_tpu_torch.core import place
from minigrid_tpu_torch.core.step import reward_on_success
from minigrid_tpu_torch.core.types import EnvParams
from minigrid_tpu_torch.envs import common as X
from minigrid_tpu_torch.envs.base import MiniGridEnv, random_keys
from minigrid_tpu_torch.envs.envdoc import env_doc

RED_DOOR = [C.DOOR, X.RED, C.CLOSED, 0, 0]
BLUE_DOOR = [C.DOOR, X.BLUE, C.CLOSED, 0, 0]


def door_open(grid, pos) -> torch.Tensor:
    """(B,) whether the door at each env's ``pos`` ((B, 2)) is open."""
    b = torch.arange(grid.shape[0], device=grid.device)
    return grid[b, pos[:, 0].long(), pos[:, 1].long(), 2] == C.OPEN


class RedBlueDoorEnv(MiniGridEnv):
    name = "RedBlueDoors"
    __doc__ = env_doc(
        """
        The agent starts at a random pose in a room that has a red door on
        one side and a blue door on the opposite side. It must open the
        red door first and the blue door second; opening the blue door
        early is an immediate failure. (Counter-intuitively the task is
        solvable without memory: the red door's open state stays visible.)
        Reference: minigrid/envs/redbluedoors.py.
        """,
        '"open the red door then the blue door"',
        used=(0, 1, 2, 5),
        termination=("The agent opens the blue door after the red one — "
                     "success.",
                     "The agent opens the blue door before the red one — "
                     "failure.",
                     "Timeout (see `max_steps`)."),
    )

    def __init__(self, size=8, max_steps=None, device=None, **kw):
        if max_steps is None:
            max_steps = 20 * size**2
        super().__init__(EnvParams(width=2 * size, height=size,
                                   max_steps=max_steps, **kw), device=device)
        self.size = size

    def default_mission(self) -> str:
        return "open the red door then the blue door"

    def _gen_grid(self, generator, num_envs):
        s = self.size
        dev = self.device
        B = num_envs
        rng = random_keys(generator, (B, 2), dev)
        grid = G.empty_grid(B, 2 * s, s, dev)
        grid = G.wall_rect(grid, 0, 0, 2 * s, s)
        grid = G.wall_rect(grid, s // 2, 0, s, s)

        mask = G.free_mask(grid) & place.rect_mask(2 * s, s, (s // 2, 0),
                                                   (s, s), dev)
        agent_pos = place.sample_from_mask(generator, mask)
        agent_dir = X.randint(generator, 0, 4, B, dev)

        red_y = X.randint(generator, 1, s - 1, B, dev)
        blue_y = X.randint(generator, 1, s - 1, B, dev)
        red_pos = torch.stack([torch.full_like(red_y, s // 2), red_y], -1)
        blue_pos = torch.stack([torch.full_like(blue_y, s // 2 + s - 1),
                                blue_y], -1)
        grid = G.set_cell(grid, red_pos[:, 0], red_pos[:, 1], RED_DOOR)
        grid = G.set_cell(grid, blue_pos[:, 0], blue_pos[:, 1], BLUE_DOOR)
        extra = {"red_pos": red_pos, "blue_pos": blue_pos}
        return self.make_state(grid, agent_pos, agent_dir, rng=rng,
                               extra=extra)

    def _post_step(self, prev, state, action, reward, terminated):
        rp, bp = state.extra["red_pos"], state.extra["blue_pos"]
        red_before = door_open(prev.grid, rp)
        blue_before = door_open(prev.grid, bp)
        red_after = door_open(state.grid, rp)
        blue_after = door_open(state.grid, bp)
        success = blue_after & red_before
        fail = (blue_after & ~red_before) | (~blue_after & red_after
                                             & blue_before)
        reward = torch.where(
            success, reward_on_success(self.params, state.step_count),
            torch.where(fail, 0.0, reward))
        return state, reward, terminated | success | fail
