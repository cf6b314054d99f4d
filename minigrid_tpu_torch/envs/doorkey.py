"""DoorKey environment (reference minigrid/envs/doorkey.py:9-99).

Counterpart of ``minigrid_tpu/envs/doorkey.py``, batched."""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid as G
from minigrid_tpu_torch.core import place
from minigrid_tpu_torch.core.types import EnvParams
from minigrid_tpu_torch.envs.base import MiniGridEnv, random_keys
from minigrid_tpu_torch.envs.envdoc import env_doc

GOAL_CELL = [C.GOAL, C.COLOR_TO_IDX["green"], 0, 0, 0]
YELLOW = C.COLOR_TO_IDX["yellow"]
LOCKED_YELLOW_DOOR = [C.DOOR, YELLOW, C.LOCKED, 0, 0]
YELLOW_KEY = [C.KEY, YELLOW, 0, 0, 0]


class DoorKeyEnv(MiniGridEnv):
    name = "DoorKey"
    __doc__ = env_doc(
        """
        A wall with a single locked yellow door splits the room in two; the
        agent and a yellow key start on one side and the green goal square
        sits on the other. The agent must collect the key, unlock the door
        and walk to the goal. The reward is sparse, which makes the larger
        sizes hard for vanilla RL — a common testbed for curiosity and
        curriculum methods. Reference: minigrid/envs/doorkey.py.
        """,
        '"use the key to open the door and then get to the goal"',
        used=(0, 1, 2, 3, 5),
        termination=("The agent reaches the goal.",
                     "Timeout (see `max_steps`)."),
    )

    def __init__(self, size=8, max_steps=None, device=None, **kw):
        if max_steps is None:
            max_steps = 10 * size**2
        super().__init__(EnvParams(width=size, height=size,
                                   max_steps=max_steps, **kw), device=device)

    def default_mission(self) -> str:
        return "use the key to open the door and then get to the goal"

    def _gen_grid(self, generator, num_envs):
        p = self.params
        dev = self.device
        grid = G.empty_grid(num_envs, p.width, p.height, dev)
        grid = G.wall_rect(grid, 0, 0, p.width, p.height)
        grid = G.set_cell(grid, p.width - 2, p.height - 2, GOAL_CELL)
        rng = random_keys(generator, (num_envs, 2), dev)

        split = torch.randint(2, p.width - 2, (num_envs,), generator=generator,
                              device=dev)
        grid = G.vert_wall(grid, split, 0)
        agent_pos, agent_dir = place.place_agent(
            generator, grid, top=(0, 0), size=(split, p.height))

        door_y = torch.randint(1, p.height - 2, (num_envs,),
                               generator=generator, device=dev)
        grid = G.set_cell(grid, split, door_y, LOCKED_YELLOW_DOOR)
        grid, _ = place.place_obj(generator, grid, YELLOW_KEY, agent_pos,
                                  top=(0, 0), size=(split, p.height))
        return self.make_state(grid, agent_pos, agent_dir, rng=rng)
