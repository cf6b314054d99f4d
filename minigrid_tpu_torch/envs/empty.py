"""Empty room environment (reference minigrid/envs/empty.py:9-114).

Counterpart of ``minigrid_tpu/envs/empty.py``, batched."""

from __future__ import annotations

import dataclasses

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid as G
from minigrid_tpu_torch.core import place
from minigrid_tpu_torch.core.types import EnvParams
from minigrid_tpu_torch.envs.base import MiniGridEnv, random_keys
from minigrid_tpu_torch.envs.envdoc import env_doc

GOAL_CELL = [C.GOAL, C.COLOR_TO_IDX["green"], 0, 0, 0]


@dataclasses.dataclass(frozen=True)
class EmptyParams(EnvParams):
    agent_start_pos: tuple[int, int] | None = (1, 1)
    agent_start_dir: int = 0


class EmptyEnv(MiniGridEnv):
    __doc__ = env_doc(
        """
        A bare walled room whose only feature is the green goal square in
        the bottom-right corner. Reaching it yields a sparse reward
        discounted by episode length. Small sizes are the canonical "does
        my algorithm run at all" check; large sizes probe exploration under
        sparse reward. In the ``Random`` variants the agent's start pose is
        re-sampled every episode; otherwise it always starts in the corner
        opposite the goal. Reference: minigrid/envs/empty.py.
        """,
        '"get to the green goal square"',
        used=(0, 1, 2),
        termination=("The agent reaches the goal.",
                     "Timeout (see `max_steps`)."),
    )

    def __init__(self, size=8, agent_start_pos=(1, 1), agent_start_dir=0,
                 max_steps=None, device=None, **kw):
        if max_steps is None:
            max_steps = 4 * size**2
        super().__init__(
            EmptyParams(width=size, height=size, max_steps=max_steps,
                        see_through_walls=True,  # reference empty.py:87
                        agent_start_pos=agent_start_pos,
                        agent_start_dir=agent_start_dir, **kw),
            device=device)

    def _gen_grid(self, generator, num_envs):
        p = self.params
        grid = G.empty_grid(num_envs, p.width, p.height, self.device)
        grid = G.wall_rect(grid, 0, 0, p.width, p.height)
        grid = G.set_cell(grid, p.width - 2, p.height - 2, GOAL_CELL)
        rng = random_keys(generator, (num_envs, 2), self.device)
        if p.agent_start_pos is not None:
            pos = torch.tensor(p.agent_start_pos, dtype=torch.int32)
            agent_dir = torch.tensor(p.agent_start_dir, dtype=torch.int32)
        else:
            pos, agent_dir = place.place_agent(generator, grid)
        return self.make_state(grid, pos, agent_dir, rng=rng)
