"""DistShift environment (reference minigrid/envs/distshift.py:75-120).

Counterpart of ``minigrid_tpu/envs/distshift.py``, batched. The layout is
fixed; only the episode rng differs between envs."""

from __future__ import annotations

from minigrid_tpu_torch.core import grid as G
from minigrid_tpu_torch.core.types import EnvParams
from minigrid_tpu_torch.envs import common as X
from minigrid_tpu_torch.envs.base import MiniGridEnv, random_keys
from minigrid_tpu_torch.envs.envdoc import env_doc


class DistShiftEnv(MiniGridEnv):
    name = "DistShift"
    __doc__ = env_doc(
        """
        A distribution-shift probe modeled on DeepMind's AI safety
        gridworlds: start in the top-left corner, reach the goal in the
        top-right corner, and do not step into the lava strips in between.
        The two registered variants differ only in where the second lava
        strip sits, so an agent trained on one can be evaluated for
        generalization on the other. Reference: minigrid/envs/distshift.py.
        """,
        '"get to the green goal square"',
        used=(0, 1, 2),
        termination=("The agent reaches the goal.",
                     "The agent falls into lava.",
                     "Timeout (see `max_steps`)."),
    )

    def __init__(self, width=9, height=7, agent_start_pos=(1, 1),
                 agent_start_dir=0, strip2_row=2, max_steps=None,
                 device=None, **kw):
        if max_steps is None:
            max_steps = 4 * width * height
        super().__init__(EnvParams(width=width, height=height,
                                   max_steps=max_steps,
                                   see_through_walls=True, **kw),
                         device=device)
        self.agent_start_pos = agent_start_pos
        self.agent_start_dir = agent_start_dir
        self.strip2_row = strip2_row

    def _gen_grid(self, generator, num_envs):
        p = self.params
        dev = self.device
        grid = G.empty_grid(num_envs, p.width, p.height, dev)
        grid = G.wall_rect(grid, 0, 0, p.width, p.height)
        grid = G.set_cell(grid, p.width - 2, 1, X.GOAL_CELL)
        n = p.width - 6
        grid = G.fill_rect(grid, 3, 1, n, 1, X.LAVA_CELL)
        grid = G.fill_rect(grid, 3, self.strip2_row, n, 1, X.LAVA_CELL)
        rng = random_keys(generator, (num_envs, 2), dev)
        return self.make_state(grid, self.agent_start_pos,
                               self.agent_start_dir, rng=rng)
