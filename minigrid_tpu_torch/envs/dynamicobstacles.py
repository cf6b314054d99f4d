"""Dynamic-Obstacles environment (reference minigrid/envs/dynamicobstacles.py).

Counterpart of ``minigrid_tpu/envs/dynamicobstacles.py``, batched. Blue
balls jump to a random free cell of their 3x3 neighbourhood before every
agent transition, one after another (each move changes the cells the next
ball sees, as the reference's loop does); walking into anything but an
empty cell or the goal ends the episode with reward -1. The ball positions
((B, n, 2) int32) live in ``state.extra["obstacles"]``.

The moves draw from the step keys alone (``step(keys, ...)`` gets the (B,
2) int32 key bits): an integer hash written in torch ops
(``envs/common.py::hash_scores``) scores the neighbourhood's cells and each ball takes
the best-scoring free one. The same inputs give the same moves on the CPU
and on the card; the moves' distribution (uniform over the free cells), not
JAX's threefry stream, is what matches the JAX package.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid as G
from minigrid_tpu_torch.core import place
from minigrid_tpu_torch.core.actions import Actions
from minigrid_tpu_torch.core.step import dir_vec
from minigrid_tpu_torch.core.types import EnvParams
from minigrid_tpu_torch.envs import common as X
from minigrid_tpu_torch.envs.base import MiniGridEnv, random_keys
from minigrid_tpu_torch.envs.envdoc import env_doc

BALL_CELL = [C.BALL, X.BLUE, 0, 0, 0]


class DynamicObstaclesEnv(MiniGridEnv):
    name = "Dynamic-Obstacles"
    __doc__ = env_doc(
        """
        An empty room populated with blue balls that jump to a random free
        cell in their 3x3 neighborhood every step. The agent must reach
        the green goal square without ever walking into an obstacle;
        colliding costs a -1 penalty and ends the episode. Useful for
        studying dynamic obstacle avoidance under partial observability.
        The ``Random`` ids start the agent at a random pose instead of the
        fixed top-left corner. Reference:
        minigrid/envs/dynamicobstacles.py.
        """,
        '"get to the green goal square"',
        used=(0, 1, 2),
        num_actions=3,
        rewards="""
        A reward of `1 - 0.9 * (step_count / max_steps)` is given on
        success, and `0` on failure; colliding with an obstacle yields -1.
        """,
        termination=("The agent reaches the goal.",
                     "The agent collides with an obstacle.",
                     "Timeout (see `max_steps`)."),
    )

    reward_range = (-1, 1)  # the collision penalty (reference :105)

    def __init__(self, size=8, agent_start_pos=(1, 1), agent_start_dir=0,
                 n_obstacles=4, max_steps=None, device=None, **kw):
        if max_steps is None:
            max_steps = 4 * size**2
        super().__init__(EnvParams(width=size, height=size,
                                   max_steps=max_steps,
                                   see_through_walls=True, **kw),
                         device=device)
        self.agent_start_pos = agent_start_pos
        self.agent_start_dir = agent_start_dir
        # the reference caps the obstacle count at size/2 (:85-88)
        self.n_obstacles = (int(n_obstacles) if n_obstacles <= size / 2 + 1
                            else int(size / 2))

    @property
    def num_actions(self) -> int:
        return 3  # left, right, forward (reference :104)

    def _gen_grid(self, generator, num_envs):
        p = self.params
        dev = self.device
        B = num_envs
        rng = random_keys(generator, (B, 2), dev)
        grid = G.wall_rect(G.empty_grid(B, p.width, p.height, dev), 0, 0,
                           p.width, p.height)
        grid = G.set_cell(grid, p.width - 2, p.height - 2, X.GOAL_CELL)
        if self.agent_start_pos is not None:
            agent_pos = torch.tensor(self.agent_start_pos, dtype=torch.int32,
                                     device=dev).expand(B, 2)
            agent_dir = torch.full((B,), self.agent_start_dir,
                                   dtype=torch.int32, device=dev)
        else:
            agent_pos, agent_dir = place.place_agent(generator, grid)
        positions = []
        for _ in range(self.n_obstacles):
            grid, pos = place.place_obj(generator, grid, BALL_CELL,
                                        agent_pos)
            positions.append(pos)
        extra = {"obstacles": torch.stack(positions, dim=1)}
        return self.make_state(grid, agent_pos, agent_dir, rng=rng,
                               extra=extra)

    def _transform_action(self, state, action):
        # invalid actions collapse to 'left' (reference :138-140)
        return torch.where(action >= 3, 0, action)

    def _pre_step(self, keys, state, action):
        p = self.params
        B = state.batch_size
        dev = state.device
        b = torch.arange(B, device=dev)
        grid = state.grid
        obstacles = state.extra["obstacles"]
        ax, ay = state.agent_pos[:, 0:1], state.agent_pos[:, 1:2]
        d = torch.arange(3, device=dev)
        ox = d.repeat_interleave(3)[None, :]            # (1, 9), x-major
        oy = d.repeat(3)[None, :]
        moved = []
        for i in range(self.n_obstacles):
            old = obstacles[:, i]
            # the 3x3 rectangle from old - 1, its top clamped at 0
            # (place.rect_mask), cells x-major as the JAX mask flattens
            cx = (old[:, 0:1] - 1).clamp(min=0) + ox     # (B, 9)
            cy = (old[:, 1:2] - 1).clamp(min=0) + oy
            inb = (cx < p.width) & (cy < p.height)
            cell = grid[b[:, None], cx.clamp(max=p.width - 1).long(),
                        cy.clamp(max=p.height - 1).long(), 0]
            free = inb & (cell == C.EMPTY) & ~((cx == ax) & (cy == ay))
            ok = free.any(1)
            score = torch.where(free, X.hash_scores(keys, i, 9), -1)
            pick = score.argmax(1)
            new = torch.where(ok[:, None],
                              torch.stack([cx[b, pick], cy[b, pick]], -1),
                              old).to(torch.int32)
            # x = -1 writes nothing: a ball with no free cell stays
            grid = G.set_cell(grid, torch.where(ok, old[:, 0], -1),
                              old[:, 1], C.EMPTY_CELL)
            grid = G.set_cell(grid, torch.where(ok, new[:, 0], -1),
                              new[:, 1], BALL_CELL)
            moved.append(new)
        return state.replace(grid=grid, extra={
            "obstacles": torch.stack(moved, dim=1)})

    def _post_step(self, prev, state, action, reward, terminated):
        # the collision test reads the PRE-MOVE front cell (reference
        # :142-144)
        p = self.params
        fx, fy = dir_vec(prev.agent_dir)
        x = (prev.agent_pos[:, 0] + fx).clamp(0, p.width - 1).long()
        y = (prev.agent_pos[:, 1] + fy).clamp(0, p.height - 1).long()
        b = torch.arange(prev.batch_size, device=prev.device)
        ftype = prev.grid[b, x, y, 0]
        hit = ((action == Actions.forward) & (ftype != C.EMPTY)
               & (ftype != C.GOAL))
        return (state, torch.where(hit, -1.0, reward), terminated | hit)
