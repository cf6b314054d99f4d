"""Memory environment (reference minigrid/envs/memory.py:60-165).

Counterpart of ``minigrid_tpu/envs/memory.py``, batched. T-maze: the agent
sees an object in the start room, walks down a hallway and must step next
to the matching object at the junction. ``success_pos``/``failure_pos``
((B, 2) int32) live in ``state.extra``."""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid as G
from minigrid_tpu_torch.core.actions import Actions
from minigrid_tpu_torch.core.step import reward_on_success
from minigrid_tpu_torch.core.types import EnvParams
from minigrid_tpu_torch.envs import common as X
from minigrid_tpu_torch.envs.base import MiniGridEnv, random_keys
from minigrid_tpu_torch.envs.envdoc import env_doc

GREEN_KEY = [C.KEY, X.GREEN, 0, 0, 0]
GREEN_BALL = [C.BALL, X.GREEN, 0, 0, 0]


class MemoryEnv(MiniGridEnv):
    name = "MemoryS"
    __doc__ = env_doc(
        """
        A memory probe: the agent begins in a small chamber containing one
        object (key or ball), then walks a narrow hallway that forks at
        the far end. Each fork tip holds an object, one matching what was
        seen in the chamber. The agent must remember the initial object
        and step onto the matching fork tip; choosing the wrong side ends
        the episode with no reward. ``Random`` ids randomize the hallway
        length. Reference: minigrid/envs/memory.py.
        """,
        '"go to the matching object at the end of the hallway"',
        used=(0, 1, 2, 3, 5),
        termination=("The agent reaches the matching object.",
                     "The agent reaches the wrong object.",
                     "Timeout (see `max_steps`)."),
        configurations="S in the registered ids is the grid side length.",
    )

    def __init__(self, size=8, random_length=False, max_steps=None,
                 device=None, **kw):
        if max_steps is None:
            max_steps = 5 * size**2
        super().__init__(EnvParams(width=size, height=size,
                                   max_steps=max_steps,
                                   see_through_walls=False, **kw),
                         device=device)
        self.random_length = random_length

    def default_mission(self) -> str:
        return "go to the matching object at the end of the hallway"

    def _gen_grid(self, generator, num_envs):
        p = self.params
        dev = self.device
        B, w, h = num_envs, p.width, p.height
        if h % 2 != 1:
            raise ValueError(f"the height must be odd, got {h}")
        rng = random_keys(generator, (B, 2), dev)
        grid = G.empty_grid(B, w, h, dev)
        grid = G.horz_wall(grid, 0, 0)
        grid = G.horz_wall(grid, 0, h - 1)
        grid = G.vert_wall(grid, 0, 0)
        grid = G.vert_wall(grid, w - 1, 0)

        urw, lrw = h // 2 - 2, h // 2 + 2  # upper, lower room wall
        if self.random_length:
            end = X.randint(generator, 4, w - 2, B, dev)
        else:
            end = torch.full((B,), w - 3, dtype=torch.int32, device=dev)

        # the start room (memory.py:110-115)
        grid = G.fill_rect(grid, 1, urw, 4, 1, X.WALL_CELL)
        grid = G.fill_rect(grid, 1, lrw, 4, 1, X.WALL_CELL)
        grid = G.set_cell(grid, 4, urw + 1, X.WALL_CELL)
        grid = G.set_cell(grid, 4, lrw - 1, X.WALL_CELL)
        # the horizontal hallway (:118-120)
        grid = G.fill_rect(grid, 5, urw + 1, end - 5, 1, X.WALL_CELL)
        grid = G.fill_rect(grid, 5, lrw - 1, end - 5, 1, X.WALL_CELL)
        # the vertical hallway (:123-126)
        grid = G.fill_rect(grid, end, 0, 1, h, X.WALL_CELL)
        grid = G.set_cell(grid, end, h // 2, X.EMPTY_CELL)
        grid = G.fill_rect(grid, end + 2, 0, 1, h, X.WALL_CELL)

        agent_x = X.randint(generator, 1, end + 1, B, dev)
        agent_pos = torch.stack([agent_x, torch.full_like(agent_x, h // 2)],
                                dim=-1)

        key, ball = (torch.tensor(c, dtype=torch.uint8, device=dev)
                     for c in (GREEN_KEY, GREEN_BALL))
        start_is_key = X.randint(generator, 0, 2, B, dev) == 0
        grid = G.set_cell(grid, 1, h // 2 - 1,
                          torch.where(start_is_key[:, None], key, ball))

        # the order draw: [Ball, Key] or [Key, Ball] (memory.py:135)
        top_is_ball = X.randint(generator, 0, 2, B, dev) == 0
        obj0 = torch.where(top_is_ball[:, None], ball, key)
        obj1 = torch.where(top_is_ball[:, None], key, ball)
        x = end + 1
        pos0 = torch.stack([x, torch.full_like(x, h // 2 - 2)], dim=-1)
        pos1 = torch.stack([x, torch.full_like(x, h // 2 + 2)], dim=-1)
        grid = G.set_cell(grid, pos0[:, 0], pos0[:, 1], obj0)
        grid = G.set_cell(grid, pos1[:, 0], pos1[:, 1], obj1)

        matches_top = (start_is_key != top_is_ball)[:, None]
        up = torch.tensor([0, 1], dtype=torch.int32, device=dev)
        success_pos = torch.where(matches_top, pos0 + up, pos1 - up)
        failure_pos = torch.where(matches_top, pos1 - up, pos0 + up)
        extra = {"success_pos": success_pos, "failure_pos": failure_pos}
        return self.make_state(grid, agent_pos, 0, rng=rng, extra=extra)

    def _transform_action(self, state, action):
        return torch.where(action == Actions.pickup, int(Actions.toggle),
                           action)

    def _post_step(self, prev, state, action, reward, terminated):
        at_success = (state.agent_pos == state.extra["success_pos"]).all(-1)
        at_failure = (state.agent_pos == state.extra["failure_pos"]).all(-1)
        reward = torch.where(at_success,
                             reward_on_success(self.params, state.step_count),
                             reward)
        reward = torch.where(at_failure, 0.0, reward)
        return state, reward, terminated | at_success | at_failure
