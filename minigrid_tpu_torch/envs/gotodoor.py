"""GoToDoor environment (reference minigrid/envs/gotodoor.py:75-149).

Counterpart of ``minigrid_tpu/envs/gotodoor.py``, batched. The target
door's position ((B, 2) int32) lives in ``state.extra``."""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid as G
from minigrid_tpu_torch.core import place
from minigrid_tpu_torch.core.actions import Actions
from minigrid_tpu_torch.core.mission import mission_table
from minigrid_tpu_torch.core.step import reward_on_success
from minigrid_tpu_torch.core.types import EnvParams
from minigrid_tpu_torch.envs import common as X
from minigrid_tpu_torch.envs.base import MiniGridEnv, random_keys
from minigrid_tpu_torch.envs.gotoobject import adjacent
from minigrid_tpu_torch.envs.envdoc import env_doc

MISSIONS = mission_table([
    f"go to the {C.IDX_TO_COLOR[c]} door" for c in range(6)
])


class GoToDoorEnv(MiniGridEnv):
    __doc__ = env_doc(
        """
        A single room with one door of a distinct color centered in each of
        its four walls. The mission string names a door color; the agent
        must walk up next to that door and signal completion with the
        ``done`` action, earning a reward only for the correct door.
        Reference: minigrid/envs/gotodoor.py.
        """,
        '"go to the {color} door"',
        mission_notes="""
        {color}: "red", "green", "blue", "purple", "yellow" or "grey".
        """,
        used=(0, 1, 2, 6),
        termination=("The agent performs ``done`` while standing next to "
                     "the requested door.",
                     "Timeout (see `max_steps`)."),
    )

    def mission_space(self):
        """Reference gotodoor.py:69-72."""
        from minigrid_tpu_torch.core.mission_space import (MissionSpace,
                                                           TemplateMission)

        return MissionSpace(
            mission_func=TemplateMission("go to the {} door", 1),
            ordered_placeholders=[C.COLOR_NAMES],
        )

    def __init__(self, size=5, max_steps=None, device=None, **kw):
        if size < 5:
            raise ValueError(f"size must be >= 5, got {size}")
        if max_steps is None:
            max_steps = 4 * size**2
        super().__init__(EnvParams(width=size, height=size,
                                   max_steps=max_steps,
                                   see_through_walls=True, **kw),
                         device=device)

    def _gen_grid(self, generator, num_envs):
        p = self.params
        dev = self.device
        B = num_envs
        rng = random_keys(generator, (B, 2), dev)
        # the room's extent varies (gotodoor.py:95-97)
        w = X.randint(generator, 5, p.width + 1, B, dev)
        h = X.randint(generator, 5, p.height + 1, B, dev)
        grid = G.empty_grid(B, p.width, p.height, dev)
        grid = G.fill_rect(grid, 0, 0, w, 1, X.WALL_CELL)
        grid = G.fill_rect(grid, 0, h - 1, w, 1, X.WALL_CELL)
        grid = G.fill_rect(grid, 0, 0, 1, h, X.WALL_CELL)
        grid = G.fill_rect(grid, w - 1, 0, 1, h, X.WALL_CELL)

        zero = torch.zeros_like(w)
        door_pos = torch.stack([
            torch.stack([X.randint(generator, 2, w - 2, B, dev), zero], -1),
            torch.stack([X.randint(generator, 2, w - 2, B, dev), h - 1], -1),
            torch.stack([zero, X.randint(generator, 2, h - 2, B, dev)], -1),
            torch.stack([w - 1, X.randint(generator, 2, h - 2, B, dev)], -1),
        ], dim=1)                                             # (B, 4, 2)
        door_colors = X.permutations(generator, B, 6, dev)[:, :4]
        for i in range(4):
            grid = G.set_cell(grid, door_pos[:, i, 0], door_pos[:, i, 1],
                              X.cells(C.DOOR, door_colors[:, i], device=dev))

        mask = G.free_mask(grid) & place.rect_mask(p.width, p.height, (0, 0),
                                                   (w, h), dev)
        agent_pos = place.sample_from_mask(generator, mask)
        agent_dir = X.randint(generator, 0, 4, B, dev)

        door = X.randint(generator, 0, 4, B, dev).to(torch.int64)
        b = torch.arange(B, device=dev)
        return self.make_state(
            grid, agent_pos, agent_dir, rng=rng,
            mission=X.take(MISSIONS, door_colors[b, door]),
            extra={"target_pos": door_pos[b, door]})

    def _post_step(self, prev, state, action, reward, terminated):
        is_done = action == Actions.done
        reward = torch.where(
            is_done & adjacent(state.agent_pos, state.extra["target_pos"]),
            reward_on_success(self.params, state.step_count), reward)
        return (state, reward,
                terminated | is_done | (action == Actions.toggle))
