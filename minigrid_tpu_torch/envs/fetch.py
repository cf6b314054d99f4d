"""Fetch environment (reference minigrid/envs/fetch.py:95-175).

Counterpart of ``minigrid_tpu/envs/fetch.py``, batched. The target's type
and colour ((B,) uint8) live in ``state.extra``."""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid as G
from minigrid_tpu_torch.core import place
from minigrid_tpu_torch.core.mission import mission_table
from minigrid_tpu_torch.core.step import reward_on_success
from minigrid_tpu_torch.core.types import EnvParams
from minigrid_tpu_torch.envs import common as X
from minigrid_tpu_torch.envs.base import MiniGridEnv, random_keys
from minigrid_tpu_torch.envs.envdoc import env_doc

TYPE_NAMES = ["key", "ball"]
SYNTAXES = ["get a", "go get a", "fetch a", "go fetch a", "you must fetch a"]

# (5 syntaxes x 6 colours x 2 types) missions; index =
# (syntax * 6 + colour) * 2 + type (fetch.py:148-158)
MISSIONS = mission_table([
    f"{syn} {C.IDX_TO_COLOR[color]} {tname}"
    for syn in SYNTAXES for color in range(6) for tname in TYPE_NAMES
])


class FetchEnv(MiniGridEnv):
    __doc__ = env_doc(
        """
        A room scattered with keys and balls of assorted colors. The
        mission string names exactly one (color, type) pair, and the agent
        must pick up a matching object. Grabbing anything else ends the
        episode with zero reward, so the task requires grounding the
        instruction text in the observation. Reference:
        minigrid/envs/fetch.py.
        """,
        '"{syntax} {color} {type}"',
        mission_notes="""
        {syntax}: one of "get a", "go get a", "fetch a", "go fetch a",
        "you must fetch a".

        {color}: "red", "green", "blue", "purple", "yellow" or "grey".

        {type}: "key" or "ball".
        """,
        used=(0, 1, 2, 3),
        termination=("The agent picks up the requested object.",
                     "The agent picks up a different object.",
                     "Timeout (see `max_steps`)."),
        configurations="N in the registered ids is the object count.",
    )

    def mission_space(self):
        """Reference fetch.py:77-88."""
        from minigrid_tpu_torch.core.mission_space import (MissionSpace,
                                                           TemplateMission)

        return MissionSpace(
            mission_func=TemplateMission("{} {} {}", 3),
            ordered_placeholders=[SYNTAXES, C.COLOR_NAMES, TYPE_NAMES],
        )

    def __init__(self, size=8, numObjs=3, max_steps=None, device=None,
                 **kw):
        if max_steps is None:
            max_steps = 5 * size**2
        super().__init__(EnvParams(width=size, height=size,
                                   max_steps=max_steps,
                                   see_through_walls=True, **kw),
                         device=device)
        self.num_objs = numObjs

    def _gen_grid(self, generator, num_envs):
        p = self.params
        dev = self.device
        B = num_envs
        rng = random_keys(generator, (B, 2), dev)
        grid = G.empty_grid(B, p.width, p.height, dev)
        grid = G.horz_wall(grid, 0, 0)
        grid = G.horz_wall(grid, 0, p.height - 1)
        grid = G.vert_wall(grid, 0, 0)
        grid = G.vert_wall(grid, p.width - 1, 0)

        types, colors = [], []
        for _ in range(self.num_objs):
            t = X.randint(generator, 0, 2, B, dev)
            color = X.randint(generator, 0, 6, B, dev)
            cell = X.cells(torch.where(t == 0, C.KEY, C.BALL), color,
                           device=dev)
            grid, _ = place.place_obj(generator, grid, cell, None)
            types.append(t)
            colors.append(color)
        agent_pos, agent_dir = place.place_agent(generator, grid)

        target = X.randint(generator, 0, self.num_objs, B, dev).to(
            torch.int64)
        b = torch.arange(B, device=dev)
        tt = torch.stack(types, 1)[b, target].to(torch.int64)
        tc = torch.stack(colors, 1)[b, target].to(torch.int64)
        syntax = X.randint(generator, 0, 5, B, dev).to(torch.int64)
        mission = X.take(MISSIONS, (syntax * 6 + tc) * 2 + tt)
        extra = {"target_type": torch.where(tt == 0, C.KEY, C.BALL).to(
                     torch.uint8),
                 "target_color": tc.to(torch.uint8)}
        return self.make_state(grid, agent_pos, agent_dir, rng=rng,
                               mission=mission, extra=extra)

    def _post_step(self, prev, state, action, reward, terminated):
        carrying = state.carrying[:, 0] != C.EMPTY
        match = ((state.carrying[:, 0] == state.extra["target_type"])
                 & (state.carrying[:, 1] == state.extra["target_color"]))
        reward = torch.where(
            carrying & match,
            reward_on_success(self.params, state.step_count),
            torch.where(carrying, 0.0, reward))
        return state, reward, terminated | carrying
