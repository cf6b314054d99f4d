"""PutNear environment (reference minigrid/envs/putnear.py:85-199).

Counterpart of ``minigrid_tpu/envs/putnear.py``, batched. The mover's type
and colour ((B,) uint8) and the target's position ((B, 2) int32) live in
``state.extra``."""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid as G
from minigrid_tpu_torch.core import place
from minigrid_tpu_torch.core.actions import Actions
from minigrid_tpu_torch.core.mission import mission_table
from minigrid_tpu_torch.core.step import dir_vec, reward_on_success
from minigrid_tpu_torch.core.types import EnvParams
from minigrid_tpu_torch.envs import common as X
from minigrid_tpu_torch.envs.base import MiniGridEnv, random_keys
from minigrid_tpu_torch.envs.gotoobject import (TYPE_IDS, TYPE_NAMES,
                                                sample_distinct_type_colors)
from minigrid_tpu_torch.envs.envdoc import env_doc

# index = (move_type * 6 + move_colour) * 18 + target_type * 6 + target_colour
MISSIONS = mission_table([
    f"put the {C.IDX_TO_COLOR[mc]} {mt} near the {C.IDX_TO_COLOR[tc]} {tt}"
    for mt in TYPE_NAMES for mc in range(6)
    for tt in TYPE_NAMES for tc in range(6)
])


class PutNearEnv(MiniGridEnv):
    name = "PutNear"
    __doc__ = env_doc(
        """
        Several objects share one room; the instruction names a mover
        object and a fixed target object. The agent must pick up the
        mover and drop it on a cell adjacent to the target. Easy with two
        objects, but combining language grounding with multi-object
        spatial reasoning makes larger counts genuinely hard. Picking up
        the wrong object fails immediately. Reference:
        minigrid/envs/putnear.py.
        """,
        '"put the {move_color} {move_type} near the {target_color} '
        '{target_type}"',
        mission_notes="""
        The color slots draw from "red", "green", "blue", "purple",
        "yellow" or "grey"; the type slots from "box", "ball" or "key".
        """,
        used=(0, 1, 2, 3, 4),
        termination=("The agent picks up the wrong object.",
                     "The agent drops the mover next to the target.",
                     "Timeout (see `max_steps`)."),
        configurations="N in the registered ids is the object count.",
    )

    def mission_space(self):
        """Reference putnear.py:73-80."""
        from minigrid_tpu_torch.core.mission_space import (MissionSpace,
                                                           TemplateMission)

        return MissionSpace(
            mission_func=TemplateMission("put the {} {} near the {} {}", 4),
            ordered_placeholders=[C.COLOR_NAMES, TYPE_NAMES,
                                  C.COLOR_NAMES, TYPE_NAMES],
        )

    def __init__(self, size=6, numObjs=2, max_steps=None, device=None,
                 **kw):
        if max_steps is None:
            max_steps = 5 * size
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

        t_idx, colors = sample_distinct_type_colors(generator, B,
                                                    self.num_objs, dev)
        positions = []
        # no object lands in another's 8-neighbourhood (putnear.py:119-126)
        reject = torch.zeros((B, p.width, p.height), dtype=torch.bool,
                             device=dev)
        for i in range(self.num_objs):
            cell = X.cells(X.take(TYPE_IDS, t_idx[:, i]), colors[:, i],
                           device=dev)
            grid, pos = place.place_obj(generator, grid, cell, None,
                                        reject_mask=reject)
            positions.append(pos)
            reject = reject | place.neighbor_mask(p.width, p.height, pos)
        agent_pos, agent_dir = place.place_agent(generator, grid)

        move = X.randint(generator, 0, self.num_objs, B, dev).to(torch.int64)
        # the target is not the mover (putnear.py:163-166)
        shift = X.randint(generator, 1, self.num_objs, B, dev).to(torch.int64)
        target = (move + shift) % self.num_objs
        b = torch.arange(B, device=dev)
        mt, mc = t_idx[b, move], colors[b, move]
        tt, tc = t_idx[b, target], colors[b, target]
        mission = X.take(MISSIONS, (mt * 6 + mc) * 18 + tt * 6 + tc)
        extra = {"move_type": X.take(TYPE_IDS, mt).to(torch.uint8),
                 "move_color": mc.to(torch.uint8),
                 "target_pos": torch.stack(positions, 1)[b, target]}
        return self.make_state(grid, agent_pos, agent_dir, rng=rng,
                               mission=mission, extra=extra)

    def _post_step(self, prev, state, action, reward, terminated):
        carrying = state.carrying[:, 0] != C.EMPTY
        wrong = ((state.carrying[:, 0] != state.extra["move_type"])
                 | (state.carrying[:, 1] != state.extra["move_color"]))
        terminated = terminated | ((action == Actions.pickup) & carrying
                                   & wrong)
        pre_carried = prev.carrying[:, 0] != C.EMPTY
        # a drop succeeded iff the carried cell emptied (putnear.py:190-195)
        fx, fy = dir_vec(state.agent_dir)
        fwd = state.agent_pos + torch.stack([fx, fy], dim=-1)
        dropped = pre_carried & (state.carrying[:, 0] == C.EMPTY)
        d = (fwd - state.extra["target_pos"]).abs()
        near = (d[:, 0] <= 1) & (d[:, 1] <= 1)
        is_drop = action == Actions.drop
        reward = torch.where(is_drop & dropped & near,
                             reward_on_success(self.params, state.step_count),
                             reward)
        return state, reward, terminated | (is_drop & pre_carried)
