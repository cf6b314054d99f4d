"""GoToObject environment (reference minigrid/envs/gotoobject.py:70-160).

Counterpart of ``minigrid_tpu/envs/gotoobject.py``, batched. The target's
position ((B, 2) int32) lives in ``state.extra``."""

from __future__ import annotations

import numpy as np
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
from minigrid_tpu_torch.envs.envdoc import env_doc

TYPE_IDS = np.array([C.KEY, C.BALL, C.BOX], np.int64)
TYPE_NAMES = ["key", "ball", "box"]

# index = type * 6 + colour
MISSIONS = mission_table([
    f"go to the {C.IDX_TO_COLOR[c]} {t}" for t in TYPE_NAMES for c in range(6)
])


def sample_distinct_type_colors(generator, num_envs: int, n: int,
                                device=None, num_types: int = 3):
    """n distinct (type, colour) pairs per env, uniform without
    replacement: the prefix of a random permutation of the pairs (the
    reference redraws until unseen, gotoobject.py:106-112). Returns (type
    index, colour index), each (B, n) int64."""
    combo = X.permutations(generator, num_envs, num_types * 6, device)[:, :n]
    return combo // 6, combo % 6


def adjacent(pos, target) -> torch.Tensor:
    """(B,) whether ``pos`` is one step (not diagonal) from ``target``."""
    d = (pos - target).abs()
    return (((d[:, 0] == 0) & (d[:, 1] == 1))
            | ((d[:, 1] == 0) & (d[:, 0] == 1)))


class GoToObjectEnv(MiniGridEnv):
    name = "GoToObject"
    __doc__ = env_doc(
        """
        A room containing several colored objects (keys, balls, boxes).
        The mission string picks out one of them by color and type (e.g.
        "go to the red key"); the agent earns its reward by performing the
        ``done`` action while adjacent to the named object. Reference:
        minigrid/envs/gotoobject.py.
        """,
        '"go to the {color} {obj_type}"',
        mission_notes="""
        {color}: "red", "green", "blue", "purple", "yellow" or "grey".

        {obj_type}: "key", "ball" or "box".
        """,
        used=(0, 1, 2, 6),
        termination=("The agent performs ``done`` next to the requested "
                     "object.",
                     "Timeout (see `max_steps`)."),
        configurations="N in the registered ids is the object count.",
    )

    def mission_space(self):
        """Reference gotoobject.py:72-75."""
        from minigrid_tpu_torch.core.mission_space import (MissionSpace,
                                                           TemplateMission)

        return MissionSpace(
            mission_func=TemplateMission("go to the {} {}", 2),
            ordered_placeholders=[C.COLOR_NAMES, TYPE_NAMES],
        )

    def __init__(self, size=6, numObjs=2, max_steps=None, device=None,
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
        grid = G.wall_rect(G.empty_grid(B, p.width, p.height, dev), 0, 0,
                           p.width, p.height)
        t_idx, colors = sample_distinct_type_colors(generator, B,
                                                    self.num_objs, dev)
        positions = []
        for i in range(self.num_objs):
            cell = X.cells(X.take(TYPE_IDS, t_idx[:, i]), colors[:, i],
                           device=dev)
            grid, pos = place.place_obj(generator, grid, cell, None)
            positions.append(pos)
        agent_pos, agent_dir = place.place_agent(generator, grid)

        obj = X.randint(generator, 0, self.num_objs, B, dev).to(torch.int64)
        b = torch.arange(B, device=dev)
        target_pos = torch.stack(positions, dim=1)[b, obj]
        mission = X.take(MISSIONS, t_idx[b, obj] * 6 + colors[b, obj])
        return self.make_state(grid, agent_pos, agent_dir, rng=rng,
                               mission=mission,
                               extra={"target_pos": target_pos})

    def _post_step(self, prev, state, action, reward, terminated):
        is_done = action == Actions.done
        reward = torch.where(
            is_done & adjacent(state.agent_pos, state.extra["target_pos"]),
            reward_on_success(self.params, state.step_count), reward)
        return (state, reward,
                terminated | is_done | (action == Actions.toggle))
