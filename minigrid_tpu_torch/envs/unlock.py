"""Unlock environments (reference minigrid/envs/unlock.py:45-96,
unlockpickup.py:45-105, blockedunlockpickup.py:55-115).

Counterpart of ``minigrid_tpu/envs/unlock.py``, batched."""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid as G
from minigrid_tpu_torch.core import roomgrid as RG
from minigrid_tpu_torch.core.actions import Actions
from minigrid_tpu_torch.core.mission import mission_table
from minigrid_tpu_torch.core.step import reward_on_success
from minigrid_tpu_torch.envs.common import take
from minigrid_tpu_torch.envs.roomgrid_base import (PickupTargetMixin,
                                                   RoomGridEnv)
from minigrid_tpu_torch.envs.envdoc import env_doc

BOX_MISSIONS = mission_table(
    [f"pick up the {C.IDX_TO_COLOR[c]} box" for c in range(6)])


def _box_target(box_color) -> dict:
    return {"target_type": torch.full_like(box_color, C.BOX),
            "target_color": box_color}


class UnlockEnv(RoomGridEnv):
    __doc__ = env_doc(
        """
        Two rooms joined by a locked door, with the matching key lying in
        the agent's room. Success is simply getting the door open — the
        minimal key/door skill in isolation, solvable without language.
        Reference: minigrid/envs/unlock.py.
        """,
        '"open the door"',
        used=(0, 1, 2, 3, 5),
        termination=("The agent opens the door.",
                     "Timeout (see `max_steps`)."),
    )

    def __init__(self, max_steps=None, **kw):
        room_size = 6
        if max_steps is None:
            max_steps = 8 * room_size**2
        super().__init__(room_size=room_size, num_rows=1, num_cols=2,
                         max_steps=max_steps, **kw)

    def default_mission(self) -> str:
        return "open the door"

    def _gen_grid(self, generator, num_envs):
        L = self.layout
        b = self.builder(generator, num_envs)
        b, door_color, door_pos = RG.add_door(b, L, generator, 0, 0, 0,
                                              locked=True)
        b, *_ = RG.add_object(b, L, generator, 0, 0, kind=0, color=door_color)
        b = RG.place_agent(b, L, generator, 0, 0)
        return self.finish(generator, b, extra={"door_pos": door_pos})

    def _post_step(self, prev, state, action, reward, terminated):
        dp = state.extra["door_pos"].to(torch.int64)
        bi = torch.arange(state.batch_size, device=state.device)
        door_open = state.grid[bi, dp[:, 0], dp[:, 1], 2] == C.OPEN
        success = (action == Actions.toggle) & door_open
        reward = torch.where(
            success, reward_on_success(self.params, state.step_count), reward)
        return state, reward, terminated | success


class UnlockPickupEnv(PickupTargetMixin, RoomGridEnv):
    __doc__ = env_doc(
        """
        The target box sits in a second room behind a locked door; the key
        is in the agent's room. Fetch the key, unlock the door, cross
        over and pick up the box. Solvable without language. Reference:
        minigrid/envs/unlockpickup.py.
        """,
        '"pick up the {color} box"',
        mission_notes="""
        {color}: "red", "green", "blue", "purple", "yellow" or "grey".
        """,
        used=(0, 1, 2, 3, 5),
        termination=("The agent picks up the target box.",
                     "Timeout (see `max_steps`)."),
    )

    def mission_space(self):
        """Reference unlockpickup.py:61-64."""
        from minigrid_tpu_torch.core.mission_space import (MissionSpace,
                                                           TemplateMission)

        return MissionSpace(
            mission_func=TemplateMission("pick up the {} box", 1),
            ordered_placeholders=[C.COLOR_NAMES],
        )

    def __init__(self, max_steps=None, **kw):
        room_size = 6
        if max_steps is None:
            max_steps = 8 * room_size**2
        super().__init__(room_size=room_size, num_rows=1, num_cols=2,
                         max_steps=max_steps, **kw)

    def _gen_grid(self, generator, num_envs):
        L = self.layout
        b = self.builder(generator, num_envs)
        b, _, box_color, _ = RG.add_object(b, L, generator, 1, 0, kind=2)
        b, door_color, _ = RG.add_door(b, L, generator, 0, 0, 0, locked=True)
        b, *_ = RG.add_object(b, L, generator, 0, 0, kind=0, color=door_color)
        b = RG.place_agent(b, L, generator, 0, 0)
        return self.finish(generator, b, mission=take(BOX_MISSIONS, box_color),
                           extra=_box_target(box_color))


class BlockedUnlockPickupEnv(PickupTargetMixin, RoomGridEnv):
    __doc__ = env_doc(
        """
        Like UnlockPickup — a box to fetch from behind a locked door —
        except a ball is parked directly in front of the door. The agent
        must first move the ball aside, then collect the key, unlock the
        door and pick up the box in the far room. A four-skill chain that
        needs no language. Reference:
        minigrid/envs/blockedunlockpickup.py.
        """,
        '"pick up the {color} {type}"',
        mission_notes="""
        {color}: "red", "green", "blue", "purple", "yellow" or "grey".

        {type}: "box" or "key".
        """,
        used=(0, 1, 2, 3, 5),
        termination=("The agent picks up the target box.",
                     "Timeout (see `max_steps`)."),
    )

    def mission_space(self):
        """Reference blockedunlockpickup.py:67-70."""
        from minigrid_tpu_torch.core.mission_space import (MissionSpace,
                                                           TemplateMission)

        return MissionSpace(
            mission_func=TemplateMission("pick up the {} {}", 2),
            ordered_placeholders=[C.COLOR_NAMES, ["box", "key"]],
        )

    def __init__(self, max_steps=None, **kw):
        room_size = 6
        if max_steps is None:
            max_steps = 16 * room_size**2
        super().__init__(room_size=room_size, num_rows=1, num_cols=2,
                         max_steps=max_steps, **kw)

    def _gen_grid(self, generator, num_envs):
        L, dev = self.layout, self.device
        b = self.builder(generator, num_envs)
        b, _, box_color, _ = RG.add_object(b, L, generator, 1, 0, kind=2)
        b, door_color, door_pos = RG.add_door(b, L, generator, 0, 0, 0,
                                              locked=True)
        blocker = RG.sorted_color(RG.randint(generator, 0, 6, num_envs, dev))
        b = b.replace(grid=G.set_cell(b.grid, door_pos[:, 0] - 1,
                                      door_pos[:, 1],
                                      RG.cell(C.BALL, blocker, device=dev)))
        b, *_ = RG.add_object(b, L, generator, 0, 0, kind=0, color=door_color)
        b = RG.place_agent(b, L, generator, 0, 0)
        return self.finish(generator, b, mission=take(BOX_MISSIONS, box_color),
                           extra=_box_target(box_color))
