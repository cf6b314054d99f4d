"""KeyCorridor environment (reference minigrid/envs/keycorridor.py:60-136).

Counterpart of ``minigrid_tpu/envs/keycorridor.py``, batched."""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import roomgrid as RG
from minigrid_tpu_torch.core.mission import mission_table
from minigrid_tpu_torch.envs.common import take
from minigrid_tpu_torch.envs.roomgrid_base import (PickupTargetMixin,
                                                   RoomGridEnv)
from minigrid_tpu_torch.envs.envdoc import env_doc

MISSIONS = {
    t: mission_table([f"pick up the {C.IDX_TO_COLOR[c]} {t}"
                      for c in range(6)])
    for t in ["key", "ball", "box"]
}
KIND_OF = {"key": 0, "ball": 1, "box": 2}


class KeyCorridorEnv(PickupTargetMixin, RoomGridEnv):
    __doc__ = env_doc(
        """
        A corridor flanked by rooms on both sides; the target object waits
        behind a locked door while the matching key lies hidden in one of
        the other rooms. The agent must explore to find the key, unlock
        the door and pick up the object — the mission gives no hint where
        the key is, so the task is solvable without language. The family
        is registered at several sizes to support curricula (it is the
        scalable cousin of LockedRoom). Reference:
        minigrid/envs/keycorridor.py.
        """,
        '"pick up the {color} {obj_type}"',
        mission_notes="""
        {color}: "red", "green", "blue", "purple", "yellow" or "grey".

        {obj_type}: "ball" or "key".
        """,
        used=(0, 1, 2, 3, 5),
        termination=("The agent picks up the target object.",
                     "Timeout (see `max_steps`)."),
        configurations="""
        In the registered ids, S is the room size and R the number of
        room rows.
        """,
    )

    def mission_space(self):
        """Reference keycorridor.py:83-86."""
        from minigrid_tpu_torch.core.mission_space import (MissionSpace,
                                                           TemplateMission)

        return MissionSpace(
            mission_func=TemplateMission("pick up the {} {}", 2),
            ordered_placeholders=[C.COLOR_NAMES, [self.obj_type]],
        )

    def __init__(self, num_rows=3, obj_type="ball", room_size=6,
                 max_steps=None, **kw):
        if max_steps is None:
            max_steps = 30 * room_size**2
        super().__init__(room_size=room_size, num_rows=num_rows, num_cols=3,
                         max_steps=max_steps, **kw)
        self.obj_type = obj_type

    def _gen_grid(self, generator, num_envs):
        L, dev, B = self.layout, self.device, num_envs
        b = self.builder(generator, B)
        # the hallway: the middle column opened vertically (:106-108)
        for j in range(1, L.num_rows):
            b = RG.remove_wall(b, L, 1, j, 3)
        # a locked door on the right and the target behind it (:110-114)
        room_j = RG.randint(generator, 0, L.num_rows, B, dev)
        b, door_color, _ = RG.add_door(b, L, generator, 2, room_j, 2,
                                       locked=True)
        b, _, obj_color, _ = RG.add_object(b, L, generator, 2, room_j,
                                           kind=KIND_OF[self.obj_type])
        # the key, of the door's colour, in a random room on the left (:117)
        key_j = RG.randint(generator, 0, L.num_rows, B, dev)
        b, *_ = RG.add_object(b, L, generator, 0, key_j, kind=0,
                              color=door_color)
        b = RG.place_agent(b, L, generator, 1, L.num_rows // 2)
        b = RG.connect_all(b, L, generator)
        extra = {"target_type": torch.full_like(
                     obj_color, C.OBJECT_TO_IDX[self.obj_type]),
                 "target_color": obj_color}
        return self.finish(generator, b,
                           mission=take(MISSIONS[self.obj_type], obj_color),
                           extra=extra)
