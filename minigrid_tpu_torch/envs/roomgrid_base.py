"""Env base for the RoomGrid-derived environments.

Counterpart of ``minigrid_tpu/envs/roomgrid_base.py`` (reference
``minigrid/core/roomgrid.py:66-102``), batched."""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import roomgrid as RG
from minigrid_tpu_torch.core.actions import Actions
from minigrid_tpu_torch.core.step import reward_on_success
from minigrid_tpu_torch.core.types import EnvParams
from minigrid_tpu_torch.envs.base import MiniGridEnv, random_keys


class RoomGridEnv(MiniGridEnv):
    """A grid of equal rooms joined by doors; generators build it with the
    batched builder (``core/roomgrid.py``)."""

    def __init__(self, room_size=7, num_rows=3, num_cols=3, max_steps=100,
                 agent_view_size=7, device=None, **kw):
        self.layout = RG.RoomLayout(room_size, num_rows, num_cols)
        super().__init__(EnvParams(width=self.layout.width,
                                   height=self.layout.height,
                                   view_size=agent_view_size,
                                   max_steps=max_steps,
                                   see_through_walls=False, **kw),
                         device=device)

    def default_mission(self) -> str:
        return ""

    def builder(self, generator, num_envs: int) -> RG.Builder:
        """A fresh builder of ``num_envs`` layouts on this env's device."""
        return RG.init_builder(self.layout, generator, num_envs, self.device)

    def finish(self, generator, b: RG.Builder, mission=None, extra=None):
        """The episodes of a finished builder, each with a fresh rng."""
        rng = random_keys(generator, (b.batch_size, 2), self.device)
        return self.make_state(b.grid, b.agent_pos, b.agent_dir, rng=rng,
                               mission=mission, extra=extra)


class PickupTargetMixin:
    """The episode succeeds on picking up THE target object (e.g.
    keycorridor.py:128-135, unlockpickup.py:97-105). Expects ``extra`` =
    {target_type, target_color} ((B,) uint8); the (type, colour) pairs of
    targets are unique by construction, so value equality matches the
    reference's identity check."""

    def _post_step(self, prev, state, action, reward, terminated):
        match = ((state.carrying[:, 0] == state.extra["target_type"])
                 & (state.carrying[:, 1] == state.extra["target_color"]))
        success = (action == Actions.pickup) & match
        reward = torch.where(
            success, reward_on_success(self.params, state.step_count), reward)
        return state, reward, terminated | success
