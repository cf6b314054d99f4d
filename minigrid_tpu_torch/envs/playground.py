"""Playground environment (reference minigrid/envs/playground.py:10-90).

Counterpart of ``minigrid_tpu/envs/playground.py``, batched."""

from __future__ import annotations

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid as G
from minigrid_tpu_torch.core import place
from minigrid_tpu_torch.core.types import EnvParams
from minigrid_tpu_torch.envs import common as X
from minigrid_tpu_torch.envs.base import MiniGridEnv, random_keys
from minigrid_tpu_torch.envs.gotoobject import TYPE_IDS
from minigrid_tpu_torch.envs.envdoc import env_doc


class PlaygroundEnv(MiniGridEnv):
    name = "Playground"
    __doc__ = env_doc(
        """
        A 3x3 arrangement of rooms joined by doors, scattered with a dozen
        random objects. There is no goal, reward or termination condition
        other than the step limit — it exists for interactive exploration
        and debugging of the full object/door interaction surface.
        Reference: minigrid/envs/playground.py.
        """,
        '"" (empty mission)',
        used=(0, 1, 2, 3, 4, 5),
        rewards="None — this environment defines no reward.",
        termination=("Timeout (see `max_steps`).",),
    )

    def __init__(self, max_steps=100, device=None, **kw):
        super().__init__(EnvParams(width=19, height=19, max_steps=max_steps,
                                   **kw), device=device)

    def default_mission(self) -> str:
        return ""

    def _gen_grid(self, generator, num_envs):
        p = self.params
        dev = self.device
        B, w, h = num_envs, p.width, p.height
        room_w, room_h = w // 3, h // 3
        rng = random_keys(generator, (B, 2), dev)
        grid = G.wall_rect(G.empty_grid(B, w, h, dev), 0, 0, w, h)

        def door():
            color = X.take(X.SORTED_COLOR_IDS,
                           X.randint(generator, 0, 6, B, dev))
            return X.cells(C.DOOR, color, device=dev)

        for j in range(3):
            for i in range(3):
                xl, yt = i * room_w, j * room_h
                xr, yb = xl + room_w, yt + room_h
                if i + 1 < 3:
                    grid = G.vert_wall(grid, xr, yt, room_h)
                    pos_y = X.randint(generator, yt + 1, yb - 1, B, dev)
                    grid = G.set_cell(grid, xr, pos_y, door())
                if j + 1 < 3:
                    grid = G.horz_wall(grid, xl, yb, room_w)
                    pos_x = X.randint(generator, xl + 1, xr - 1, B, dev)
                    grid = G.set_cell(grid, pos_x, yb, door())

        agent_pos, agent_dir = place.place_agent(generator, grid)
        for _ in range(12):
            t = X.randint(generator, 0, 3, B, dev)
            color = X.take(X.SORTED_COLOR_IDS,
                           X.randint(generator, 0, 6, B, dev))
            grid, _ = place.place_obj(
                generator, grid, X.cells(X.take(TYPE_IDS, t), color,
                                         device=dev), agent_pos)
        return self.make_state(grid, agent_pos, agent_dir, rng=rng)
