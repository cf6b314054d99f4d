"""Crossing environments (reference minigrid/envs/crossing.py:131-208).

Counterpart of ``minigrid_tpu/envs/crossing.py``, batched. Lava or wall
"rivers" split the grid and a random monotone staircase of openings keeps
it solvable: each env takes the first ``num_crossings`` of a random
permutation of the candidate rivers and walks a random permutation of its
horizontal/vertical moves, drawing each opening with that env's bounds.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import grid as G
from minigrid_tpu_torch.core.types import EnvParams
from minigrid_tpu_torch.envs import common as X
from minigrid_tpu_torch.envs.base import MiniGridEnv, random_keys
from minigrid_tpu_torch.envs.envdoc import env_doc


class CrossingEnv(MiniGridEnv):
    __doc__ = env_doc(
        """
        The agent crosses a square room from the top-left corner to the
        green goal square at the opposite corner. Depending on
        ``obstacle_type``, the room is cut by one or more streams of
        obstacles, each spanning the room horizontally or vertically with
        exactly one safe opening; a valid route to the goal always exists.
        With ``"lava"`` the streams are deadly (stepping in ends the
        episode with no reward) — a standard safe-exploration benchmark.
        With ``"wall"`` the streams are plain walls, giving an easy maze
        for quick algorithm sanity checks. Reference:
        minigrid/envs/crossing.py.
        """,
        """
        - ``"lava"``: "avoid the lava and get to the green goal square"
        - ``"wall"``: "find the opening and get to the green goal square"
        """,
        used=(0, 1, 2),
        termination=("The agent reaches the goal.",
                     "The agent falls into lava.",
                     "Timeout (see `max_steps`)."),
        configurations="""
        In the registered ids, S is the grid side length and N the number
        of obstacle streams to cross between start and goal.
        """,
    )

    def __init__(self, size=9, num_crossings=1, obstacle_type="lava",
                 max_steps=None, device=None, **kw):
        if size % 2 != 1:
            raise ValueError(f"size must be odd, got {size}")
        if max_steps is None:
            max_steps = 4 * size**2
        super().__init__(EnvParams(width=size, height=size,
                                   max_steps=max_steps,
                                   see_through_walls=False, **kw),
                         device=device)
        self.num_crossings = num_crossings
        self.obstacle_type = obstacle_type

    def default_mission(self) -> str:
        if self.obstacle_type == "lava":
            return "avoid the lava and get to the green goal square"
        return "find the opening and get to the green goal square"

    def _gen_grid(self, generator, num_envs):
        p = self.params
        dev = self.device
        B, size, k = num_envs, p.width, self.num_crossings
        obstacle = X.LAVA_CELL if self.obstacle_type == "lava" \
            else X.WALL_CELL
        rng = random_keys(generator, (B, 2), dev)
        grid = G.empty_grid(B, size, size, dev)
        grid = G.wall_rect(grid, 0, 0, size, size)
        grid = G.set_cell(grid, size - 2, size - 2, X.GOAL_CELL)

        # candidate rivers: vertical at x, horizontal at y, both from
        # range(2, size-2, 2) (crossing.py:150-152); k of them per env
        cand = torch.arange(2, size - 2, 2, device=dev)
        n = cand.shape[0]
        is_v = torch.cat([torch.ones(n, dtype=torch.bool, device=dev),
                          torch.zeros(n, dtype=torch.bool, device=dev)])
        pos = torch.cat([cand, cand])
        perm = X.permutations(generator, B, 2 * n, dev)[:, :k]
        sel_v, sel_pos = is_v[perm], pos[perm]                  # (B, k)

        big = size  # beyond any real coordinate
        rivers_v = torch.where(sel_v, sel_pos, big).sort(dim=1).values
        rivers_h = torch.where(~sel_v, sel_pos, big).sort(dim=1).values
        nv = sel_v.sum(dim=1)
        nh = k - nv

        # paint the rivers over the interior
        xs, ys = G.coord_grids(size, size, dev)
        v_hit = ((xs[None, ..., None] == rivers_v[:, None, None, :])
                 & (rivers_v[:, None, None, :] < big)).any(-1)
        h_hit = ((ys[None, ..., None] == rivers_h[:, None, None, :])
                 & (rivers_h[:, None, None, :] < big)).any(-1)
        inner = (xs >= 1) & (xs < size - 1) & (ys >= 1) & (ys < size - 1)
        grid = G.fill_mask(grid, (v_hit | h_hit) & inner, obstacle)

        # the staircase of openings: nv horizontal and nh vertical moves in
        # a random order per env
        flags = torch.arange(k, device=dev)[None, :] < nv[:, None]
        flags_h = flags.gather(1, X.permutations(generator, B, k, dev))

        zero = torch.zeros((B, 1), dtype=torch.int64, device=dev)
        limits_v = torch.cat([zero, rivers_v], dim=1)           # (B, k+1)
        limits_h = torch.cat(
            [zero, torch.where(rivers_h < big, rivers_h, size - 1)], dim=1)

        def at(t, i):
            return t.gather(1, i[:, None])[:, 0]

        room_i = torch.zeros(B, dtype=torch.int64, device=dev)
        room_j = torch.zeros(B, dtype=torch.int64, device=dev)
        for step in range(k):
            is_h = flags_h[:, step]
            # h move: an opening in vertical river room_i at a random y of
            # the current band; v move: in horizontal river room_j at a
            # random x (crossing.py:175-186)
            gx_h = at(limits_v, room_i + 1)
            gy_h = X.randint(generator, at(limits_h, room_j) + 1,
                             torch.where(room_j + 1 <= nh,
                                         at(limits_h, room_j + 1), size - 1),
                             B, dev)
            gx_v = X.randint(generator, at(limits_v, room_i) + 1,
                             torch.where(room_i + 1 <= nv,
                                         at(limits_v, room_i + 1), size - 1),
                             B, dev)
            gy_v = at(limits_h, room_j + 1)
            gx = torch.where(is_h, gx_h, gx_v)
            gy = torch.where(is_h, gy_h, gy_v)
            grid = G.set_cell(grid, gx, gy, X.EMPTY_CELL)
            room_i = room_i + is_h.to(torch.int64)
            room_j = room_j + (~is_h).to(torch.int64)

        return self.make_state(grid, (1, 1), 0, rng=rng)
