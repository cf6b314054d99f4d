"""MultiRoom environment (reference minigrid/envs/multiroom.py:95-284).

Counterpart of ``minigrid_tpu/envs/multiroom.py``, batched. The JAX package
builds the chain of rooms with a bounded ``fori_loop``/``while_loop``
search: chain attempts (at most 256) until one reaches the drawn room
count, keeping the longest; within an attempt each room takes the first of
8 placement proposals that fits. Here those are masked batch loops with the
same bounds: the envs still short of their room count run another attempt
(one host sync per attempt), and the 8 proposals of a room are drawn at
once and the first that fits is taken.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid as G
from minigrid_tpu_torch.core import place
from minigrid_tpu_torch.core.types import EnvParams
from minigrid_tpu_torch.envs import common as X
from minigrid_tpu_torch.envs.base import MiniGridEnv, random_keys
from minigrid_tpu_torch.envs.envdoc import env_doc

MAX_ATTEMPTS = 256
PROPOSALS = 8


def _sel(cond, choices):
    """``choices[i]`` where ``cond == i`` (cond (B, ...) int, choices a
    list of tensors broadcastable to it)."""
    out = choices[-1]
    for i in range(len(choices) - 2, -1, -1):
        out = torch.where(cond == i, choices[i], out)
    return out


class MultiRoomEnv(MiniGridEnv):
    name = "MultiRoom"
    __doc__ = env_doc(
        """
        A chain of connected rooms, each entered through a colored door
        from the previous one; the green goal square waits in the last
        room. Hard for flat RL when the chain is long, but the room count
        scales, making it a natural curriculum axis. Constructor knobs:
        ``minNumRooms``/``maxNumRooms`` (rooms per episode),
        ``maxRoomSize`` (default 10), ``width``/``height`` of the map
        (default 25), and ``max_steps`` (default ``maxNumRooms * 20``).
        Reference: minigrid/envs/multiroom.py.
        """,
        '"traverse the rooms to get to the goal"',
        used=(0, 1, 2, 5),
        termination=("The agent reaches the goal.",
                     "Timeout (see `max_steps`)."),
        configurations="""
        - ``MiniGrid-MultiRoom-N2-S4-v0`` — two small rooms
        - ``MiniGrid-MultiRoom-N4-S5-v0`` — legacy id (misconfigured for
          six rooms, kept for compatibility)
        - ``MiniGrid-MultiRoom-N4-S5-v1`` — fixed four-room config
        - ``MiniGrid-MultiRoom-N6-v0`` — six rooms
        """,
    )

    def __init__(self, minNumRooms, maxNumRooms, maxRoomSize=10, width=25,
                 height=25, max_steps=None, device=None, **kw):
        if maxRoomSize < 4:
            raise ValueError(f"maxRoomSize must be >= 4, got {maxRoomSize}")
        if max_steps is None:
            max_steps = maxNumRooms * 20
        super().__init__(EnvParams(width=width, height=height,
                                   max_steps=max_steps, **kw), device=device)
        self.min_rooms = minNumRooms
        self.max_rooms = maxNumRooms
        self.max_room_size = maxRoomSize

    def default_mission(self) -> str:
        return "traverse the rooms to get to the goal"

    def _propose(self, generator, t, tops, sizes, entry_walls, count):
        """PROPOSALS placement proposals for room ``t`` of every env.
        Returns (ok, top, size, exit_pos, next_entry_wall), each (B, S) or
        (B, S, 2)."""
        p = self.params
        B, S, dev = tops.shape[0], PROPOSALS, tops.device
        n = B * S

        def draw(lo, hi):
            return X.randint(generator, lo, hi, n, dev).reshape(B, S).to(
                torch.int64)

        prev_top = tops[:, t - 1][:, None, :]                  # (B, 1, 2)
        prev_size = sizes[:, t - 1][:, None, :]
        prev_wall = entry_walls[:, t - 1][:, None]             # (B, 1)

        # the exit wall: uniform over the 3 walls other than the entry
        # wall (multiroom.py:240-244)
        r = draw(0, 3)
        exit_wall = r + (r >= prev_wall).to(torch.int64)
        next_wall = (exit_wall + 2) % 4

        # the exit door on that wall (multiroom.py:246-259)
        along_x = draw(1, (prev_size[..., 0] - 1).clamp(min=2).expand(
            B, S).reshape(-1))
        along_y = draw(1, (prev_size[..., 1] - 1).clamp(min=2).expand(
            B, S).reshape(-1))
        tx, ty = prev_top[..., 0], prev_top[..., 1]
        sx0, sy0 = prev_size[..., 0], prev_size[..., 1]
        ex = _sel(exit_wall, [tx + sx0 - 1, tx + along_x, tx, tx + along_x])
        ey = _sel(exit_wall, [ty + along_y, ty + sy0 - 1, ty + along_y, ty])

        # the room's size and top (multiroom.py:196-228)
        sx = draw(4, self.max_room_size + 1)
        sy = draw(4, self.max_room_size + 1)
        rx = draw((ey - sy + 2).reshape(-1), ey.reshape(-1))
        ry = draw((ex - sx + 2).reshape(-1), ex.reshape(-1))
        top_x = _sel(next_wall, [ex - sx + 1, ry, ex, ry])
        top_y = _sel(next_wall, [rx, ey - sy + 1, rx, ey])

        ok = (top_x >= 0) & (top_y >= 0)
        ok &= top_x + sx <= p.width
        ok &= top_y + sy < p.height
        # no overlap with any room but the immediate predecessor
        # (multiroom.py:231-241: < on the low side, <= on the high side)
        idx = torch.arange(tops.shape[1], device=dev)
        others = (idx[None, :] < count[:, None]) & (
            idx[None, :] != count[:, None] - 1)                # (B, N)
        ox, oy = tops[:, None, :, 0], tops[:, None, :, 1]      # (B, 1, N)
        osx, osy = sizes[:, None, :, 0], sizes[:, None, :, 1]
        non_overlap = ((top_x[..., None] + sx[..., None] < ox)
                       | (ox + osx <= top_x[..., None])
                       | (top_y[..., None] + sy[..., None] < oy)
                       | (oy + osy <= top_y[..., None]))       # (B, S, N)
        ok &= (non_overlap | ~others[:, None, :]).all(-1)
        return (ok, torch.stack([top_x, top_y], -1),
                torch.stack([sx, sy], -1), torch.stack([ex, ey], -1),
                next_wall)

    def _build_chain(self, generator, num_rooms):
        """One chain attempt for every env. Returns (tops, sizes,
        entry_pos, count), int64."""
        p = self.params
        B, N, dev = num_rooms.shape[0], self.max_rooms, num_rooms.device
        tops = torch.zeros((B, N, 2), dtype=torch.int64, device=dev)
        sizes = torch.zeros_like(tops)
        entry_pos = torch.zeros_like(tops)
        entry_walls = torch.zeros((B, N), dtype=torch.int64, device=dev)

        # room 0 (multiroom.py:127,197-199): its top at a random entry
        # position, entry wall 2 (left)
        def draw(lo, hi):
            return X.randint(generator, lo, hi, B, dev).to(torch.int64)

        e0 = torch.stack([draw(0, p.width - 2), draw(0, p.width - 2)], -1)
        s0 = torch.stack([draw(4, self.max_room_size + 1),
                          draw(4, self.max_room_size + 1)], -1)
        ok0 = (e0[:, 0] + s0[:, 0] <= p.width) & (
            e0[:, 1] + s0[:, 1] < p.height)
        tops[:, 0], sizes[:, 0], entry_pos[:, 0] = e0, s0, e0
        entry_walls[:, 0] = 2
        count = ok0.to(torch.int64)

        for t in range(1, N):
            ok, top, size, exit_pos, wall = self._propose(
                generator, t, tops, sizes, entry_walls, count)
            found = ok.any(1)
            first = ok.to(torch.int8).argmax(1)                 # first ok
            b = torch.arange(B, device=dev)
            grow = found & (count == t) & (t < num_rooms)
            g2 = grow[:, None]
            tops[:, t] = torch.where(g2, top[b, first], tops[:, t])
            sizes[:, t] = torch.where(g2, size[b, first], sizes[:, t])
            entry_walls[:, t] = torch.where(grow, wall[b, first],
                                            entry_walls[:, t])
            entry_pos[:, t] = torch.where(g2, exit_pos[b, first],
                                          entry_pos[:, t])
            count = torch.where(grow, count + 1, count)
        return tops, sizes, entry_pos, count

    def _gen_grid(self, generator, num_envs):
        p = self.params
        dev = self.device
        B, N = num_envs, self.max_rooms
        rng = random_keys(generator, (B, 2), dev)
        num_rooms = X.randint(generator, self.min_rooms, self.max_rooms + 1,
                              B, dev).to(torch.int64)

        # chain attempts until one reaches num_rooms, keeping the longest
        # (multiroom.py:120-139), at most MAX_ATTEMPTS per env
        best = torch.zeros(B, dtype=torch.int64, device=dev)
        tops = torch.zeros((B, N, 2), dtype=torch.int64, device=dev)
        sizes = torch.zeros_like(tops)
        entry_pos = torch.zeros_like(tops)
        for _ in range(MAX_ATTEMPTS):
            todo = torch.nonzero(best < num_rooms)[:, 0]
            if todo.numel() == 0:
                break
            t_, s_, e_, c_ = self._build_chain(generator, num_rooms[todo])
            better = c_ > best[todo]
            b3 = better[:, None, None]
            best[todo] = torch.where(better, c_, best[todo])
            tops[todo] = torch.where(b3, t_, tops[todo])
            sizes[todo] = torch.where(b3, s_, sizes[todo])
            entry_pos[todo] = torch.where(b3, e_, entry_pos[todo])
        count = best

        # paint the rooms in order: walls, then the entry door
        # (multiroom.py:148-189); each door's colour differs from the one
        # before (:165-174)
        grid = G.empty_grid(B, p.width, p.height, dev)
        prev_color = torch.full((B,), -1, dtype=torch.int64, device=dev)
        for t in range(N):
            active = t < count
            x0, y0 = tops[:, t, 0], tops[:, t, 1]
            w, h = sizes[:, t, 0], sizes[:, t, 1]
            painted = G.fill_rect(grid, x0, y0, w, 1, X.WALL_CELL)
            painted = G.fill_rect(painted, x0, y0 + h - 1, w, 1, X.WALL_CELL)
            painted = G.fill_rect(painted, x0, y0, 1, h, X.WALL_CELL)
            painted = G.fill_rect(painted, x0 + w - 1, y0, 1, h, X.WALL_CELL)
            if t > 0:
                j6 = X.randint(generator, 0, 6, B, dev).to(torch.int64)
                j5 = X.randint(generator, 0, 5, B, dev).to(torch.int64)
                j5 = j5 + (j5 >= prev_color).to(torch.int64)
                color_idx = torch.where(prev_color < 0, j6, j5)
                door = X.cells(C.DOOR, X.take(X.SORTED_COLOR_IDS, color_idx),
                               C.CLOSED, device=dev)
                painted = G.set_cell(painted, entry_pos[:, t, 0],
                                     entry_pos[:, t, 1], door)
                prev_color = torch.where(active, color_idx, prev_color)
            grid = torch.where(active[:, None, None, None], painted, grid)

        # the agent in room 0, the goal in the last room (:181-186)
        rect0 = place.rect_mask(p.width, p.height, (tops[:, 0, 0],
                                                    tops[:, 0, 1]),
                                (sizes[:, 0, 0], sizes[:, 0, 1]), dev)
        agent_pos = place.sample_from_mask(generator,
                                           G.free_mask(grid) & rect0)
        agent_dir = X.randint(generator, 0, 4, B, dev)
        b = torch.arange(B, device=dev)
        last = (count - 1).clamp(min=0)
        rect_l = place.rect_mask(
            p.width, p.height, (tops[b, last, 0], tops[b, last, 1]),
            (sizes[b, last, 0], sizes[b, last, 1]), dev)
        goal_mask = place.placeable_mask(grid, agent_pos) & rect_l
        goal_pos = place.sample_from_mask(generator, goal_mask)
        grid = G.set_cell(grid, goal_pos[:, 0], goal_pos[:, 1], X.GOAL_CELL)
        return self.make_state(grid, agent_pos, agent_dir, rng=rng)
