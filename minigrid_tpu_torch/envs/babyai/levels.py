"""The 40 BabyAI level classes (reference minigrid/envs/babyai/{goto,open,
pickup,putnext,unlock,other,synth}.py).

Counterpart of ``minigrid_tpu/envs/babyai/levels.py``, batched: each
``gen_mission(generator, b)`` builds B levels with the batched RoomGrid
builder and returns ``(builder, spec, ok)``."""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid as G
from minigrid_tpu_torch.core import roomgrid as RG
from minigrid_tpu_torch.envs.babyai.core import instrs as I
from minigrid_tpu_torch.envs.babyai.core import level as L
from minigrid_tpu_torch.envs.babyai.core.level import (RoomGridLevel,
                                                       before_instr, desc,
                                                       desc_from_kind_color,
                                                       leaf, single)
from minigrid_tpu_torch.envs.babyai.core.levelgen import LevelGen
from minigrid_tpu_torch.envs.common import permutations

RED = C.COLOR_TO_IDX["red"]
BLUE = C.COLOR_TO_IDX["blue"]
GREY = C.COLOR_TO_IDX["grey"]
BALL_T, BOX_T, KEY_T, DOOR_T = 1, 0, 2, 3  # OBJ_TYPES indices


def _true(b):
    return torch.ones(b.batch_size, dtype=torch.bool, device=b.device)


def _pick(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[b, idx[b]]`` for a (B, n) table."""
    return table.gather(1, idx.to(torch.int64)[:, None])[:, 0]


def _randint(generator, b, lo, hi):
    return RG.randint(generator, lo, hi, b.batch_size, b.device)


def _perm(generator, b, n):
    return permutations(generator, b.batch_size, n, b.device)


def pick_dist(generator, kinds, colors):
    """A uniform choice among the placed distractors, as a descriptor."""
    idx = RG.randint(generator, 0, kinds.shape[1], kinds.shape[0],
                     kinds.device)
    return desc_from_kind_color(_pick(kinds, idx), _pick(colors, idx))


def sample_door_cell(b, generator):
    """A uniform door cell -> (pos (B, 2), colour (B,)) (open.py:19-33)."""
    B, W, H = b.grid.shape[:3]
    flat = RG.categorical(generator,
                          (b.grid[..., 0] == C.DOOR).reshape(B, -1))
    pos = torch.stack([flat // H, flat % H], -1)
    bi = torch.arange(B, device=b.device)
    return pos.to(torch.int32), b.grid[bi, pos[:, 0], pos[:, 1], 1].to(
        torch.int32)


def recolor_positions(b, positions, color):
    """Set the colour channel at each of the (B, n, 2) positions
    (GoToRedBallGrey, goto.py:72-73)."""
    grid = b.grid
    xs, ys = G.coord_grids(grid.shape[1], grid.shape[2], grid.device)
    p = positions.to(torch.int64)
    hit = ((xs[None, ..., None] == p[:, None, None, :, 0])
           & (ys[None, ..., None] == p[:, None, None, :, 1])).any(-1)
    grid = grid.clone()
    grid[..., 1] = torch.where(hit, color, grid[..., 1])
    return b.replace(grid=grid)


def _outside_room(generator, layout, i, j, num_envs, device):
    """A uniform room other than (i, j) per env: (i, j) int64."""
    return L.sample_room(generator, layout, num_envs, device, exclude=(i, j))


def _distractors_outside(b, layout, generator, n, skip_i, skip_j):
    """``n`` distractors in every room but (skip_i, skip_j) per env
    (goto.py:506-509)."""
    for i in range(layout.num_cols):
        for j in range(layout.num_rows):
            nb, *_ = RG.add_distractors(b, layout, generator, i, j, n,
                                        all_unique=False)
            b = b.where((skip_i == i) & (skip_j == j), nb)
    return b


def _kind_types(kinds):
    """OBJ_TYPES index of each roomgrid kind [key, ball, box]."""
    return torch.where(kinds == 0, KEY_T, torch.where(kinds == 1, BALL_T,
                                                      BOX_T))


# ---------------------------------------------------------------------------
# GoTo family (goto.py)
# ---------------------------------------------------------------------------

class GoToRedBallGrey(RoomGridLevel):
    def __init__(self, room_size=8, num_dists=7, **kw):
        super().__init__(num_rows=1, num_cols=1, room_size=room_size, **kw)
        self.num_dists = num_dists

    def gen_mission(self, generator, b):
        b = RG.place_agent(b, self.layout, generator, 0, 0)
        b, _ = RG.place_in_room(b, self.layout, generator, 0, 0,
                                RG.cell(C.BALL, RED, device=b.device))
        b, _, _, pos = RG.add_distractors(b, self.layout, generator, 0, 0,
                                          self.num_dists, all_unique=False)
        b = recolor_positions(b, pos, GREY)
        return (b, single(leaf(I.GOTO, desc(BALL_T, RED))),
                L.check_objs_reachable(b))


class GoToRedBall(RoomGridLevel):
    def __init__(self, room_size=8, num_dists=7, **kw):
        super().__init__(num_rows=1, num_cols=1, room_size=room_size, **kw)
        self.num_dists = num_dists

    def gen_mission(self, generator, b):
        b = RG.place_agent(b, self.layout, generator, 0, 0)
        b, _ = RG.place_in_room(b, self.layout, generator, 0, 0,
                                RG.cell(C.BALL, RED, device=b.device))
        b, *_ = RG.add_distractors(b, self.layout, generator, 0, 0,
                                   self.num_dists, all_unique=False)
        return (b, single(leaf(I.GOTO, desc(BALL_T, RED))),
                L.check_objs_reachable(b))


class GoToRedBallNoDists(GoToRedBall):
    def __init__(self, **kw):
        super().__init__(room_size=8, num_dists=0, **kw)


class GoToObj(RoomGridLevel):
    def __init__(self, room_size=8, **kw):
        super().__init__(num_rows=1, num_cols=1, room_size=room_size, **kw)

    def gen_mission(self, generator, b):
        b = RG.place_agent(b, self.layout, generator, 0, 0)
        b, kinds, colors, _ = RG.add_distractors(b, self.layout, generator,
                                                 num_distractors=1)
        return (b, single(leaf(I.GOTO, desc_from_kind_color(
            kinds[:, 0], colors[:, 0]))), _true(b))


class GoToLocal(RoomGridLevel):
    def __init__(self, room_size=8, num_dists=8, **kw):
        super().__init__(num_rows=1, num_cols=1, room_size=room_size, **kw)
        self.num_dists = num_dists

    def gen_mission(self, generator, b):
        b = RG.place_agent(b, self.layout, generator, 0, 0)
        b, kinds, colors, _ = RG.add_distractors(
            b, self.layout, generator, num_distractors=self.num_dists,
            all_unique=False)
        ok = L.check_objs_reachable(b)
        return b, single(leaf(I.GOTO, pick_dist(generator, kinds,
                                                colors))), ok


class GoTo(RoomGridLevel):
    def __init__(self, room_size=8, num_rows=3, num_cols=3, num_dists=18,
                 doors_open=False, **kw):
        super().__init__(num_rows=num_rows, num_cols=num_cols,
                         room_size=room_size, **kw)
        self.num_dists = num_dists
        self.doors_open = doors_open

    def gen_mission(self, generator, b):
        b = RG.place_agent(b, self.layout, generator)
        b = RG.connect_all(b, self.layout, generator)
        b, kinds, colors, _ = RG.add_distractors(
            b, self.layout, generator, num_distractors=self.num_dists,
            all_unique=False)
        ok = L.check_objs_reachable(b)
        if self.doors_open:
            b = L.open_all_doors(b)
        return b, single(leaf(I.GOTO, pick_dist(generator, kinds,
                                                colors))), ok


class GoToImpUnlock(RoomGridLevel):
    def gen_mission(self, generator, b):
        Lt, B, dev = self.layout, b.batch_size, b.device
        id_ = _randint(generator, b, 0, Lt.num_cols)
        jd = _randint(generator, b, 0, Lt.num_rows)
        b, door_color, _ = RG.add_door(b, Lt, generator, id_, jd, None,
                                       locked=True)
        ki, kj = _outside_room(generator, Lt, id_, jd, B, dev)
        b, *_ = RG.add_object(b, Lt, generator, ki, kj, kind=0,
                              color=door_color)
        b = RG.connect_all(b, Lt, generator)
        # two distractors in every room but the locked one (goto.py:506-509)
        b = _distractors_outside(b, Lt, generator, 2, id_, jd)
        ai, aj = _outside_room(generator, Lt, id_, jd, B, dev)
        b = RG.place_agent(b, Lt, generator, ai, aj)
        ok = L.check_objs_reachable(b)
        b, kinds, colors, _ = RG.add_distractors(b, Lt, generator, id_, jd, 1,
                                                 all_unique=False)
        return b, single(leaf(I.GOTO, desc_from_kind_color(
            kinds[:, 0], colors[:, 0]))), ok


class GoToSeq(LevelGen):
    def __init__(self, room_size=8, num_rows=3, num_cols=3, num_dists=18,
                 **kw):
        super().__init__(room_size=room_size, num_rows=num_rows,
                         num_cols=num_cols, num_dists=num_dists,
                         action_kinds=["goto"], locked_room_prob=0,
                         locations=False, unblocking=False, **kw)


class GoToRedBlueBall(RoomGridLevel):
    def __init__(self, room_size=8, num_dists=7, **kw):
        super().__init__(num_rows=1, num_cols=1, room_size=room_size, **kw)
        self.num_dists = num_dists

    def gen_mission(self, generator, b):
        b = RG.place_agent(b, self.layout, generator, 0, 0)
        b, kinds, colors, _ = RG.add_distractors(
            b, self.layout, generator, num_distractors=self.num_dists,
            all_unique=False)
        # no distractor may be a red or blue ball (goto.py:666-669)
        bad = ((kinds == 1) & ((colors == RED) | (colors == BLUE))).any(-1)
        color = torch.where(_randint(generator, b, 0, 2) == 0, RED, BLUE)
        b, _ = RG.place_in_room(b, self.layout, generator, 0, 0,
                                RG.cell(C.BALL, color, device=b.device))
        ok = ~bad & L.check_objs_reachable(b)
        return b, single(leaf(I.GOTO, desc(BALL_T, color))), ok


class GoToDoorLevel(RoomGridLevel):
    def __init__(self, **kw):
        super().__init__(room_size=7, **kw)

    def gen_mission(self, generator, b):
        colors = []
        for _ in range(4):
            b, color, _ = RG.add_door(b, self.layout, generator, 1, 1, None)
            colors.append(color)
        b = RG.place_agent(b, self.layout, generator, 1, 1)
        color = _pick(torch.stack(colors, 1), _randint(generator, b, 0, 4))
        return b, single(leaf(I.GOTO, desc(DOOR_T, color))), _true(b)


class GoToObjDoor(RoomGridLevel):
    def __init__(self, **kw):
        super().__init__(room_size=8, **kw)

    def gen_mission(self, generator, b):
        b = RG.place_agent(b, self.layout, generator, 1, 1)
        b, kinds, colors, _ = RG.add_distractors(b, self.layout, generator,
                                                 1, 1, 8, all_unique=False)
        door_colors = []
        for _ in range(4):
            b, dcolor, _ = RG.add_door(b, self.layout, generator, 1, 1, None)
            door_colors.append(dcolor)
        all_types = torch.cat([_kind_types(kinds),
                               torch.full_like(kinds[:, :4], DOOR_T)], 1)
        all_colors = torch.cat([colors, torch.stack(door_colors, 1)], 1)
        ok = L.check_objs_reachable(b)
        pick = _randint(generator, b, 0, 12)
        return b, single(leaf(I.GOTO, desc(_pick(all_types, pick),
                                           _pick(all_colors, pick)))), ok


# ---------------------------------------------------------------------------
# Open family (open.py)
# ---------------------------------------------------------------------------

class Open(RoomGridLevel):
    def gen_mission(self, generator, b):
        b = RG.place_agent(b, self.layout, generator)
        b = RG.connect_all(b, self.layout, generator)
        b, *_ = RG.add_distractors(b, self.layout, generator,
                                   num_distractors=18, all_unique=False)
        ok = L.check_objs_reachable(b)
        _, color = sample_door_cell(b, generator)
        return b, single(leaf(I.OPEN, desc(DOOR_T, color))), ok


class OpenRedDoor(RoomGridLevel):
    def __init__(self, **kw):
        super().__init__(num_rows=1, num_cols=2, room_size=5, **kw)

    def gen_mission(self, generator, b):
        b, _, _ = RG.add_door(b, self.layout, generator, 0, 0, 0, color=RED,
                              locked=False)
        b = RG.place_agent(b, self.layout, generator, 0, 0)
        return b, single(leaf(I.OPEN, desc(DOOR_T, RED))), _true(b)


class OpenDoor(RoomGridLevel):
    def __init__(self, debug=False, select_by=None, **kw):
        super().__init__(**kw)
        self.select_by = select_by
        self.debug = debug

    def gen_mission(self, generator, b):
        door_colors = RG.sorted_color(_perm(generator, b, 6)[:, :4])
        for i in range(4):
            b, _, _ = RG.add_door(b, self.layout, generator, 1, 1, i,
                                  color=door_colors[:, i], locked=False)
        if self.select_by is None:
            by_color = _randint(generator, b, 0, 2) == 0
        else:
            by_color = torch.full_like(door_colors[:, 0], self.select_by
                                       == "color", dtype=torch.bool)
        loc = _randint(generator, b, 0, 4)
        d = (DOOR_T,
             torch.where(by_color, door_colors[:, 0].to(torch.int64),
                         I.COLOR_NONE),
             torch.where(by_color, I.LOC_NONE, loc))
        b = RG.place_agent(b, self.layout, generator, 1, 1)
        return b, single(leaf(I.OPEN, d, strict=self.debug)), _true(b)


class OpenTwoDoors(RoomGridLevel):
    def __init__(self, first_color=None, second_color=None, strict=False,
                 max_steps=None, **kw):
        room_size = 6
        if max_steps is None:
            max_steps = 20 * room_size**2
        super().__init__(room_size=room_size, max_steps=max_steps, **kw)
        self.first_color = first_color
        self.second_color = second_color
        self.strict = strict

    def gen_mission(self, generator, b):
        colors = RG.sorted_color(_perm(generator, b, 6)[:, :2])
        first = (C.COLOR_TO_IDX[self.first_color] if self.first_color
                 else colors[:, 0])
        second = (C.COLOR_TO_IDX[self.second_color] if self.second_color
                  else colors[:, 1])
        b, _, _ = RG.add_door(b, self.layout, generator, 1, 1, 2,
                              color=first, locked=False)
        b, _, _ = RG.add_door(b, self.layout, generator, 1, 1, 0,
                              color=second, locked=False)
        b = RG.place_agent(b, self.layout, generator, 1, 1)
        spec = before_instr(
            [leaf(I.OPEN, desc(DOOR_T, first), strict=self.strict)],
            [leaf(I.OPEN, desc(DOOR_T, second))])
        return b, spec, _true(b)


def seq_or_single(mode, l1, l2):
    """Per env: single(l1) (mode 0), before(l1, l2) (1) or after(l1, l2)
    (2)."""
    spec = before_instr([l1], [l2])
    root = torch.where(mode == 0, I.ROOT_ACTION,
                       torch.where(mode == 1, I.ROOT_BEFORE, I.ROOT_AFTER))
    leaves = list(spec["leaves"])
    leaves[2] = {**leaves[2], "kind": torch.where(mode == 0, I.UNUSED,
                                                  leaves[2]["kind"])}
    return {**spec, "root": root, "leaves": leaves}


class OpenDoorsOrder(RoomGridLevel):
    def __init__(self, num_doors, debug=False, max_steps=None, **kw):
        if num_doors < 2:
            raise ValueError(f"num_doors must be >= 2, got {num_doors}")
        room_size = 6
        if max_steps is None:
            max_steps = 20 * room_size**2
        super().__init__(room_size=room_size, max_steps=max_steps, **kw)
        self.num_doors = num_doors
        self.debug = debug

    def gen_mission(self, generator, b):
        n = self.num_doors
        colors = RG.sorted_color(_perm(generator, b, 6)[:, :n])
        for i in range(n):
            b, _, _ = RG.add_door(b, self.layout, generator, 1, 1, None,
                                  color=colors[:, i], locked=False)
        b = RG.place_agent(b, self.layout, generator, 1, 1)
        perm = _perm(generator, b, n)[:, :2]
        l1 = leaf(I.OPEN, desc(DOOR_T, _pick(colors, perm[:, 0])),
                  strict=self.debug)
        l2 = leaf(I.OPEN, desc(DOOR_T, _pick(colors, perm[:, 1])),
                  strict=self.debug)
        mode = _randint(generator, b, 0, 3)
        return b, seq_or_single(mode, l1, l2), _true(b)


# ---------------------------------------------------------------------------
# Pickup family (pickup.py)
# ---------------------------------------------------------------------------

class Pickup(RoomGridLevel):
    def gen_mission(self, generator, b):
        b = RG.place_agent(b, self.layout, generator)
        b = RG.connect_all(b, self.layout, generator)
        b, kinds, colors, _ = RG.add_distractors(
            b, self.layout, generator, num_distractors=18, all_unique=False)
        ok = L.check_objs_reachable(b)
        return b, single(leaf(I.PICKUP, pick_dist(generator, kinds,
                                                  colors))), ok


class UnblockPickup(RoomGridLevel):
    def gen_mission(self, generator, b):
        b = RG.place_agent(b, self.layout, generator)
        b = RG.connect_all(b, self.layout, generator)
        b, kinds, colors, _ = RG.add_distractors(
            b, self.layout, generator, num_distractors=20, all_unique=False)
        # unblocking must be needed (pickup.py:84-86)
        ok = ~L.check_objs_reachable(b)
        return b, single(leaf(I.PICKUP, pick_dist(generator, kinds,
                                                  colors))), ok


class PickupLoc(LevelGen):
    def __init__(self, **kw):
        super().__init__(action_kinds=["pickup"], instr_kinds=["action"],
                         num_rows=1, num_cols=1, num_dists=8,
                         locked_room_prob=0, locations=True,
                         unblocking=False, **kw)


class PickupDist(RoomGridLevel):
    def __init__(self, debug=False, **kw):
        super().__init__(num_rows=1, num_cols=1, room_size=7, **kw)
        self.debug = debug

    def gen_mission(self, generator, b):
        b, kinds, colors, _ = RG.add_distractors(b, self.layout, generator,
                                                 num_distractors=5)
        b = RG.place_agent(b, self.layout, generator, 0, 0)
        idx = _randint(generator, b, 0, 5)
        dtype, dcolor, dloc = desc_from_kind_color(_pick(kinds, idx),
                                                   _pick(colors, idx))
        # select_by: 0 = type (no colour), 1 = colour (no type), 2 = both
        sel = _randint(generator, b, 0, 3)
        dtype = torch.where(sel == 1, I.TYPE_NONE, dtype)
        dcolor = torch.where(sel == 0, I.COLOR_NONE, dcolor.to(torch.int64))
        return b, single(leaf(I.PICKUP, (dtype, dcolor, dloc),
                              strict=self.debug)), _true(b)


class PickupAbove(RoomGridLevel):
    def __init__(self, max_steps=None, **kw):
        room_size = 6
        if max_steps is None:
            max_steps = 8 * room_size**2
        super().__init__(room_size=room_size, max_steps=max_steps, **kw)

    def gen_mission(self, generator, b):
        b, kind, color, _ = RG.add_object(b, self.layout, generator, 1, 0)
        b, _, _ = RG.add_door(b, self.layout, generator, 1, 1, 3,
                              locked=False)
        b = RG.place_agent(b, self.layout, generator, 1, 1)
        b = RG.connect_all(b, self.layout, generator)
        return b, single(leaf(I.PICKUP, desc_from_kind_color(kind, color))), \
            _true(b)


# ---------------------------------------------------------------------------
# PutNext family (putnext.py)
# ---------------------------------------------------------------------------

class PutNextLocal(RoomGridLevel):
    def __init__(self, room_size=8, num_objs=8, **kw):
        super().__init__(num_rows=1, num_cols=1, room_size=room_size, **kw)
        self.num_objs = num_objs

    def gen_mission(self, generator, b):
        b = RG.place_agent(b, self.layout, generator, 0, 0)
        b, kinds, colors, _ = RG.add_distractors(
            b, self.layout, generator, num_distractors=self.num_objs,
            all_unique=True)
        ok = L.check_objs_reachable(b)
        perm = _perm(generator, b, self.num_objs)[:, :2]
        d1 = desc_from_kind_color(_pick(kinds, perm[:, 0]),
                                  _pick(colors, perm[:, 0]))
        d2 = desc_from_kind_color(_pick(kinds, perm[:, 1]),
                                  _pick(colors, perm[:, 1]))
        return b, single(leaf(I.PUTNEXT, d1, d2)), ok


class PutNext(RoomGridLevel):
    def __init__(self, room_size, objs_per_room, start_carrying=False,
                 max_steps=None, **kw):
        if room_size < 4 or objs_per_room > 9:
            raise ValueError("PutNext needs room_size >= 4 and at most 9 "
                             "objects per room")
        if max_steps is None:
            max_steps = 8 * room_size**2
        super().__init__(num_rows=1, num_cols=2, room_size=room_size,
                         max_steps=max_steps, **kw)
        self.objs_per_room = objs_per_room
        self.start_carrying = start_carrying

    def gen_mission(self, generator, b):
        n, Lt = self.objs_per_room, self.layout
        b = RG.place_agent(b, Lt, generator, 0, 0)
        b, kl, cl, pl = RG.add_distractors(b, Lt, generator, 0, 0, n)
        b, kr, cr, pr = RG.add_distractors(b, Lt, generator, 1, 0, n)
        b = RG.remove_wall(b, Lt, 0, 0, 0)
        ia = _randint(generator, b, 0, n)
        ib = _randint(generator, b, 0, n)
        swap = (_randint(generator, b, 0, 2) == 0)
        ka = torch.where(swap, _pick(kr, ib), _pick(kl, ia))
        ca = torch.where(swap, _pick(cr, ib), _pick(cl, ia))
        kb = torch.where(swap, _pick(kl, ia), _pick(kr, ib))
        cb = torch.where(swap, _pick(cl, ia), _pick(cr, ib))
        pa = torch.where(swap[:, None], pr.gather(1, ib[:, None, None].expand(
            -1, 1, 2))[:, 0], pl.gather(1, ia[:, None, None].expand(
                -1, 1, 2))[:, 0])
        spec = single(leaf(I.PUTNEXT, desc_from_kind_color(ka, ca),
                           desc_from_kind_color(kb, cb)))
        if self.start_carrying:
            spec["carry_pos"] = pa
        return b, spec, _true(b)

    def _finalize_state(self, state, spec):
        if not self.start_carrying:
            return state
        # obj_a moves into the agent's hands (putnext.py:193-202)
        pos = spec["carry_pos"].to(torch.int64)
        bi = torch.arange(state.batch_size, device=state.device)
        cell = state.grid[bi, pos[:, 0], pos[:, 1]]
        grid = G.set_cell(state.grid, pos[:, 0], pos[:, 1], C.EMPTY_CELL)
        ys = torch.arange(state.grid.shape[2], device=state.device)
        here = torch.where(ys[None] == pos[:, 1, None],
                           torch.ones_like(pos[:, :1]) << pos[:, :1], 0).to(
            torch.int32)[:, None]                              # (B, 1, H)
        objs = state.extra["instr.descs.mask_objs"]
        at_pos = ((objs & here) != 0).any(-1)
        extra = {**state.extra,
                 "instr.descs.mask_objs": objs & ~here,
                 "instr.descs.carried":
                     state.extra["instr.descs.carried"] | at_pos}
        return state.replace(grid=grid, carrying=cell, extra=extra)


class MoveTwoAcross(RoomGridLevel):
    def __init__(self, room_size, objs_per_room, max_steps=None, **kw):
        if objs_per_room > 9:
            raise ValueError("MoveTwoAcross takes at most 9 objects per room")
        if max_steps is None:
            max_steps = 16 * room_size**2
        super().__init__(num_rows=1, num_cols=2, room_size=room_size,
                         max_steps=max_steps, **kw)
        self.objs_per_room = objs_per_room

    def gen_mission(self, generator, b):
        n, Lt = self.objs_per_room, self.layout
        b = RG.place_agent(b, Lt, generator, 0, 0)
        b, kl, cl, _ = RG.add_distractors(b, Lt, generator, 0, 0, n)
        b, kr, cr, _ = RG.add_distractors(b, Lt, generator, 1, 0, n)
        b = RG.remove_wall(b, Lt, 0, 0, 0)
        pl_ = _perm(generator, b, n)[:, :2]
        pr_ = _perm(generator, b, n)[:, :2]

        def d(kinds, colors, idx):
            return desc_from_kind_color(_pick(kinds, idx),
                                        _pick(colors, idx))

        spec = before_instr(
            [leaf(I.PUTNEXT, d(kl, cl, pl_[:, 0]), d(kr, cr, pr_[:, 0]))],
            [leaf(I.PUTNEXT, d(kr, cr, pr_[:, 1]), d(kl, cl, pl_[:, 1]))])
        return b, spec, _true(b)


# ---------------------------------------------------------------------------
# Unlock family (unlock.py)
# ---------------------------------------------------------------------------

class Unlock(RoomGridLevel):
    def gen_mission(self, generator, b):
        Lt, B, dev = self.layout, b.batch_size, b.device
        id_ = _randint(generator, b, 0, Lt.num_cols)
        jd = _randint(generator, b, 0, Lt.num_rows)
        b, door_color, _ = RG.add_door(b, Lt, generator, id_, jd, None,
                                       locked=True)
        ki, kj = _outside_room(generator, Lt, id_, jd, B, dev)
        b, *_ = RG.add_object(b, Lt, generator, ki, kj, kind=0,
                              color=door_color)
        avoid = _randint(generator, b, 0, 2) == 0
        b = RG.connect_all(b, Lt, generator, exclude_color=torch.where(
            avoid, door_color.to(torch.int64), -1))
        b = _distractors_outside(b, Lt, generator, 3, id_, jd)
        ai, aj = _outside_room(generator, Lt, id_, jd, B, dev)
        b = RG.place_agent(b, Lt, generator, ai, aj)
        ok = L.check_objs_reachable(b)
        return b, single(leaf(I.OPEN, desc(DOOR_T, door_color))), ok


class UnlockLocal(RoomGridLevel):
    def __init__(self, distractors=False, **kw):
        super().__init__(**kw)
        self.distractors = distractors

    def gen_mission(self, generator, b):
        b, door_color, _ = RG.add_door(b, self.layout, generator, 1, 1, None,
                                       locked=True)
        b, *_ = RG.add_object(b, self.layout, generator, 1, 1, kind=0,
                              color=door_color)
        if self.distractors:
            b, *_ = RG.add_distractors(b, self.layout, generator, 1, 1, 3)
        b = RG.place_agent(b, self.layout, generator, 1, 1)
        return b, single(leaf(I.OPEN, desc(DOOR_T))), _true(b)


class KeyInBox(RoomGridLevel):
    def gen_mission(self, generator, b):
        b, door_color, _ = RG.add_door(b, self.layout, generator, 1, 1, None,
                                       locked=True)
        box_color = RG.sorted_color(_randint(generator, b, 0, 6))
        box = RG.cell(C.BOX, box_color, 0, C.KEY, door_color,
                      device=b.device)
        b, _ = RG.place_in_room(b, self.layout, generator, 1, 1, box)
        b = RG.place_agent(b, self.layout, generator, 1, 1)
        return b, single(leaf(I.OPEN, desc(DOOR_T))), _true(b)


class UnlockPickup(RoomGridLevel):
    def __init__(self, distractors=False, max_steps=None, **kw):
        room_size = 6
        if max_steps is None:
            max_steps = 8 * room_size**2
        super().__init__(num_rows=1, num_cols=2, room_size=room_size,
                         max_steps=max_steps, **kw)
        self.distractors = distractors

    def gen_mission(self, generator, b):
        Lt = self.layout
        b, _, box_color, _ = RG.add_object(b, Lt, generator, 1, 0, kind=2)
        b, door_color, _ = RG.add_door(b, Lt, generator, 0, 0, 0, locked=True)
        b, *_ = RG.add_object(b, Lt, generator, 0, 0, kind=0,
                              color=door_color)
        if self.distractors:
            b, *_ = RG.add_distractors(b, Lt, generator, num_distractors=4)
        b = RG.place_agent(b, Lt, generator, 0, 0)
        return b, single(leaf(I.PICKUP, desc(BOX_T, box_color))), _true(b)


class BlockedUnlockPickup(RoomGridLevel):
    def __init__(self, max_steps=None, **kw):
        room_size = 6
        if max_steps is None:
            max_steps = 16 * room_size**2
        super().__init__(num_rows=1, num_cols=2, room_size=room_size,
                         max_steps=max_steps, **kw)

    def gen_mission(self, generator, b):
        Lt = self.layout
        b, *_ = RG.add_object(b, Lt, generator, 1, 0, kind=2)
        b, door_color, pos = RG.add_door(b, Lt, generator, 0, 0, 0,
                                         locked=True)
        ball_color = RG.sorted_color(_randint(generator, b, 0, 6))
        b = b.replace(grid=G.set_cell(b.grid, pos[:, 0] - 1, pos[:, 1],
                                      RG.cell(C.BALL, ball_color,
                                              device=b.device)))
        b, *_ = RG.add_object(b, Lt, generator, 0, 0, kind=0,
                              color=door_color)
        b = RG.place_agent(b, Lt, generator, 0, 0)
        return b, single(leaf(I.PICKUP, desc(BOX_T))), _true(b)


class UnlockToUnlock(RoomGridLevel):
    def __init__(self, max_steps=None, **kw):
        room_size = 6
        if max_steps is None:
            max_steps = 30 * room_size**2
        super().__init__(num_rows=1, num_cols=3, room_size=room_size,
                         max_steps=max_steps, **kw)

    def gen_mission(self, generator, b):
        Lt = self.layout
        colors = RG.sorted_color(_perm(generator, b, 6)[:, :2])
        b, _, _ = RG.add_door(b, Lt, generator, 0, 0, 0, color=colors[:, 0],
                              locked=True)
        b, *_ = RG.add_object(b, Lt, generator, 2, 0, kind=0,
                              color=colors[:, 0])
        b, _, _ = RG.add_door(b, Lt, generator, 1, 0, 0, color=colors[:, 1],
                              locked=True)
        b, *_ = RG.add_object(b, Lt, generator, 1, 0, kind=0,
                              color=colors[:, 1])
        b, *_ = RG.add_object(b, Lt, generator, 0, 0, kind=1)
        b = RG.place_agent(b, Lt, generator, 1, 0)
        return b, single(leaf(I.PICKUP, desc(BALL_T))), _true(b)


# ---------------------------------------------------------------------------
# Other (other.py)
# ---------------------------------------------------------------------------

class ActionObjDoor(RoomGridLevel):
    def __init__(self, **kw):
        super().__init__(room_size=7, **kw)

    def gen_mission(self, generator, b):
        b, kinds, colors, _ = RG.add_distractors(b, self.layout, generator,
                                                 1, 1, 5)
        door_colors = []
        for _ in range(4):
            b, dc, _ = RG.add_door(b, self.layout, generator, 1, 1, None,
                                   locked=False)
            door_colors.append(dc)
        b = RG.place_agent(b, self.layout, generator, 1, 1)
        all_types = torch.cat([_kind_types(kinds),
                               torch.full_like(kinds[:, :4], DOOR_T)], 1)
        all_colors = torch.cat([colors, torch.stack(door_colors, 1)], 1)
        pick = _randint(generator, b, 0, 9)
        t, c = _pick(all_types, pick), _pick(all_colors, pick)
        coin = _randint(generator, b, 0, 2) == 0
        kind = torch.where(t == DOOR_T,
                           torch.where(coin, I.GOTO, I.OPEN),
                           torch.where(coin, I.GOTO, I.PICKUP))
        return b, single(leaf(kind, desc(t, c))), _true(b)


class FindObjS5(RoomGridLevel):
    def __init__(self, room_size=5, max_steps=None, **kw):
        if max_steps is None:
            max_steps = 20 * room_size**2
        super().__init__(room_size=room_size, max_steps=max_steps, **kw)

    def gen_mission(self, generator, b):
        Lt = self.layout
        i = _randint(generator, b, 0, Lt.num_cols)
        j = _randint(generator, b, 0, Lt.num_rows)
        b, kind, _, _ = RG.add_object(b, Lt, generator, i, j)
        b = RG.place_agent(b, Lt, generator, 1, 1)
        b = RG.connect_all(b, Lt, generator)
        dtype, _, _ = desc_from_kind_color(kind, 0)
        return b, single(leaf(I.PICKUP, desc(dtype))), _true(b)


class KeyCorridor(RoomGridLevel):
    def __init__(self, num_rows=3, obj_type="ball", room_size=6,
                 max_steps=None, **kw):
        if max_steps is None:
            max_steps = 30 * room_size**2
        super().__init__(room_size=room_size, num_rows=num_rows,
                         max_steps=max_steps, **kw)
        self.obj_type = obj_type

    def gen_mission(self, generator, b):
        Lt = self.layout
        for j in range(1, Lt.num_rows):
            b = RG.remove_wall(b, Lt, 1, j, 3)
        room_j = _randint(generator, b, 0, Lt.num_rows)
        b, door_color, _ = RG.add_door(b, Lt, generator, 2, room_j, 2,
                                       locked=True)
        kind = {"key": 0, "ball": 1, "box": 2}[self.obj_type]
        b, *_ = RG.add_object(b, Lt, generator, 2, room_j, kind=kind)
        key_j = _randint(generator, b, 0, Lt.num_rows)
        b, *_ = RG.add_object(b, Lt, generator, 0, key_j, kind=0,
                              color=door_color)
        b = RG.place_agent(b, Lt, generator, 1, Lt.num_rows // 2)
        b = RG.connect_all(b, Lt, generator)
        t = {"key": KEY_T, "ball": BALL_T, "box": BOX_T}[self.obj_type]
        return b, single(leaf(I.PICKUP, desc(t))), _true(b)


class OneRoomS8(RoomGridLevel):
    def __init__(self, room_size=8, **kw):
        super().__init__(room_size=room_size, num_rows=1, num_cols=1, **kw)

    def gen_mission(self, generator, b):
        b, *_ = RG.add_object(b, self.layout, generator, 0, 0, kind=1)
        b = RG.place_agent(b, self.layout, generator, 0, 0)
        return b, single(leaf(I.PICKUP, desc(BALL_T))), _true(b)


# ---------------------------------------------------------------------------
# Synth (synth.py): LevelGen configurations
# ---------------------------------------------------------------------------

class Synth(LevelGen):
    def __init__(self, room_size=8, num_rows=3, num_cols=3, num_dists=18,
                 **kw):
        super().__init__(room_size=room_size, num_rows=num_rows,
                         num_cols=num_cols, num_dists=num_dists,
                         instr_kinds=["action"], locations=False,
                         unblocking=True, implicit_unlock=False, **kw)


class SynthLoc(LevelGen):
    def __init__(self, **kw):
        super().__init__(instr_kinds=["action"], locations=True,
                         unblocking=True, implicit_unlock=False, **kw)


class SynthSeq(LevelGen):
    def __init__(self, **kw):
        super().__init__(locations=True, unblocking=True,
                         implicit_unlock=False, **kw)


class MiniBossLevel(LevelGen):
    def __init__(self, **kw):
        super().__init__(num_cols=2, num_rows=2, room_size=5, num_dists=7,
                         locked_room_prob=0.25, **kw)


class BossLevel(LevelGen):
    def __init__(self, **kw):
        super().__init__(**kw)


class BossLevelNoUnlock(LevelGen):
    def __init__(self, **kw):
        super().__init__(locked_room_prob=0, implicit_unlock=False, **kw)
