"""Combinatorial BabyAI mission generator (reference
minigrid/envs/babyai/core/levelgen.py:25-211).

Counterpart of ``minigrid_tpu/envs/babyai/core/levelgen.py``, batched. Its
bounded retry loops draw several tries per env at once and take the first
that succeeds: the same choice as one try per iteration."""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import roomgrid as RG
from minigrid_tpu_torch.envs.babyai.core import instrs as I
from minigrid_tpu_torch.envs.babyai.core import level as L
from minigrid_tpu_torch.utils import trace

ALL_TYPES = (0, 1, 2, 3)       # box, ball, key, door (I.OBJ_TYPES order)
NOT_DOOR = (0, 1, 2)
DOOR_ONLY = (3,)
LOCKED_ROOM_TRIES = 100
RAND_OBJ_TRIES = 100            # retries after the first draw
TRIES_PER_ROUND = 8             # rand_obj draws per env per host sync


def _first_true(ok: torch.Tensor):
    """(found (B,), index of the first True of each row, 0 if none)."""
    return ok.any(-1), ok.to(torch.int8).argmax(-1)


def add_locked_room(b: RG.Builder, layout: RG.RoomLayout, generator):
    """Lock one random interior door and hide its key in another room
    (levelgen.py:86-113): tries of a uniform room and wall until the wall
    has a neighbour, at most 100. Returns (builder, locked room (i, j))."""
    B, dev = b.batch_size, b.device
    n = LOCKED_ROOM_TRIES
    i = RG.randint(generator, 0, layout.num_cols, B * n, dev).reshape(B, n)
    j = RG.randint(generator, 0, layout.num_rows, B * n, dev).reshape(B, n)
    d = RG.randint(generator, 0, 4, B * n, dev).reshape(B, n)
    placed, first = _first_true(RG.has_neighbor(layout, i, j, d))
    bi = torch.arange(B, device=dev)
    li = torch.where(placed, i[bi, first], 0)
    lj = torch.where(placed, j[bi, first], 0)
    nb, door_color, _ = RG.add_door(b, layout, generator, li, lj,
                                    d[bi, first], locked=True)
    b = nb.where(placed, b)
    # the key in any other room (levelgen.py:102-112); with no door placed
    # the colour is that of cell (0, 0), as the JAX package reads it
    door_color = torch.where(placed, door_color, b.grid[:, 0, 0, 1])
    ki, kj = L.sample_room(generator, layout, B, dev, exclude=(li, lj))
    b, *_ = RG.add_object(b, layout, generator, ki, kj, kind=0,
                          color=door_color)
    return b, (li, lj)


def rand_obj(b: RG.Builder, layout: RG.RoomLayout, generator,
             types=ALL_TYPES, locations=True, implicit_unlock=True,
             locked_rect=None):
    """A random descriptor that matches at least one object
    (levelgen.py:115-156): a first draw and up to 100 more until one
    matches (outside the locked room when ``implicit_unlock`` is off); an
    env with no match keeps its first draw. Returns ((type, colour, loc)
    (B,) int32 each, ok (B,))."""
    B, dev = b.batch_size, b.device
    ri, rj = layout.room_from_pos(b.agent_pos)
    room_rect = layout.room_rect_mask(ri, rj, dev)
    type_table = torch.as_tensor(types, device=dev)
    sorted_colors = torch.as_tensor(RG.SORTED_COLORS, device=dev)

    def draw(n, k):
        # colour: _rand_elem([None, *colors]), 7 options (levelgen.py:130)
        c = RG.randint(generator, 0, 7, n * k, dev).reshape(n, k)
        color = torch.where(c == 0, I.COLOR_NONE,
                            sorted_colors[(c - 1).clamp(0, 5)])
        t = type_table[RG.randint(generator, 0, len(types), n * k,
                                  dev).reshape(n, k)]
        if locations:
            use_loc = RG.randint(generator, 0, 2, n * k, dev).reshape(n, k)
            loc = torch.where(use_loc == 0, RG.randint(
                generator, 0, 4, n * k, dev).reshape(n, k), I.LOC_NONE)
        else:
            loc = torch.full((n, k), I.LOC_NONE, dtype=torch.int64,
                             device=dev)
        return t, color, loc

    def matches(rows, t, color, loc):
        mask = I.match_mask(b.grid[rows], b.agent_pos[rows],
                            b.agent_dir[rows], room_rect.expand(
                                B, -1, -1)[rows], t, color, loc)
        ok = mask.flatten(-2).any(-1)
        if not implicit_unlock and locked_rect is not None:
            ok &= (mask & ~locked_rect[rows][:, None]).flatten(-2).any(-1)
        return ok

    everyone = torch.arange(B, device=dev)
    vals = [v[:, 0] for v in draw(B, 1)]
    ok = matches(everyone, *(v[:, None] for v in vals))[:, 0]
    tries = 0
    while tries < RAND_OBJ_TRIES:
        RG.COUNTERS.host_syncs += 1
        todo = torch.nonzero(~ok)[:, 0]
        if todo.numel() == 0:
            break
        k = min(TRIES_PER_ROUND, RAND_OBJ_TRIES - tries)
        t, color, loc = draw(todo.numel(), k)
        found, first = _first_true(matches(todo, t, color, loc))
        bi = torch.arange(todo.numel(), device=dev)
        for n, new in enumerate((t, color, loc)):
            vals[n] = vals[n].index_copy(0, todo, torch.where(
                found, new[bi, first], vals[n][todo]))
        ok = ok.index_copy(0, todo, found)
        tries += k
    return tuple(v.to(torch.int32) for v in vals), ok


class LevelGen(L.RoomGridLevel):
    """Every-possible-sentence generator (levelgen.py:25-211)."""

    def __init__(self, room_size=8, num_rows=3, num_cols=3, num_dists=18,
                 locked_room_prob=0.5, locations=True, unblocking=True,
                 implicit_unlock=True,
                 action_kinds=("goto", "pickup", "open", "putnext"),
                 instr_kinds=("action", "and", "seq"), **kw):
        super().__init__(room_size=room_size, num_rows=num_rows,
                         num_cols=num_cols, **kw)
        self.num_dists = num_dists
        self.locked_room_prob = locked_room_prob
        self.locations = locations
        self.unblocking = unblocking
        self.implicit_unlock = implicit_unlock
        self.action_kinds = action_kinds
        self.instr_kinds = instr_kinds

    def _rand_action_leaf(self, b, generator, ok, locked_rect):
        """One random action instruction (levelgen.py:160-177)."""
        B, dev = b.batch_size, b.device
        kind_map = {"goto": I.GOTO, "pickup": I.PICKUP, "open": I.OPEN,
                    "putnext": I.PUTNEXT}
        kinds = torch.as_tensor([kind_map[k] for k in self.action_kinds],
                                device=dev)
        kind = kinds[RG.randint(generator, 0, len(self.action_kinds), B, dev)]

        def obj(types):
            nonlocal ok
            d, o = rand_obj(b, self.layout, generator, types=types,
                            locations=self.locations,
                            implicit_unlock=self.implicit_unlock,
                            locked_rect=locked_rect)
            ok = ok & o
            return d

        d_all, d_nd = obj(ALL_TYPES), obj(NOT_DOOR)
        d_door, d_fixed = obj(DOOR_ONLY), obj(ALL_TYPES)
        d_move = tuple(
            torch.where(kind == I.GOTO, d_all[n],
                        torch.where(kind == I.OPEN, d_door[n], d_nd[n]))
            for n in range(3))
        is_put = kind == I.PUTNEXT
        fixed = tuple(torch.where(is_put, d_fixed[n], L.NONE_DESC[n])
                      for n in range(3))
        return L.leaf(kind, d_move, fixed), ok

    def gen_mission(self, generator, b):
        """The layout (span ``gen.layout``), the reachability check where
        unblocking is off (``gen.validate``) and the instruction's leaves
        and tree (``gen.instr``)."""
        with trace.span("gen.layout"):
            b, locked_rect = self._layout(generator, b)
        ok = torch.ones(b.batch_size, dtype=torch.bool, device=b.device)
        if not self.unblocking:
            ok &= L.check_objs_reachable(b)
        with trace.span("gen.instr"):
            spec, ok = self._instr_spec(generator, b, ok, locked_rect)
        return b, spec, ok

    def _layout(self, generator, b):
        """The locked room, the doors, the distractors and the agent
        (levelgen.py:60-75): (builder, the locked room's (B, W, H) mask,
        empty where none)."""
        Lt, B, dev = self.layout, b.batch_size, b.device
        no_room = torch.full((B,), -1, dtype=torch.int64, device=dev)

        # an optional locked room (levelgen.py:60-61)
        li = lj = no_room
        locked_rect = torch.zeros((B, Lt.width, Lt.height), dtype=torch.bool,
                                  device=dev)
        if self.locked_room_prob > 0:
            use_locked = torch.rand(B, generator=generator,
                                    device=dev) < self.locked_room_prob
            nb, (ni, nj) = add_locked_room(b, Lt, generator)
            b = nb.where(use_locked, b)
            li = torch.where(use_locked, ni, -1)
            lj = torch.where(use_locked, nj, -1)
            locked_rect = Lt.room_rect_mask(li.clamp(min=0), lj.clamp(min=0),
                                            dev) & use_locked[:, None, None]

        b = RG.connect_all(b, Lt, generator)
        b, *_ = RG.add_distractors(b, Lt, generator,
                                   num_distractors=self.num_dists,
                                   all_unique=False)
        # the agent outside the locked room (levelgen.py:67-75)
        rooms = torch.arange(Lt.num_rows * Lt.num_cols, device=dev)
        valid = (rooms != (lj * Lt.num_cols + li)[:, None]) | (li < 0)[:, None]
        flat = RG.categorical(generator, valid)
        b = RG.place_agent(b, Lt, generator, flat % Lt.num_cols,
                           flat // Lt.num_cols)
        return b, locked_rect

    def _instr_spec(self, generator, b, ok, locked_rect):
        """The instruction's structure (levelgen.py:158-211): (spec, ok)."""
        B, dev = b.batch_size, b.device
        names = list(self.instr_kinds)
        ik = RG.randint(generator, 0, len(names), B, dev)
        is_action = torch.as_tensor([n == "action" for n in names],
                                    device=dev)[ik]
        is_and = torch.as_tensor([n == "and" for n in names], device=dev)[ik]
        lv = []
        for _ in range(4):
            lf, ok = self._rand_action_leaf(b, generator, ok, locked_rect)
            lv.append(lf)
        # sequence parts: an action or an and (levelgen.py:181-196)
        a_and, b_and, before = (RG.randint(generator, 0, 2, B, dev) == 0
                                for _ in range(3))
        root = torch.where(is_action, I.ROOT_ACTION, torch.where(
            is_and, I.ROOT_AND,
            torch.where(before, I.ROOT_BEFORE, I.ROOT_AFTER)))
        a_is_and = ~is_action & (is_and | a_and)
        b_is_and = ~is_action & ~is_and & b_and

        def gate(lf, active):
            return {**lf, "kind": torch.where(active, lf["kind"], I.UNUSED)}

        spec = {"root": root, "a_and": a_is_and, "b_and": b_is_and,
                "leaves": [lv[0], gate(lv[1], a_is_and),
                           gate(lv[2], ~is_action & ~is_and),
                           gate(lv[3], b_is_and)]}
        return spec, ok
