"""BabyAI instruction language: array encoding, verifier, surface form.

Counterpart of ``minigrid_tpu/envs/babyai/core/instrs.py`` (reference
``minigrid/envs/babyai/core/verifier.py:16-568``), batch-leading. Object
identity reduces to position tracking: objects move only through the
agent's hands, one at a time, so each descriptor carries a position mask of
its tracked objects and a "the carried object is tracked" bit, updated on
pickup, drop and box toggles. An instruction is a fixed-capacity tree: a
root combinator over two parts, each a single action or an ``and`` of two,
so 4 leaf slots (the grammar of levelgen.py:158-211).

Position masks are x-bit-packed rows: ``(B, 8, H)`` int32 where bit ``x``
of ``[b, slot, y]`` marks cell (x, y). The JAX package packs them into
uint32; PyTorch has no shifts for uint32 on the CPU, so they are int32
here. Widths are at most 24 (:func:`pack_mask`), so bit 31 is never set
and ``>>`` stays a logical shift.

In ``EnvState.extra`` an :class:`InstrState` is a flat dict under dotted
keys (``instr.kinds``, ``instr.descs.mask_objs``, ...), so pools, selects
and gathers carry it with no BabyAI code: :meth:`InstrState.to_extra` and
:meth:`InstrState.from_extra`.
"""

from __future__ import annotations

import dataclasses

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core.actions import Actions
from minigrid_tpu_torch.core.mission import WORD_TO_ID
from minigrid_tpu_torch.core.types import MISSION_LEN

# Vocabulary index spaces (verifier.py:16-22)
OBJ_TYPES = ["box", "ball", "key", "door"]       # descriptor type order
TYPE_IDS = [C.BOX, C.BALL, C.KEY, C.DOOR]
TYPE_NONE = 4
COLOR_NONE = 6
LOC_NAMES = ["left", "right", "front", "behind"]
LOC_NONE = 4

# leaf kinds
OPEN, GOTO, PICKUP, PUTNEXT, UNUSED = 0, 1, 2, 3, 4
# root kinds
ROOT_ACTION, ROOT_AND, ROOT_BEFORE, ROOT_AFTER = 0, 1, 2, 3

CONTINUE, SUCCESS, FAILURE = 0, 1, 2

MAX_PACKED_WIDTH = 24  # the JAX package's cap (its f32 fresh-reset routing)
PREFIX = "instr."


def _select(conds, values, default):
    """``jnp.select``: the value of the first true condition."""
    out = default
    for c, v in zip(reversed(conds), reversed(values)):
        out = torch.where(c, v, out)
    return out


@dataclasses.dataclass(frozen=True)
class Descs:
    """8 descriptor slots per env (leaf i: slot 2i moves or is the
    primary, 2i+1 is fixed)."""

    type: torch.Tensor       # (B, 8) int32 in [0..4]
    color: torch.Tensor      # (B, 8) int32 in [0..6]
    loc: torch.Tensor        # (B, 8) int32 in [0..4]
    count: torch.Tensor      # (B, 8) int32 |obj_set| at reset
    mask_objs: torch.Tensor  # (B, 8, H) int32: tracked objects now on grid
    mask_poss: torch.Tensor  # (B, 8, H) int32: stale obj_poss
    carried: torch.Tensor    # (B, 8) bool: the carried object is tracked

    def replace(self, **kw) -> "Descs":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class InstrState:
    root_kind: torch.Tensor         # (B,) int32
    a_is_and: torch.Tensor          # (B,) bool
    b_is_and: torch.Tensor          # (B,) bool
    kinds: torch.Tensor             # (B, 4) int32 leaf kinds
    strict: torch.Tensor            # (B, 4) bool
    descs: Descs
    # the verifier's memory
    pre_empty: torch.Tensor         # (B, 4) bool: hands empty at last call
    pre_move_carried: torch.Tensor  # (B, 4) bool: carried in move set
    last_match: torch.Tensor        # (B, 4) bool: done-actions memo
    leaf_done: torch.Tensor         # (B, 4) bool
    a_done: torch.Tensor            # (B,) bool
    b_done: torch.Tensor            # (B,) bool

    def replace(self, **kw) -> "InstrState":
        return dataclasses.replace(self, **kw)

    def to_extra(self) -> dict:
        """The flat ``extra`` entries, ``instr.<field>`` and
        ``instr.descs.<field>``."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if f.name == "descs":
                for g in dataclasses.fields(v):
                    out[f"{PREFIX}descs.{g.name}"] = getattr(v, g.name)
            else:
                out[PREFIX + f.name] = v
        return out

    @classmethod
    def from_extra(cls, extra: dict) -> "InstrState":
        descs = Descs(**{g.name: extra[f"{PREFIX}descs.{g.name}"]
                         for g in dataclasses.fields(Descs)})
        return cls(descs=descs, **{
            f.name: extra[PREFIX + f.name] for f in dataclasses.fields(cls)
            if f.name != "descs"})


def pack_mask(mask: torch.Tensor) -> torch.Tensor:
    """``(..., W, H)`` bool -> ``(..., H)`` int32, bit ``x`` = column x."""
    W = mask.shape[-2]
    if W > MAX_PACKED_WIDTH:
        raise ValueError(f"packed masks need width <= {MAX_PACKED_WIDTH}, "
                         f"got {W}")
    bits = torch.ones(W, dtype=torch.int32, device=mask.device) << torch.arange(
        W, dtype=torch.int32, device=mask.device)
    return (mask.to(torch.int32) * bits[:, None]).sum(-2, dtype=torch.int32)


def unpack_mask(packed: torch.Tensor, width: int) -> torch.Tensor:
    """``(..., H)`` int32 -> ``(..., W, H)`` bool."""
    bits = torch.arange(width, dtype=torch.int32, device=packed.device)
    return ((packed[..., None, :] >> bits[:, None]) & 1).bool()


def empty_instr(num_envs: int, height: int, device=None) -> InstrState:
    def full(shape, v, dtype):
        return torch.full((num_envs,) + shape, v, dtype=dtype, device=device)

    i32, b8 = torch.int32, torch.bool
    return InstrState(
        root_kind=full((), 0, i32), a_is_and=full((), False, b8),
        b_is_and=full((), False, b8), kinds=full((4,), UNUSED, i32),
        strict=full((4,), False, b8),
        descs=Descs(type=full((8,), TYPE_NONE, i32),
                    color=full((8,), COLOR_NONE, i32),
                    loc=full((8,), LOC_NONE, i32), count=full((8,), 0, i32),
                    mask_objs=full((8, height), 0, i32),
                    mask_poss=full((8, height), 0, i32),
                    carried=full((8,), False, b8)),
        pre_empty=full((4,), False, b8), pre_move_carried=full((4,), False, b8),
        last_match=full((4,), False, b8), leaf_done=full((4,), False, b8),
        a_done=full((), False, b8), b_done=full((), False, b8))


def match_mask(grid, agent_pos, agent_dir, room_rect, dtype, color, loc):
    """find_matching_objs at reset (verifier.py:105-171): which cells match
    a (type, colour, location) descriptor. ``grid`` (B, W, H, 5),
    ``agent_pos`` (B, 2), ``agent_dir`` (B,), ``room_rect`` (B|1, W, H) the
    agent's room (location words apply there only); ``dtype``, ``color``,
    ``loc`` (B, *S). Returns (B, *S, W, H) bool."""
    S = dtype.shape[1:]
    lead = (-1,) + (1,) * len(S)

    def cellwise(x):                      # (B, W, H) -> (B, 1.., W, H)
        return x.reshape(lead + tuple(x.shape[-2:]))

    def per_desc(x):                      # (B, *S) -> (B, *S, 1, 1)
        return x[..., None, None].to(torch.int64)

    dev = grid.device
    cellt = cellwise(grid[..., 0].to(torch.int64))
    cellc = cellwise(grid[..., 1].to(torch.int64))
    dtype, color, loc = per_desc(dtype), per_desc(color), per_desc(loc)
    type_ids = torch.as_tensor(TYPE_IDS, device=dev)
    type_ok = (dtype == TYPE_NONE) | (cellt == type_ids[dtype.clamp(0, 3)])
    color_ok = (color == COLOR_NONE) | (cellc == color)
    W, H = grid.shape[1:3]
    xs = torch.arange(W, device=dev)[:, None]
    ys = torch.arange(H, device=dev)[None, :]
    ap = agent_pos.to(torch.int64)
    vx = cellwise(xs - ap[:, 0, None, None])
    vy = cellwise(ys - ap[:, 1, None, None])
    vec = torch.as_tensor(C.DIR_TO_VEC, device=dev).to(torch.int64)
    d1 = vec[agent_dir.to(torch.int64)]
    d1x = d1[:, 0].reshape(lead + (1, 1))
    d1y = d1[:, 1].reshape(lead + (1, 1))
    dot1 = vx * d1x + vy * d1y
    dot2 = vx * -d1y + vy * d1x
    loc_cond = _select([loc == 0, loc == 1, loc == 2, loc == 3],
                       [dot2 < 0, dot2 > 0, dot1 > 0, dot1 < 0],
                       torch.ones((), dtype=torch.bool, device=dev))
    loc_ok = (loc == LOC_NONE) | (cellwise(room_rect) & loc_cond)
    return (cellt != C.EMPTY) & type_ok & color_ok & loc_ok


def init_descs(grid, agent_pos, agent_dir, room_rect, dtype, color,
               loc) -> Descs:
    """All 8 descriptor slots from (B, 8) (type, colour, location) specs
    at reset (``init_desc_slot`` for every slot)."""
    mask = match_mask(grid, agent_pos, agent_dir, room_rect, dtype, color,
                      loc)                                   # (B, 8, W, H)
    packed = pack_mask(mask)
    return Descs(type=dtype.to(torch.int32), color=color.to(torch.int32),
                 loc=loc.to(torch.int32),
                 count=mask.sum((-2, -1), dtype=torch.int32),
                 mask_objs=packed, mask_poss=packed.clone(),
                 carried=torch.zeros(dtype.shape, dtype=torch.bool,
                                     device=grid.device))


def _front(state):
    d = state.agent_dir.to(torch.int64)
    fx = state.agent_pos[:, 0].to(torch.int64) + (d == 0).to(torch.int64) \
        - (d == 2).to(torch.int64)
    fy = state.agent_pos[:, 1].to(torch.int64) + (d == 1).to(torch.int64) \
        - (d == 3).to(torch.int64)
    return fx, fy


def front_mask_packed(params, state) -> torch.Tensor:
    """(B, H) int32: the packed one-hot of the cell in front of each agent
    (all zero when it is off the grid)."""
    fx, fy = _front(state)
    in_x = (fx >= 0) & (fx < params.width)
    bit = torch.where(in_x, torch.ones_like(fx) << fx.clamp(0, 30), 0)
    ys = torch.arange(params.height, device=fx.device)
    return torch.where(ys[None, :] == fy[:, None], bit[:, None], 0).to(
        torch.int32)


def front_type_state(params, state):
    """(type, door state) of the cell in front of each agent, 0 off the
    grid, (B,) int64."""
    fx, fy = _front(state)
    W, H = params.width, params.height
    inb = (fx >= 0) & (fx < W) & (fy >= 0) & (fy < H)
    bi = torch.arange(state.batch_size, device=fx.device)
    cell = state.grid[bi, fx.clamp(0, W - 1), fy.clamp(0, H - 1)].to(
        torch.int64)
    return (torch.where(inb, cell[:, 0], 0),
            torch.where(inb, cell[:, 2], 0))


def _any_bits(rows):
    """(B, n, H) int32 -> (B, n) bool: any bit set."""
    return (rows != 0).any(-1)


def update_tracking(params, descs: Descs, prev, new, action) -> Descs:
    """Identity and position tracking across one transition."""
    fmp = front_mask_packed(params, prev)[:, None]            # (B, 1, H)
    was_empty = prev.carrying[:, 0] == C.EMPTY
    now_empty = new.carrying[:, 0] == C.EMPTY
    picked = (action == Actions.pickup) & was_empty & ~now_empty
    dropped = (action == Actions.drop) & ~was_empty & now_empty
    ftype, _ = front_type_state(params, prev)
    box_gone = (action == Actions.toggle) & (ftype == C.BOX)

    at_front = _any_bits(descs.mask_objs & fmp)               # (B, 8)
    take = picked[:, None] & at_front
    lose_box = box_gone[:, None] & at_front
    gain = dropped[:, None] & descs.carried
    front_in = (at_front & ~take & ~lose_box) | gain
    mask_objs = torch.where(front_in[..., None], descs.mask_objs | fmp,
                            descs.mask_objs & ~fmp)
    carried = torch.where(take, True, torch.where(gain, False, descs.carried))
    # obj_poss refreshes on every drop action (roomgrid_level.py:91-93)
    mask_poss = torch.where((action == Actions.drop)[:, None, None],
                            mask_objs, descs.mask_poss)
    return descs.replace(mask_objs=mask_objs, mask_poss=mask_poss,
                         carried=carried)


def neighborhood(rows: torch.Tensor) -> torch.Tensor:
    """The 4-neighbourhood of packed rows (..., H): x +- 1 are bit
    shifts, y +- 1 are row shifts."""
    z = torch.zeros_like(rows[..., :1])
    return ((rows << 1) | (rows >> 1)
            | torch.cat([rows[..., 1:], z], -1)
            | torch.cat([z, rows[..., :-1]], -1))


def leaf_commons(params, prev, new):
    """The leaf-independent quantities of one verify call."""
    fmp = front_mask_packed(params, new)
    ftype, fstate = front_type_state(params, new)
    return (fmp, ftype, fstate, new.carrying[:, 0] != C.EMPTY,
            prev.carrying[:, 0] == C.EMPTY, new.carrying[:, 0] == C.EMPTY,
            neighborhood(fmp))


def leaf_verify_all(instr: InstrState, gates, action, use_done_actions: bool,
                    commons):
    """Result and memory updates of all four leaf slots at once, each
    applied only under its ``gates`` (B, 4) entry: the per-slot semantics
    of the reference verifier (verifier.py:254-433)."""
    fmp, ftype, fstate, now_carrying, was_empty, now_empty, neigh = commons
    a = action[:, None]
    kinds, strict, d = instr.kinds, instr.strict, instr.descs
    fmp, neigh = fmp[:, None], neigh[:, None]
    mo = d.mask_objs[:, 0::2]            # (B, 4, H) move descriptors
    mp = d.mask_poss[:, 0::2]
    fx = d.mask_poss[:, 1::2]            # fixed descriptors (putnext)
    carried_mv = d.carried[:, 0::2]      # (B, 4)

    # open (verifier.py:254-288)
    front_is_door = (ftype == C.DOOR)[:, None]
    toggle = a == Actions.toggle
    open_success = (toggle & _any_bits(mo & fmp) & front_is_door
                    & (fstate == C.OPEN)[:, None])
    open_fail = toggle & strict & front_is_door & ~open_success
    # goto (verifier.py:290-317): the stale obj_poss
    goto_success = _any_bits(mp & fmp)
    # pickup (verifier.py:319-362)
    pk = a == Actions.pickup
    now_c = now_carrying[:, None]
    pickup_success = pk & instr.pre_empty & carried_mv & now_c
    pickup_fail = pk & strict & now_c & ~pickup_success
    # putnext (verifier.py:365-433)
    drop_ok = ((a == Actions.drop) & ~was_empty[:, None]
               & now_empty[:, None])
    put_success = drop_ok & instr.pre_move_carried & _any_bits(fx & neigh)
    put_fail = pk & strict & now_c

    no = torch.zeros_like(open_success)
    conds = [kinds == OPEN, kinds == GOTO, kinds == PICKUP, kinds == PUTNEXT]
    success = _select(conds, [open_success, goto_success, pickup_success,
                              put_success], no)
    fail = _select(conds, [open_fail, no, pickup_fail,
                           put_fail & ~put_success], no)

    if use_done_actions:
        # verify() in done-actions mode (verifier.py:228-242): 'done'
        # reports the memo; other actions continue while updating it
        is_done_a = a == Actions.done
        reported_success = is_done_a & instr.last_match
        reported_fail = is_done_a & ~instr.last_match
        instr = instr.replace(last_match=torch.where(
            gates & ~is_done_a, success, instr.last_match))
        success, fail = reported_success, reported_fail

    success = success & gates
    fail = fail & gates
    # the memory updates whenever a leaf is invoked (verify_action entry)
    verify_runs = gates if not use_done_actions else (
        gates & (a != Actions.done))
    upd_pre = verify_runs & ((kinds == PICKUP) | (kinds == PUTNEXT))
    instr = instr.replace(
        pre_empty=torch.where(upd_pre, ~now_c, instr.pre_empty),
        pre_move_carried=torch.where(upd_pre, carried_mv,
                                     instr.pre_move_carried),
        leaf_done=instr.leaf_done | success)
    return instr, success, fail


def _parts_done(instr: InstrState):
    ld = instr.leaf_done
    a_part = ld[:, 0] & (~instr.a_is_and | ld[:, 1])
    b_part = ld[:, 2] & (~instr.b_is_and | ld[:, 3])
    return instr.a_done | a_part, instr.b_done | b_part


def verify(params, instr: InstrState, prev, new, action,
           use_done_actions: bool = False):
    """One verifier step after the transition ``prev`` -> ``new``
    (roomgrid_level.py:87-104). Returns (status (B,) int32 in
    {CONTINUE, SUCCESS, FAILURE}, the new InstrState)."""
    action = torch.as_tensor(action, device=prev.device).to(torch.int64)
    instr = instr.replace(descs=update_tracking(params, instr.descs, prev,
                                                new, action))
    commons = leaf_commons(params, prev, new)
    rk = instr.root_kind
    is_before, is_after = rk == ROOT_BEFORE, rk == ROOT_AFTER
    ld = instr.leaf_done

    # phase 1: the part that runs first (A, or B for "after")
    gA1 = _select([rk == ROOT_ACTION, rk == ROOT_AND, is_before],
                  [~ld[:, 0], ~ld[:, 0], ~instr.a_done & ~ld[:, 0]],
                  torch.zeros_like(is_before))
    gA2 = _select([rk == ROOT_AND, is_before],
                  [~ld[:, 1], ~instr.a_done & instr.a_is_and & ~ld[:, 1]],
                  torch.zeros_like(is_before))
    gB1 = is_after & ~instr.b_done & ~ld[:, 2]
    gB2 = is_after & ~instr.b_done & instr.b_is_and & ~ld[:, 3]
    instr, _, f1 = leaf_verify_all(instr, torch.stack([gA1, gA2, gB1, gB2],
                                                      -1),
                                   action, use_done_actions, commons)
    fails = f1.any(-1)
    a_done, b_done = _parts_done(instr)

    # phase 2: the other part, gated on phase 1's completion
    ld = instr.leaf_done
    gB1 = is_before & a_done & ~ld[:, 2]
    gB2 = is_before & a_done & instr.b_is_and & ~ld[:, 3]
    gA1 = is_after & b_done & ~ld[:, 0]
    gA2 = is_after & b_done & instr.a_is_and & ~ld[:, 1]
    instr, _, f2 = leaf_verify_all(instr, torch.stack([gA1, gA2, gB1, gB2],
                                                      -1),
                                   action, use_done_actions, commons)
    fails = fails | f2.any(-1)
    a_done, b_done = _parts_done(instr)
    instr = instr.replace(a_done=a_done, b_done=b_done)

    ld = instr.leaf_done
    success = _select([rk == ROOT_ACTION, rk == ROOT_AND, is_before | is_after],
                      [ld[:, 0], ld[:, 0] & ld[:, 1], a_done & b_done],
                      torch.zeros_like(a_done))
    # AndInstr swallows child failures outside done-actions mode
    # (verifier.py:533-568); action and sequence roots propagate them
    fail_counts = (rk != ROOT_AND) | use_done_actions
    status = torch.where(success, SUCCESS,
                         torch.where(fails & fail_counts, FAILURE, CONTINUE))
    return status.to(torch.int32), instr


def num_navs_needed(instr: InstrState) -> torch.Tensor:
    """(B,) int32: the dynamic step-budget factor
    (roomgrid_level.py:216-236)."""
    k = instr.kinds
    per_leaf = torch.where(k == PUTNEXT, 2, torch.where(k == UNUSED, 0, 1))
    rk = instr.root_kind[:, None]
    slot = torch.arange(4, device=k.device)[None]
    one = torch.ones_like(instr.a_is_and)
    seq = torch.stack([one, instr.a_is_and, one, instr.b_is_and], -1)
    active = _select([rk == ROOT_ACTION, rk == ROOT_AND],
                     [slot < 1, slot < 2], seq)
    return (per_leaf * active).sum(-1, dtype=torch.int32)


# ---------------------------------------------------------------------------
# Surface form as mission tokens (verifier.py surface methods)
# ---------------------------------------------------------------------------

_W = WORD_TO_ID
TYPE_WORDS = [_W["box"], _W["ball"], _W["key"], _W["door"], _W["object"]]
COLOR_WORDS = [_W[C.IDX_TO_COLOR[i]] for i in range(6)] + [0]
LOC_SEGMENTS = [
    [_W["on"], _W["your"], _W["left"], 0],
    [_W["on"], _W["your"], _W["right"], 0],
    [_W["in"], _W["front"], _W["of"], _W["you"]],
    [_W["behind"], _W["you"], 0, 0],
    [0, 0, 0, 0],
]
VERBS = [[_W["open"], 0], [_W["go"], _W["to"]], [_W["pick"], _W["up"]],
         [_W["put"], 0], [0, 0]]          # by leaf kind, UNUSED last


def _desc_tokens(d: Descs, slot: int):
    """(B, 7) tokens for one descriptor (verifier.py:73-103)."""
    dev = d.type.device
    t = lambda table: torch.as_tensor(table, device=dev)
    article = torch.where(d.count[:, slot] > 1, _W["a"], _W["the"])
    return torch.cat([
        torch.stack([article, t(COLOR_WORDS)[d.color[:, slot].long()],
                     t(TYPE_WORDS)[d.type[:, slot].long()]], -1),
        t(LOC_SEGMENTS)[d.loc[:, slot].long()]], -1)


def _leaf_tokens(instr: InstrState, i: int):
    """(B, 18) tokens and validity of one leaf."""
    dev = instr.kinds.device
    kind = instr.kinds[:, i]
    verb = torch.as_tensor(VERBS, device=dev)[kind.long().clamp(0, 4)]
    mt = _desc_tokens(instr.descs, 2 * i)
    ft = _desc_tokens(instr.descs, 2 * i + 1)
    is_put = (kind == PUTNEXT)[:, None]
    mid = torch.where(is_put, torch.as_tensor([_W["next"], _W["to"]],
                                              device=dev), 0)
    toks = torch.cat([verb, mt, mid, torch.where(is_put, ft, 0)], -1)
    valid = torch.cat([verb != 0, mt != 0, mid != 0, (ft != 0) & is_put], -1)
    return toks, valid & (kind != UNUSED)[:, None]


def surface_tokens(instr: InstrState) -> torch.Tensor:
    """(B, MISSION_LEN) int32 mission ids of the instruction trees."""
    rk = instr.root_kind
    B, dev = rk.shape[0], rk.device
    t0, v0 = _leaf_tokens(instr, 0)
    t1, v1 = _leaf_tokens(instr, 1)
    t2, v2 = _leaf_tokens(instr, 2)
    t3, v3 = _leaf_tokens(instr, 3)
    seq = (rk == ROOT_BEFORE) | (rk == ROOT_AFTER)
    use_a2 = ((rk == ROOT_AND) | (seq & instr.a_is_and))[:, None]
    use_b = seq[:, None]
    use_b2 = use_b & instr.b_is_and[:, None]
    conn = torch.where((rk == ROOT_BEFORE)[:, None],
                       torch.as_tensor([_W[","], _W["then"]], device=dev),
                       torch.as_tensor([_W["after"], _W["you"]], device=dev))
    and_tok = torch.full((B, 1), _W["and"], dtype=t0.dtype, device=dev)
    toks = torch.cat([t0, and_tok, t1, conn, t2, and_tok, t3], -1)
    valid = torch.cat([v0, use_a2, v1 & use_a2, use_b, use_b, v2 & use_b,
                       use_b2, v3 & use_b2], -1)
    # compact the valid tokens to the front; the rest scatter into a
    # column that is dropped
    pos = torch.cumsum(valid, -1) - 1
    out = torch.zeros((B, MISSION_LEN + 1), dtype=torch.int32, device=dev)
    out.scatter_(1, torch.where(valid, pos, MISSION_LEN).long(),
                 toks.to(torch.int32))
    return out[:, :MISSION_LEN].contiguous()
