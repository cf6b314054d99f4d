"""BabyAI level base: the mission generation loop, validation and the
dynamic step budget.

Counterpart of ``minigrid_tpu/envs/babyai/core/level.py`` (reference
``minigrid/envs/babyai/core/roomgrid_level.py:19-302``), batched. The
{generate, validate, retry} loop runs whole-level attempts over the envs
whose level is not valid yet, at most ``max_gen_attempts`` retries after
the first (one host sync each); an env still invalid after them keeps its
last level, as the JAX package does. ``validate_instrs`` (:146-199) and
``check_objs_reachable`` (:250-302) are batched predicates; the episode's
budget ``num_navs * room_size^2 * rows * cols`` (:71-85) lives in
``state.extra["max_steps"]``.

The level's step is a ``_post_step`` hook around the fused step (the JAX
package overrides ``step_state``): the verifier against the previous state,
the success reward ``1 - 0.9 * t / max_steps``, no reward on failure, the
episode ends when the verifier says so, and truncation at the dynamic
budget; on the card one launch of the BabyAI post-step kernel
(``post_step.py``).
"""

from __future__ import annotations

import os

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import roomgrid as RG
from minigrid_tpu_torch.envs.babyai.core import instrs as I
from minigrid_tpu_torch.envs.babyai.core.post_step import babyai_post_step
from minigrid_tpu_torch.envs.roomgrid_base import RoomGridEnv
from minigrid_tpu_torch.utils import trace

# BABYAI_DONE_ACTIONS switches to explicit-done verification
# (verifier.py:24-26), read at import as the reference and the JAX package
# read it
USE_DONE_ACTIONS = bool(os.environ.get("BABYAI_DONE_ACTIONS", False))
FLOOD_CHECK_EVERY = 16  # flood steps between convergence checks


# ---------------------------------------------------------------------------
# Instruction specs: dicts of ints or (B,) tensors
# ---------------------------------------------------------------------------

def desc(type_idx, color=I.COLOR_NONE, loc=I.LOC_NONE):
    """A descriptor spec; ``type_idx`` indexes I.OBJ_TYPES, 4 = none."""
    return (type_idx, color, loc)


NONE_DESC = (I.TYPE_NONE, I.COLOR_NONE, I.LOC_NONE)


def desc_from_kind_color(kind, color):
    """The descriptor of an ``add_object``/distractor (kind, colour); kind
    indexes roomgrid.KIND_IDS [key, ball, box]."""
    kind = torch.as_tensor(kind)
    return desc(torch.where(kind == 0, 2, torch.where(kind == 1, 1, 0)),
                color)


def leaf(kind, d_move, d_fixed=None, strict=False):
    return {"kind": kind, "strict": strict, "move": d_move,
            "fixed": NONE_DESC if d_fixed is None else d_fixed}


UNUSED_LEAF = leaf(I.UNUSED, NONE_DESC)


def single(l0):
    return {"root": I.ROOT_ACTION, "a_and": False, "b_and": False,
            "leaves": [l0, UNUSED_LEAF, UNUSED_LEAF, UNUSED_LEAF]}


def and_instr(l0, l1):
    return {"root": I.ROOT_AND, "a_and": True, "b_and": False,
            "leaves": [l0, l1, UNUSED_LEAF, UNUSED_LEAF]}


def seq_instr(root_kind, part_a, part_b):
    """``part_a``/``part_b`` are lists of 1 or 2 leaves."""
    a = list(part_a) + [UNUSED_LEAF] * (2 - len(part_a))
    b = list(part_b) + [UNUSED_LEAF] * (2 - len(part_b))
    return {"root": root_kind, "a_and": len(part_a) == 2,
            "b_and": len(part_b) == 2, "leaves": a + b}


def before_instr(part_a, part_b):
    return seq_instr(I.ROOT_BEFORE, part_a, part_b)


def after_instr(part_a, part_b):
    return seq_instr(I.ROOT_AFTER, part_a, part_b)


# ---------------------------------------------------------------------------
# Builder helpers of BabyAI
# ---------------------------------------------------------------------------

@trace.spanned("gen.validate")
def check_objs_reachable(b: RG.Builder) -> torch.Tensor:
    """(B,) bool: every object reachable from the agent without moving
    another (roomgrid_level.py:250-302). A flood through empty cells and
    doors, run to its fixed point (checked every
    :data:`FLOOD_CHECK_EVERY` steps)."""
    t = b.grid[..., 0]
    passable = (t == C.EMPTY) | (t == C.DOOR)
    B, W, H = t.shape
    xs = torch.arange(W, device=b.device)[None, :, None]
    ys = torch.arange(H, device=b.device)[None, None, :]
    ap = b.agent_pos.to(torch.int64)
    reach = (xs == ap[:, 0, None, None]) & (ys == ap[:, 1, None, None])
    for n in range(W * H):
        if n % FLOOD_CHECK_EVERY == 0:
            if n:
                RG.COUNTERS.host_syncs += 1
                if torch.equal(reach, last):
                    break
            last = reach
        exp = reach & passable
        z_row = torch.zeros_like(exp[:, :1])
        z_col = torch.zeros_like(exp[:, :, :1])
        reach = (reach | torch.cat([z_row, exp[:, :-1]], 1)
                 | torch.cat([exp[:, 1:], z_row], 1)
                 | torch.cat([z_col, exp[:, :, :-1]], 2)
                 | torch.cat([exp[:, :, 1:], z_col], 2))
    must_reach = (t != C.EMPTY) & (t != C.WALL)
    return ~(must_reach & ~reach).flatten(1).any(-1)


def open_all_doors(b: RG.Builder) -> RG.Builder:
    """Every door open (roomgrid_level.py:238-248)."""
    grid = b.grid.clone()
    grid[..., 2] = torch.where(grid[..., 0] == C.DOOR, 0, grid[..., 2])
    return b.replace(grid=grid)


def locked_door_colors(b: RG.Builder) -> torch.Tensor:
    """(B, 6) bool: the colours of the locked doors in each grid."""
    locked = (b.grid[..., 0] == C.DOOR) & (b.grid[..., 2] == C.LOCKED)
    colors = b.grid[..., 1].to(torch.int64)
    hit = (colors[..., None] == torch.arange(6, device=b.device)) \
        & locked[..., None]
    return hit.flatten(1, 2).any(1)


def sample_room(generator, layout: RG.RoomLayout, num_envs: int, device,
                exclude=None):
    """A uniform room (i, j) per env, (B,) int64 each, optionally not the
    room ``exclude`` = (i, j)."""
    R, Cc = layout.num_rows, layout.num_cols
    valid = torch.ones((num_envs, R * Cc), dtype=torch.bool, device=device)
    if exclude is not None:
        ei, ej = (RG.per_env(v, num_envs, device) for v in exclude)
        valid &= torch.arange(R * Cc, device=device) != (ej * Cc + ei)[:, None]
    flat = RG.categorical(generator, valid)
    return flat % Cc, flat // Cc


# ---------------------------------------------------------------------------
# The level base class
# ---------------------------------------------------------------------------

class RoomGridLevel(RoomGridEnv):
    """A BabyAI level: a RoomGrid layout, an instruction, its verifier."""

    unblocking: bool = False
    max_gen_attempts: int = 64

    def __init__(self, room_size=8, num_rows=3, num_cols=3, max_steps=None,
                 **kw):
        self.fixed_max_steps = max_steps is not None
        super().__init__(room_size=room_size, num_rows=num_rows,
                         num_cols=num_cols,
                         max_steps=max_steps if max_steps else (1 << 30),
                         **kw)

    def default_mission(self) -> str:
        return "go"

    def mission_space(self):
        """Catch-all (reference BabyAIMissionSpace,
        roomgrid_level.py:27-43): instructions come from the combinatorial
        grammar, not enumerable placeholders."""
        from minigrid_tpu_torch.core.mission_space import BabyAIMissionSpace

        return BabyAIMissionSpace()

    # Subclasses: (builder, spec, ok) = gen_mission(generator, builder)
    def gen_mission(self, generator, b: RG.Builder):
        raise NotImplementedError

    def _finalize_state(self, state, spec):
        """Post-generation adjustment (PutNext's start_carrying,
        putnext.py:193-202)."""
        return state

    def _instr_from_spec(self, spec, b: RG.Builder) -> I.InstrState:
        B, dev = b.batch_size, b.device

        def t(v, dtype=torch.int32):
            return RG.per_env(v, B, dev, dtype)

        leaves = spec["leaves"]
        slots = [d for lf in leaves for d in (lf["move"], lf["fixed"])]
        dtype, color, loc = (torch.stack([t(d[n]) for d in slots], -1)
                             for n in range(3))
        ri, rj = self.layout.room_from_pos(b.agent_pos)
        room_rect = self.layout.room_rect_mask(ri, rj, dev)
        instr = I.empty_instr(B, self.params.height, dev)
        return instr.replace(
            root_kind=t(spec["root"]), a_is_and=t(spec["a_and"], torch.bool),
            b_is_and=t(spec["b_and"], torch.bool),
            kinds=torch.stack([t(lf["kind"]) for lf in leaves], -1),
            strict=torch.stack([t(lf["strict"], torch.bool)
                                for lf in leaves], -1),
            descs=I.init_descs(b.grid, b.agent_pos, b.agent_dir, room_rect,
                               dtype, color, loc))

    def _validate(self, b: RG.Builder, instr: I.InstrState) -> torch.Tensor:
        """validate_instrs (roomgrid_level.py:146-199), (B,) bool."""
        ok = torch.ones(b.batch_size, dtype=torch.bool, device=b.device)
        locked_colors = locked_door_colors(b)
        d = instr.descs
        for i in range(4):
            active = instr.kinds[:, i] != I.UNUSED
            is_put = instr.kinds[:, i] == I.PUTNEXT
            move, fixed = d.mask_objs[:, 2 * i], d.mask_objs[:, 2 * i + 1]
            overlap = ((move & fixed) != 0).any(-1)
            # objects already next to each other
            touching = ((move & I.neighborhood(fixed)) != 0).any(-1)
            ok &= ~(active & is_put & (overlap | touching))
            if self.unblocking:
                for slot in (2 * i, 2 * i + 1):
                    d_color = d.color[:, slot].to(torch.int64)
                    color_locked = torch.where(
                        d_color == I.COLOR_NONE, locked_colors.any(-1),
                        locked_colors.gather(1, d_color.clamp(0, 5)[:, None])
                        [:, 0])
                    bad = active & (d.type[:, slot] == 2) & color_locked
                    if slot == 2 * i + 1:
                        bad &= is_put  # a fixed descriptor only for putnext
                    ok &= ~bad
        return ok

    def _max_steps_value(self, instr: I.InstrState) -> torch.Tensor:
        if self.fixed_max_steps:
            return torch.full_like(instr.root_kind, self.params.max_steps)
        L = self.layout
        nav_time_maze = L.room_size**2 * L.num_rows * L.num_cols
        return I.num_navs_needed(instr) * nav_time_maze

    def _attempt(self, generator, num_envs: int):
        """One generation attempt for every env: (states, ok). Spans: the
        builder under ``gen.layout``; the descriptors' matches, the budgets
        and the surface tokens under ``gen.instr``; the validation under
        ``gen.validate`` (a level's ``gen_mission`` opens its own)."""
        with trace.span("gen.layout"):
            b = self.builder(generator, num_envs)
        b, spec, gen_ok = self.gen_mission(generator, b)
        with trace.span("gen.instr"):
            instr = self._instr_from_spec(spec, b)
            extra = {**instr.to_extra(),
                     "max_steps": self._max_steps_value(instr)}
            mission = I.surface_tokens(instr)
        with trace.span("gen.validate"):
            ok = RG.per_env(gen_ok, num_envs, self.device, torch.bool) \
                & self._validate(b, instr)
        state = self.finish(generator, b, mission=mission, extra=extra)
        return self._finalize_state(state, spec), ok

    def generate(self, generator, num_envs: int):
        """(states, ok, attempts): the levels, whether each is valid, and
        the attempts each took (at most ``1 + max_gen_attempts``)."""
        state, ok = self._attempt(generator, num_envs)
        attempts = torch.ones(num_envs, dtype=torch.int32, device=self.device)
        RG.COUNTERS.levels += num_envs
        RG.COUNTERS.attempts += num_envs
        for _ in range(self.max_gen_attempts):
            RG.COUNTERS.host_syncs += 1
            todo = torch.nonzero(~ok)[:, 0]
            if todo.numel() == 0:
                break
            RG.COUNTERS.attempts += todo.numel()
            sub, sub_ok = self._attempt(generator, todo.numel())
            state = state.with_tensors({
                k: v.index_copy(0, todo, sub.tensors()[k])
                for k, v in state.tensors().items()})
            ok = ok.index_copy(0, todo, sub_ok)
            attempts = attempts.index_add(0, todo, torch.ones_like(
                todo, dtype=torch.int32))
        if num_envs:
            RG.COUNTERS.attempts_max = max(RG.COUNTERS.attempts_max,
                                           int(attempts.max()))
            RG.COUNTERS.not_ok += int((~ok).sum())
        return state, ok, attempts

    def _gen_grid(self, generator, num_envs):
        return self.generate(generator, num_envs)[0]

    def _post_step(self, prev, state, action, reward, terminated):
        """The level's step (the JAX package's ``step_state``,
        level.py:279-299) after the core transition ``prev`` -> ``state``:
        ``post_step.py::babyai_post_step``, one kernel launch on the
        card."""
        _, instr, reward, terminated, truncated = babyai_post_step(
            self.params, prev, state, action, reward, terminated,
            USE_DONE_ACTIONS)
        state = state.replace(truncated=truncated,
                              extra={**state.extra, **instr})
        return state, reward, terminated
