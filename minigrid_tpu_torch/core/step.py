"""The batched environment transition.

Counterpart of ``minigrid_tpu/core/step.py``: the reference action ladder
(``minigrid/minigrid_env.py:525-595``) as a fixed dataflow of compares and
``where`` selects over a batch of envs. The front cell is read and written
by integer indexing; the JAX package's one-hot reads and scatter-free
writes were shaped by the TPU and are not needed here. This is the plain
PyTorch path: the CPU path and the check of the CUDA kernel
(``ops/fused_step.py``).
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid as G
from minigrid_tpu_torch.core.actions import Actions
from minigrid_tpu_torch.core.types import EnvParams, EnvState


def reward_on_success(params: EnvParams, step_count) -> torch.Tensor:
    """``1 - 0.9 * (step_count / max_steps)`` in float32, rounded after
    every operation (minigrid_env.py:240-245).

    The divisor is a tensor, not a Python number: PyTorch's CUDA division
    by a scalar multiplies by its reciprocal, which rounds differently from
    the true division the JAX package and the CUDA kernel compute."""
    sc = step_count.to(torch.float32)
    return 1.0 - 0.9 * (sc / torch.full_like(sc, params.max_steps))


def dir_vec(d: torch.Tensor):
    """DIR_TO_VEC as arithmetic: dirs 0..3 -> (1,0) (0,1) (-1,0) (0,-1)."""
    fx = (d == 0).to(torch.int32) - (d == 2).to(torch.int32)
    fy = (d == 1).to(torch.int32) - (d == 3).to(torch.int32)
    return fx, fy


def read_packed(packed_grid: torch.Tensor, x, y, oob_value: int):
    """Packed cell (x, y) of each env from a (B, W, H) int32 grid;
    ``oob_value`` where the coordinate is out of range."""
    B, W, H = packed_grid.shape
    inb = (x >= 0) & (x < W) & (y >= 0) & (y < H)
    flat = (x.clamp(0, W - 1) * H + y.clamp(0, H - 1)).to(torch.int64)
    flat = flat.reshape(B, -1)
    val = torch.gather(packed_grid.reshape(B, W * H), 1, flat)
    return torch.where(inb, val.reshape(inb.shape), oob_value), inb


def front_cell(params: EnvParams, state: EnvState):
    """The cell in front of each agent (minigrid_env.py:535-538).

    Returns ``(fwd, in_bounds, fwd_cell)``: the (B, 2) forward coordinate,
    its validity, and the (B, 5) cell value (a wall when out of bounds)."""
    fx, fy = dir_vec(state.agent_dir)
    fwd = state.agent_pos + torch.stack([fx, fy], dim=-1)
    val, in_bounds = read_packed(G.pack_cells(state.grid), fwd[:, 0],
                                 fwd[:, 1], G.WALL_PACKED)
    return fwd, in_bounds, G.unpack_cells(val)


def step_core(params: EnvParams, state: EnvState, action):
    """One transition of every env. Returns (new_state, reward, terminated).

    Truncation (step_count >= max_steps) is recorded in
    ``new_state.truncated``."""
    action = torch.as_tensor(action, device=state.device).to(torch.int32)
    step_count = state.step_count + 1

    turn = torch.where(action == Actions.left, -1,
                       torch.where(action == Actions.right, 1, 0))
    new_dir = ((state.agent_dir + turn) % 4).to(torch.int32)

    fwd, in_bounds, fwd_cell = front_cell(params, state)
    ftype = fwd_cell[:, 0]
    fcolor = fwd_cell[:, 1]
    fstate = fwd_cell[:, 2]

    carrying = state.carrying
    is_carrying = carrying[:, 0] != C.EMPTY

    can_overlap = ((ftype == C.EMPTY) | (ftype == C.FLOOR)
                   | (ftype == C.GOAL) | (ftype == C.LAVA)
                   | ((ftype == C.DOOR) & (fstate == C.OPEN)))
    is_forward = action == Actions.forward
    move = is_forward & can_overlap & in_bounds
    new_pos = torch.where(move[:, None], fwd, state.agent_pos)
    hits_goal = is_forward & (ftype == C.GOAL)
    hits_lava = is_forward & (ftype == C.LAVA)
    terminated = hits_goal | hits_lava
    reward = torch.where(hits_goal, reward_on_success(params, step_count),
                         0.0)

    do_pickup = ((action == Actions.pickup)
                 & ((ftype == C.KEY) | (ftype == C.BALL) | (ftype == C.BOX))
                 & ~is_carrying)
    do_drop = (action == Actions.drop) & (ftype == C.EMPTY) & is_carrying

    is_toggle = action == Actions.toggle
    is_door = ftype == C.DOOR
    has_matching_key = (carrying[:, 0] == C.KEY) & (carrying[:, 1] == fcolor)
    unlocks = (fstate == C.LOCKED) & has_matching_key
    toggled = torch.where(
        fstate == C.LOCKED,
        torch.where(unlocks, C.OPEN, C.LOCKED),
        torch.where(fstate == C.OPEN, C.CLOSED, C.OPEN)).to(torch.uint8)
    door_cell = fwd_cell.clone()
    door_cell[:, 2] = toggled

    is_box = ftype == C.BOX
    empty = torch.as_tensor(C.EMPTY_CELL, device=state.device)
    contents = torch.zeros_like(fwd_cell)
    contents[:, 0] = fwd_cell[:, 3]
    contents[:, 1] = fwd_cell[:, 4]
    contents = torch.where((fwd_cell[:, 3] != 0)[:, None], contents, empty)

    new_fwd = fwd_cell
    new_fwd = torch.where(do_pickup[:, None], empty, new_fwd)
    new_fwd = torch.where(do_drop[:, None], carrying, new_fwd)
    new_fwd = torch.where((is_toggle & is_door)[:, None], door_cell, new_fwd)
    new_fwd = torch.where((is_toggle & is_box)[:, None], contents, new_fwd)

    write = in_bounds & (do_pickup | do_drop | (is_toggle & (is_door | is_box)))
    new_grid = state.grid.clone()
    b = torch.nonzero(write).squeeze(-1)
    new_grid[b, fwd[b, 0].long(), fwd[b, 1].long()] = new_fwd[b]

    new_carrying = torch.where(
        do_pickup[:, None], fwd_cell,
        torch.where(do_drop[:, None], empty, carrying))

    truncated = step_count >= params.max_steps

    new_state = state.replace(
        grid=new_grid,
        agent_pos=new_pos.to(torch.int32),
        agent_dir=new_dir,
        carrying=new_carrying,
        step_count=step_count,
        terminated=terminated,
        truncated=truncated,
    )
    return new_state, reward, terminated
