"""Egocentric partial observation, batched.

Counterpart of ``minigrid_tpu/core/obs.py``. For every view cell (vx, vy)
the world coordinate is the affine map ``top_left + right*vx - forward*vy``,
so one indexed read of the packed grid gives the already-rotated view;
out-of-bounds reads are grey walls (reference grid.py:139). Visibility is
computed on the raw window, then the carried object is overlaid at the
agent's view cell (V//2, V-1), then invisible cells become 0 (unseen).
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid as G
from minigrid_tpu_torch.core.step import dir_vec, read_packed
from minigrid_tpu_torch.core.types import EnvParams, EnvState
from minigrid_tpu_torch.core.visibility import process_vis


def view_world_coords(params: EnvParams, agent_pos, agent_dir):
    """(B, V, V) world x/y for every view cell, indexed [b, vx, vy]."""
    V = params.view_size
    hs = V // 2
    fx, fy = dir_vec(agent_dir)
    rx, ry = -fy, fx
    tlx = agent_pos[:, 0] + fx * (V - 1) - rx * hs
    tly = agent_pos[:, 1] + fy * (V - 1) - ry * hs
    v = torch.arange(V, device=agent_pos.device, dtype=torch.int32)
    vx, vy = v[:, None], v[None, :]
    wx = tlx[:, None, None] + rx[:, None, None] * vx - fx[:, None, None] * vy
    wy = tly[:, None, None] + ry[:, None, None] * vx - fy[:, None, None] * vy
    return wx, wy


def _view_packed(params: EnvParams, state: EnvState):
    """Packed view window (B, V, V) int32 + visibility, both agent-frame
    [vx, vy], WITHOUT the carried-object overlay (visibility is computed on
    the raw slice; the overlay happens afterwards)."""
    V = params.view_size
    wx, wy = view_world_coords(params, state.agent_pos, state.agent_dir)
    u, _ = read_packed(G.pack_cells(state.grid), wx, wy, G.WALL_PACKED)
    if params.see_through_walls:
        vis = torch.ones_like(u, dtype=torch.bool)
    else:
        typ = u & 15
        transparent = ~((typ == C.WALL)
                        | ((typ == C.DOOR) & (((u >> 7) & 3) != C.OPEN)))
        vis = process_vis(transparent, V // 2)
    return u, vis


def _overlay_carried(params: EnvParams, state: EnvState, u: torch.Tensor):
    """Carried-object overlay at the agent's view cell (V//2, V-1)
    (minigrid_env.py:626-630); carrying == EMPTY_CELL reproduces the
    reference's set-to-None."""
    V = params.view_size
    u = u.clone()
    u[:, V // 2, V - 1] = G.pack_cells(state.carrying)
    return u


def gen_obs_grid(params: EnvParams, state: EnvState):
    """View cells (B, V, V, 5) uint8 + visibility (B, V, V) bool, both
    agent-frame [vx, vy]: the window with the carried object overlaid,
    invisible cells kept (the renderer clears them itself)."""
    u, vis = _view_packed(params, state)
    return G.unpack_cells(_overlay_carried(params, state, u)), vis


def packed_to_image(packed: torch.Tensor) -> torch.Tensor:
    """(..., V, V) 9-bit packed view -> (..., V, V, 3) uint8 image."""
    return torch.stack([packed & 15, (packed >> 4) & 7, (packed >> 7) & 3],
                       dim=-1).to(torch.uint8)


def gen_obs(params: EnvParams, state: EnvState) -> dict:
    """Observation dict {packed|image, direction, mission} of every env.

    ``packed``: (B, V, V) int32, the 9 observation bits of each visible cell
    (type | color << 4 | state << 7), 0 = unseen. ``image``: (B, V, V, 3)
    uint8, the same cells as channels."""
    u, vis = _view_packed(params, state)
    u = _overlay_carried(params, state, u)
    u = torch.where(vis, u & 0x1FF, 0)
    view = ({"packed": u} if params.packed_obs
            else {"image": packed_to_image(u)})
    return view | {"direction": state.agent_dir, "mission": state.mission}
