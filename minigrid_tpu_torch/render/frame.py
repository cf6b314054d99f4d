"""Frame composition: full-grid and agent-POV RGB rendering, batched.

Counterpart of ``minigrid_tpu/render/frame.py``. A frame is one gather of
pixel rows from the tile atlas (``render/tiles.py::atlas_rows``): tile
``(x, y)`` of env ``b`` occupies rows ``y*T:(y+1)*T`` and columns
``x*T:(x+1)*T`` (reference grid.py:236-240), so pixel row ``ty`` of the
tile at ``(x, y)`` is atlas row ``tile_id * T + ty``, and gathering those
rows in (B, H, T, W) order writes the (B, H*T, W*T, 3) frame directly.

The view cone and the POV cells come from the observation of the state
(``ops/fused_step.py::fused_observe``: the kernel's observe entry on the
card, ``gen_obs`` on the CPU). A visible cell is never unseen (type 0: out
of bounds reads a wall, the agent's cell an empty cell or what it
carries), so its 9-bit cell is the visibility mask and the cell at once.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid as G
from minigrid_tpu_torch.core.obs import packed_to_image, view_world_coords
from minigrid_tpu_torch.core.types import EnvParams, EnvState
from minigrid_tpu_torch.ops.fused_step import fused_observe
from minigrid_tpu_torch.render.tiles import AGENT_NONE, atlas_rows


def compose_frame(cells3, agent_pos, agent_dir, highlight_mask,
                  tile_size: int) -> torch.Tensor:
    """cells3: (B, W, H, 3) symbolic grids; agent_pos (B or 1, 2) and
    agent_dir (B or 1,); highlight_mask (B, W, H) bool. Returns (B, H*T,
    W*T, 3) uint8. An agent_pos of (-1, -1) renders no agent."""
    B, W, H = cells3.shape[:3]
    T = tile_size
    dev = cells3.device
    c = cells3.to(torch.int64)
    aid = c[..., 0] * 18 + c[..., 1] * 3 + c[..., 2]
    xs = torch.arange(W, device=dev)[:, None]
    ys = torch.arange(H, device=dev)[None, :]
    at_agent = ((xs == agent_pos[:, 0, None, None])
                & (ys == agent_pos[:, 1, None, None]))
    slot = torch.where(at_agent, agent_dir[:, None, None].to(torch.int64),
                       AGENT_NONE)
    tile = (aid * 5 + slot) * 2 + highlight_mask.to(torch.int64)
    # (B, H, T, W) in memory order, so that the gather writes the frame in
    # place (a permuted index would give a permuted result, and the
    # reshape a copy of the whole frame)
    rows = (tile.transpose(1, 2).contiguous()[:, :, None, :] * T
            + torch.arange(T, device=dev)[None, None, :, None]).contiguous()
    frame = _words(atlas_rows(T, dev))[rows]     # (B, H, T, W, row words)
    return frame.view(torch.uint8).reshape(B, H * T, W * T, 3)


def _words(rows: torch.Tensor) -> torch.Tensor:
    """The atlas rows as the widest integer words that tile a row, so that
    the gather moves 8 bytes an element (tile sizes divisible by 8), not
    one."""
    for dtype, size in ((torch.int64, 8), (torch.int32, 4), (torch.int16, 2)):
        if rows.shape[1] % size == 0:
            return rows.view(dtype)
    return rows


def get_full_render(params: EnvParams, state: EnvState,
                    highlight: bool = True,
                    tile_size: int = C.TILE_PIXELS) -> torch.Tensor:
    """Whole-grid frames with each agent's view cone highlighted
    (minigrid_env.py:668-714)."""
    B = state.batch_size
    W, H = params.width, params.height
    if highlight:
        vis = (fused_observe(params, state) & 15) != 0
        wx, wy = view_world_coords(params, state.agent_pos, state.agent_dir)
        mark = vis & (wx >= 0) & (wx < W) & (wy >= 0) & (wy < H)
        flat = torch.where(mark, wx * H + wy, W * H).reshape(B, -1)
        hl = torch.zeros((B, W * H + 1), dtype=torch.bool,
                         device=state.device)
        hl = hl.scatter_(1, flat.to(torch.int64), True)[:, :-1]
        hl = hl.reshape(B, W, H)
    else:
        hl = torch.zeros((B, W, H), dtype=torch.bool, device=state.device)
    return compose_frame(state.grid[..., :3], state.agent_pos,
                         state.agent_dir, hl, tile_size)


def get_pov_render(params: EnvParams, state: EnvState,
                   tile_size: int = C.TILE_PIXELS) -> torch.Tensor:
    """Each agent's point-of-view frame (minigrid_env.py:652-666): visible
    cells highlighted, occluded cells cleared, the agent at bottom-centre
    facing up."""
    V = params.view_size
    packed = fused_observe(params, state)
    vis = (packed & 15) != 0
    cells3 = packed_to_image(torch.where(vis, packed, G.EMPTY_PACKED))
    pos = torch.tensor([[V // 2, V - 1]], device=state.device)
    up = torch.tensor([3], device=state.device)
    return compose_frame(cells3, pos, up, vis, tile_size)


def get_frame(params: EnvParams, state: EnvState, highlight: bool = True,
              tile_size: int = C.TILE_PIXELS,
              agent_pov: bool = False) -> torch.Tensor:
    """The reference ``get_frame`` (minigrid_env.py:716-739), batched."""
    if agent_pov:
        return get_pov_render(params, state, tile_size)
    return get_full_render(params, state, highlight, tile_size)
