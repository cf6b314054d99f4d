"""Batched object/agent placement.

Counterpart of ``minigrid_tpu/core/place.py``. The reference's rejection
sampling (``minigrid/minigrid_env.py:313-372``) converges to the uniform
distribution over acceptable cells; here each env draws one uniform sample
over its acceptance mask. Randomness comes from an explicit
``torch.Generator`` on the grid's device.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import grid as G


def sample_from_mask(generator: torch.Generator,
                     mask: torch.Tensor) -> torch.Tensor:
    """Uniform (x, y) over the True cells of each (W, H) mask.

    mask: (B, W, H) bool with at least one True cell per env (generators
    guarantee it by construction). Returns (B, 2) int32. The argmax of iid
    uniform scores restricted to the mask is a uniform pick among its cells.
    """
    B, W, H = mask.shape
    u = torch.rand((B, W * H), generator=generator, device=mask.device)
    u = torch.where(mask.reshape(B, W * H), u, -1.0)
    idx = u.argmax(dim=1)
    return torch.stack([idx // H, idx % H], dim=-1).to(torch.int32)


def rect_mask(width: int, height: int, top, size, device=None):
    """(B|1, W, H) mask of the placement rectangle; top clamps at 0 and the
    rectangle is clipped to the grid (minigrid_env.py:329-335,347-350)."""
    xs, ys = G.coord_grids(width, height, device)
    tx = G._per_env(top[0], device).clamp(min=0)
    ty = G._per_env(top[1], device).clamp(min=0)
    sx = G._per_env(size[0], device)
    sy = G._per_env(size[1], device)
    return (xs >= tx) & (xs < tx + sx) & (ys >= ty) & (ys < ty + sy)


def placeable_mask(grid: torch.Tensor, agent_pos=None, top=None,
                   size=None) -> torch.Tensor:
    """Cells where place_obj may land: empty, not the agent, in the rect."""
    _, W, H, _ = grid.shape
    mask = G.free_mask(grid)
    if agent_pos is not None:
        xs, ys = G.coord_grids(W, H, grid.device)
        mask = mask & ~((xs == G._per_env(agent_pos[:, 0], grid.device))
                        & (ys == G._per_env(agent_pos[:, 1], grid.device)))
    if top is not None or size is not None:
        top = (0, 0) if top is None else top
        size = (W, H) if size is None else size
        mask = mask & rect_mask(W, H, top, size, grid.device)
    return mask


def place_obj(generator, grid, cell, agent_pos, top=None, size=None,
              reject_mask=None):
    """Place ``cell`` uniformly over each env's acceptable positions.
    ``reject_mask`` ((B|1, W, H) bool) marks forbidden cells (the
    reference's reject_fn returning True, minigrid_env.py:361).

    Returns (new_grid, pos)."""
    mask = placeable_mask(grid, agent_pos, top, size)
    if reject_mask is not None:
        mask = mask & ~reject_mask
    pos = sample_from_mask(generator, mask)
    return G.set_cell(grid, pos[:, 0], pos[:, 1], cell), pos


def place_agent(generator, grid, top=None, size=None, rand_dir=True,
                reject_mask=None):
    """Agent start placement at a uniform free cell, facing a uniform
    direction, or direction 0 without ``rand_dir`` (minigrid_env.py:383-395).
    Returns (pos, dir)."""
    mask = placeable_mask(grid, None, top, size)
    if reject_mask is not None:
        mask = mask & ~reject_mask
    pos = sample_from_mask(generator, mask)
    if rand_dir:
        agent_dir = torch.randint(0, 4, (grid.shape[0],), generator=generator,
                                  device=grid.device, dtype=torch.int32)
    else:
        agent_dir = torch.zeros((grid.shape[0],), dtype=torch.int32,
                                device=grid.device)
    return pos, agent_dir


def neighbor_mask(width: int, height: int, pos) -> torch.Tensor:
    """(B, W, H) mask of the 8-neighbourhood of each env's ``pos`` ((B, 2))
    including the cell itself (core/roomgrid.py's reject_next_to)."""
    xs, ys = G.coord_grids(width, height, pos.device)
    return (((xs - G._per_env(pos[:, 0], pos.device)).abs() <= 1)
            & ((ys - G._per_env(pos[:, 1], pos.device)).abs() <= 1))
