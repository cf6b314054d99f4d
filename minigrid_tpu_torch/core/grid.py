"""Batched array-grid operations.

Counterpart of ``minigrid_tpu/core/grid.py``. A grid batch is a
``(B, W, H, 5)`` uint8 tensor indexed ``grid[b, x, y]``. Coordinates passed to
the builders may be Python ints (the same for every env) or ``(B,)`` tensors
(one per env); the writes are coordinate-mask blends, so out-of-range
coordinates write nothing, as in the JAX package.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core.types import device_of


def _per_env(v, device) -> torch.Tensor:
    """An int or a (B,) tensor as a (B|1, 1, 1) int64 tensor for broadcasting
    against (W, H) coordinate grids."""
    return torch.as_tensor(v, device=device).to(torch.int64).reshape(-1, 1, 1)


def _cell(cell, device) -> torch.Tensor:
    return torch.as_tensor(cell, dtype=torch.uint8, device=device)


def empty_grid(batch: int, width: int, height: int,
               device=None) -> torch.Tensor:
    """All-empty grids of shape (batch, width, height, 5)."""
    return _cell(C.EMPTY_CELL, device).expand(
        batch, width, height, C.NUM_CHANNELS).clone()


def coord_grids(width: int, height: int, device=None):
    """(W, H) int64 tensors of x and y coordinates."""
    xs = torch.arange(width, device=device).reshape(width, 1).expand(
        width, height)
    ys = torch.arange(height, device=device).reshape(1, height).expand(
        width, height)
    return xs, ys


def fill_mask(grid: torch.Tensor, mask: torch.Tensor, cell) -> torch.Tensor:
    """Write ``cell`` ((5,) or (B, 5)) wherever the (B|1, W, H) mask
    holds."""
    cell = _cell(cell, grid.device)
    if cell.ndim == 2:
        cell = cell[:, None, None, :]
    return torch.where(mask[..., None], cell, grid)


def set_cell(grid: torch.Tensor, x, y, cell) -> torch.Tensor:
    """Write one cell per env at (x, y)."""
    xs, ys = coord_grids(grid.shape[1], grid.shape[2], grid.device)
    m = (xs == _per_env(x, grid.device)) & (ys == _per_env(y, grid.device))
    return fill_mask(grid, m, cell)


def fill_rect(grid: torch.Tensor, x0, y0, w, h, cell) -> torch.Tensor:
    """Set every cell of [x0, x0+w) x [y0, y0+h) to ``cell``, per env."""
    dev = grid.device
    xs, ys = coord_grids(grid.shape[1], grid.shape[2], dev)
    x0, y0 = _per_env(x0, dev), _per_env(y0, dev)
    w, h = _per_env(w, dev), _per_env(h, dev)
    mask = (xs >= x0) & (xs < x0 + w) & (ys >= y0) & (ys < y0 + h)
    return fill_mask(grid, mask, cell)


def horz_wall(grid, x, y, length=None, cell=None):
    if length is None:
        length = grid.shape[1] - torch.as_tensor(x)
    cell = C.WALL_CELL if cell is None else cell
    return fill_rect(grid, x, y, length, 1, cell)


def vert_wall(grid, x, y, length=None, cell=None):
    if length is None:
        length = grid.shape[2] - torch.as_tensor(y)
    cell = C.WALL_CELL if cell is None else cell
    return fill_rect(grid, x, y, 1, length, cell)


def wall_rect(grid, x, y, w, h):
    grid = horz_wall(grid, x, y, w)
    grid = fill_rect(grid, x, y + h - 1, w, 1, C.WALL_CELL)
    grid = vert_wall(grid, x, y, h)
    grid = fill_rect(grid, x + w - 1, y, 1, h, C.WALL_CELL)
    return grid


def get_cell(grid: torch.Tensor, x, y) -> torch.Tensor:
    """The cell at (x, y) of each env: (B, 5) from a (B, W, H, 5) batch
    with int or (B,) coordinates, (5,) from one (W, H, 5) grid. An
    out-of-range read gives the empty cell."""
    batch = grid if grid.ndim == 4 else grid[None]
    B, W, H, _ = batch.shape
    dev = batch.device
    x = torch.as_tensor(x, device=dev).to(torch.int64).expand(B)
    y = torch.as_tensor(y, device=dev).to(torch.int64).expand(B)
    inb = (x >= 0) & (x < W) & (y >= 0) & (y < H)
    cell = batch[torch.arange(B, device=dev), x.clamp(0, W - 1),
                 y.clamp(0, H - 1)]
    cell = torch.where(inb[:, None], cell, _cell(C.EMPTY_CELL, dev))
    return cell if grid.ndim == 4 else cell[0]


def encode(grid: torch.Tensor,
           vis_mask: torch.Tensor | None = None) -> torch.Tensor:
    """(..., W, H, 3) uint8 observation encoding (reference
    grid.py:244-268): the first three channels, and (0, 0, 0), unseen,
    where ``vis_mask`` ((..., W, H) bool) is False."""
    img = grid[..., :3]
    if vis_mask is not None:
        img = torch.where(vis_mask[..., None], img, 0)
    return img


def decode(array, device=None) -> torch.Tensor:
    """Inverse of :func:`encode` on a (..., 3) array (reference
    grid.py:270-289): the contents channels are zeroed. On ``device``,
    else on the array's (``types.device_of``)."""
    a = torch.as_tensor(array, device=device_of(array, device=device)).to(
        torch.uint8)
    if a.shape[-1] != 3:
        raise ValueError(f"decode takes (..., 3) arrays, got {tuple(a.shape)}")
    return torch.cat([a, a.new_zeros(a.shape[:-1] + (2,))], dim=-1)


def transparent_mask(grid: torch.Tensor) -> torch.Tensor:
    """(..., W, H) bool — per-cell ``see_behind`` (world_object.py:57-59,
    164, 181): neither a wall nor a door that is not open."""
    t = grid[..., 0]
    closed_door = (t == C.DOOR) & (grid[..., 2] != C.OPEN)
    return ~((t == C.WALL) | closed_door)


def can_overlap_mask(grid: torch.Tensor) -> torch.Tensor:
    """(..., W, H) bool — cells the agent may enter (world_object.py:
    45-47, 177): the types of ``constants.CAN_OVERLAP_TABLE``, and open
    doors."""
    t = grid[..., 0]
    table = torch.as_tensor(C.CAN_OVERLAP_TABLE, device=grid.device)
    open_door = (t == C.DOOR) & (grid[..., 2] == C.OPEN)
    return table[t.long()] | open_door


def free_mask(grid: torch.Tensor) -> torch.Tensor:
    """(B, W, H) bool — cells containing no object."""
    return grid[..., 0] == C.EMPTY


# Packed-cell representation: the 5 uint8 channels in one int32
# (4+3+2+4+3 = 16 bits; every channel is bounded by the vocabularies in
# core/constants.py). The same bit layout as the JAX package.

def pack_cells(cells: torch.Tensor) -> torch.Tensor:
    """(..., 5) uint8 -> (...,) int32 packed cell."""
    c = cells.to(torch.int32)
    return (c[..., 0] | (c[..., 1] << 4) | (c[..., 2] << 7)
            | (c[..., 3] << 9) | (c[..., 4] << 13))


def unpack_cells(packed: torch.Tensor) -> torch.Tensor:
    """(...,) int32 packed cell -> (..., 5) uint8."""
    p = packed
    return torch.stack(
        [p & 15, (p >> 4) & 7, (p >> 7) & 3, (p >> 9) & 15, (p >> 13) & 7],
        dim=-1).to(torch.uint8)


WALL_PACKED = int(C.WALL | (C.COLOR_TO_IDX["grey"] << 4))
EMPTY_PACKED = int(C.EMPTY)
