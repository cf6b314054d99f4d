"""Tile atlas construction (host-side numpy).

The port's own copy of ``minigrid_tpu/render/tiles.py``, reading the port's
constants: the whole appearance space rasterized once into a uint8 atlas

    atlas[appearance_id, agent_slot, highlight]  ->  (T, T, 3)

with ``appearance_id = type*18 + color*3 + state`` and agent_slot in
{0..3 = agent facing dir, 4 = no agent}, so that a frame is one gather
(``render/frame.py``). The rasterizer evaluates the reference's shape
predicates (``minigrid/utils/rendering.py``) at pixel centres with 3x
supersampling; its atlas equals the JAX package's byte for byte. Building
one takes seconds on a CPU (more at larger tiles), so each tile size is
built once per process and moved to each device once
(:func:`atlas_rows`).
"""

from __future__ import annotations

import math

import numpy as np

import torch

from minigrid_tpu_torch.core import constants as C

SUBDIVS = 3
N_APPEARANCE = C.NUM_OBJECTS * C.NUM_COLORS * 3
AGENT_NONE = 4

_atlas_cache: dict[int, np.ndarray] = {}
_device_rows: dict[tuple[int, str], torch.Tensor] = {}


def _coords(size: int):
    ys, xs = np.mgrid[0:size, 0:size]
    return (xs + 0.5) / size, (ys + 0.5) / size  # xf, yf


def _rect(xf, yf, xmin, xmax, ymin, ymax):
    return (xf >= xmin) & (xf <= xmax) & (yf >= ymin) & (yf <= ymax)


def _circle(xf, yf, cx, cy, r):
    return (xf - cx) ** 2 + (yf - cy) ** 2 <= r * r


def _line(xf, yf, x0, y0, x1, y1, r):
    # distance from pixel center to the segment (rendering.py:53-81)
    p0 = np.array([x0, y0], np.float32)
    d = np.array([x1 - x0, y1 - y0], np.float32)
    dist = float(np.linalg.norm(d))
    d = d / dist
    a = np.clip((xf - p0[0]) * d[0] + (yf - p0[1]) * d[1], 0, dist)
    px = p0[0] + a * d[0]
    py = p0[1] + a * d[1]
    return np.hypot(xf - px, yf - py) <= r


def _triangle(xf, yf, a, b, c):
    a, b, c = (np.array(p, np.float32) for p in (a, b, c))
    v0, v1 = c - a, b - a
    v2x, v2y = xf - a[0], yf - a[1]
    dot00 = v0 @ v0
    dot01 = v0 @ v1
    dot11 = v1 @ v1
    dot02 = v0[0] * v2x + v0[1] * v2y
    dot12 = v1[0] * v2x + v1[1] * v2y
    inv = 1.0 / (dot00 * dot11 - dot01 * dot01)
    u = (dot11 * dot02 - dot01 * dot12) * inv
    v = (dot00 * dot12 - dot01 * dot02) * inv
    return (u >= 0) & (v >= 0) & (u + v < 1)


def _rotate_coords(xf, yf, cx, cy, theta):
    """Sample-space inverse rotation (rendering.py:40-50)."""
    x = xf - cx
    y = yf - cy
    x2 = cx + x * math.cos(-theta) - y * math.sin(-theta)
    y2 = cy + y * math.cos(-theta) + x * math.sin(-theta)
    return x2, y2


def _paint(img, mask, color):
    img[mask] = color


def _render_object(img, xf, yf, type_idx: int, color_idx: int, state: int):
    """Vector shapes per object type (world_object.py renders)."""
    rgb = C.COLOR_RGB[color_idx].astype(np.float64)
    t = C.IDX_TO_OBJECT[type_idx]

    if t == "goal":
        _paint(img, _rect(xf, yf, 0, 1, 0, 1), rgb)
    elif t == "floor":
        _paint(img, _rect(xf, yf, 0.031, 1, 0.031, 1), rgb / 2)
    elif t == "lava":
        _paint(img, _rect(xf, yf, 0, 1, 0, 1), (255, 128, 0))
        for i in range(3):
            ylo = 0.3 + 0.2 * i
            yhi = 0.4 + 0.2 * i
            for x0, y0, x1, y1 in [(0.1, ylo, 0.3, yhi), (0.3, yhi, 0.5, ylo),
                                   (0.5, ylo, 0.7, yhi), (0.7, yhi, 0.9, ylo)]:
                _paint(img, _line(xf, yf, x0, y0, x1, y1, 0.03), (0, 0, 0))
    elif t == "wall":
        _paint(img, _rect(xf, yf, 0, 1, 0, 1), rgb)
    elif t == "door":
        if state == C.OPEN:
            _paint(img, _rect(xf, yf, 0.88, 1.00, 0.00, 1.00), rgb)
            _paint(img, _rect(xf, yf, 0.92, 0.96, 0.04, 0.96), (0, 0, 0))
        elif state == C.LOCKED:
            _paint(img, _rect(xf, yf, 0.00, 1.00, 0.00, 1.00), rgb)
            _paint(img, _rect(xf, yf, 0.06, 0.94, 0.06, 0.94), 0.45 * rgb)
            _paint(img, _rect(xf, yf, 0.52, 0.75, 0.50, 0.56), rgb)
        else:
            _paint(img, _rect(xf, yf, 0.00, 1.00, 0.00, 1.00), rgb)
            _paint(img, _rect(xf, yf, 0.04, 0.96, 0.04, 0.96), (0, 0, 0))
            _paint(img, _rect(xf, yf, 0.08, 0.92, 0.08, 0.92), rgb)
            _paint(img, _rect(xf, yf, 0.12, 0.88, 0.12, 0.88), (0, 0, 0))
            _paint(img, _circle(xf, yf, 0.75, 0.50, 0.08), rgb)
    elif t == "key":
        _paint(img, _rect(xf, yf, 0.50, 0.63, 0.31, 0.88), rgb)
        _paint(img, _rect(xf, yf, 0.38, 0.50, 0.59, 0.66), rgb)
        _paint(img, _rect(xf, yf, 0.38, 0.50, 0.81, 0.88), rgb)
        _paint(img, _circle(xf, yf, 0.56, 0.28, 0.190), rgb)
        _paint(img, _circle(xf, yf, 0.56, 0.28, 0.064), (0, 0, 0))
    elif t == "ball":
        _paint(img, _circle(xf, yf, 0.5, 0.5, 0.31), rgb)
    elif t == "box":
        _paint(img, _rect(xf, yf, 0.12, 0.88, 0.12, 0.88), rgb)
        _paint(img, _rect(xf, yf, 0.18, 0.82, 0.18, 0.82), (0, 0, 0))
        _paint(img, _rect(xf, yf, 0.16, 0.84, 0.47, 0.53), rgb)
    # unseen / empty / agent appearance ids render nothing


def render_tile(type_idx: int, color_idx: int, state: int, agent_dir: int | None,
                highlight: bool, tile_size: int) -> np.ndarray:
    """One tile, reference paint order (grid.py:145-198). Returns float64
    (T, T, 3) — the reference paints shapes into a uint8 supersampled
    buffer (colors truncate at paint time, grid.py:165), caches the float
    mean-downsampled tile and truncates again on frame assignment."""
    size = tile_size * SUBDIVS
    xf, yf = _coords(size)
    img = np.zeros((size, size, 3), np.uint8)

    _paint(img, _rect(xf, yf, 0, 0.031, 0, 1), (100, 100, 100))
    _paint(img, _rect(xf, yf, 0, 1, 0, 0.031), (100, 100, 100))

    _render_object(img, xf, yf, type_idx, color_idx, state)

    if agent_dir is not None:
        x2, y2 = _rotate_coords(xf, yf, 0.5, 0.5, 0.5 * math.pi * agent_dir)
        tri = _triangle(x2, y2, (0.12, 0.19), (0.87, 0.50), (0.12, 0.81))
        _paint(img, tri, (255, 0, 0))

    if highlight:
        # highlight_img blends towards white on the uint8 buffer
        # (rendering.py:126-133)
        blend = img + 0.30 * (
            np.array([255, 255, 255], np.uint8) - img
        )
        img = np.clip(blend, 0, 255).astype(np.uint8)

    img = img.reshape(tile_size, SUBDIVS, tile_size, SUBDIVS, 3).astype(np.float64)
    return img.mean(axis=3).mean(axis=1)


def get_atlas(tile_size: int) -> np.ndarray:
    """(N_APPEARANCE, 5, 2, T, T, 3) uint8 atlas, cached per tile size."""
    if tile_size in _atlas_cache:
        return _atlas_cache[tile_size]
    atlas = np.zeros(
        (N_APPEARANCE, 5, 2, tile_size, tile_size, 3), np.uint8
    )
    for type_idx in range(C.NUM_OBJECTS):
        for color_idx in range(C.NUM_COLORS):
            n_states = 3 if type_idx == C.DOOR else 1
            for state in range(3):
                aid = type_idx * 18 + color_idx * 3 + state
                s = min(state, n_states - 1)
                for slot in range(5):
                    agent_dir = None if slot == AGENT_NONE else slot
                    for hl in range(2):
                        tile = render_tile(type_idx, color_idx, s, agent_dir,
                                           bool(hl), tile_size)
                        # frame assembly truncates float -> uint8
                        atlas[aid, slot, hl] = tile.astype(np.uint8)
    _atlas_cache[tile_size] = atlas
    return atlas


def atlas_rows(tile_size: int, device) -> torch.Tensor:
    """The atlas on ``device`` as pixel rows: (N_APPEARANCE * 5 * 2 * T,
    T * 3) uint8, row ``((aid * 5 + slot) * 2 + hl) * T + ty`` holding
    pixel row ``ty`` of that tile. Cached per (tile size, device)."""
    dev = torch.device(device)
    key = (tile_size, str(dev))
    if key not in _device_rows:
        atlas = get_atlas(tile_size)
        _device_rows[key] = torch.from_numpy(
            atlas.reshape(-1, tile_size * 3)).to(dev)
    return _device_rows[key]
