"""WFC pattern/adjacency extraction (host-side, once per config).

The port's own copy of ``minigrid_tpu/envs/wfc/patterns.py`` (numpy only).
Re-design of the reference's catalog pipeline
(``minigrid/envs/wfc/wfclogic/{tiles,patterns,adjacency}.py``): the example
image's overlapping NxN windows over its 8 dihedral variants become a unique
pattern table with occurrence weights, and legal adjacencies come from
overlap agreement. Everything here is precomputed numpy whose arrays the
batched solver moves to the env's device once.
"""

from __future__ import annotations

import numpy as np

# direction order: (dy, dx) — up, down, left, right
DIRECTIONS = [(-1, 0), (1, 0), (0, -1), (0, 1)]


def dihedral_variants(grid: np.ndarray, rotations: int = 8):
    """The reference's reflect/rotate chain (patterns.py:148-165): applying
    [id, reflect, rotate, reflect, rotate, reflect, rotate, reflect]
    cumulatively yields the 8 dihedral images."""
    ops = ["id", "ref", "rot", "ref", "rot", "ref", "rot", "ref"]
    out = []
    g = grid.copy()
    for i in range(min(rotations + 1, 8)):
        if ops[i] == "ref":
            g = np.fliplr(g)
        elif ops[i] == "rot":
            g = np.rot90(g, axes=(1, 0))
        out.append(g.copy())
    return out


def extract_windows(grid: np.ndarray, n: int, periodic: bool) -> np.ndarray:
    """(K, n, n) all NxN windows.

    NOTE: the reference always wraps over the edges regardless of
    ``input_periodic`` (unique_patterns_2d's non-periodic branch is an
    unimplemented TODO that falls through to wrap, patterns.py:26-33);
    reproduced here for texture parity.
    """
    H, W = grid.shape
    del periodic  # reference behavior: always periodic
    grid = np.pad(grid, ((0, n - 1), (0, n - 1)), mode="wrap")
    wins = [grid[i : i + n, j : j + n] for i in range(H) for j in range(W)]
    return np.stack(wins)


def build_catalog(image: np.ndarray, pattern_width: int, rotations: int,
                  input_periodic: bool):
    """Returns (patterns (P, n, n), weights (P,) float, tile_values).

    Weights follow the reference's counting: each unique pattern counts
    once per dihedral variant it appears in (patterns.py:93 builds the
    frequency Counter over the per-variant unique-pattern list).
    """
    if image.ndim == 3:
        # distinct colors -> tile ids (tiles.py hash_downto)
        flat = image.reshape(-1, image.shape[-1])
        colors, inv = np.unique(flat, axis=0, return_inverse=True)
        grid = inv.reshape(image.shape[:2])
        tile_values = colors
    else:
        vals, inv = np.unique(image, return_inverse=True)
        grid = inv.reshape(image.shape)
        tile_values = vals

    variant_uniques = []
    for var in dihedral_variants(grid, rotations):
        wins = extract_windows(var, pattern_width, input_periodic)
        flat = wins.reshape(wins.shape[0], -1)
        variant_uniques.append(np.unique(flat, axis=0))
    allu = np.concatenate(variant_uniques)
    uniq, counts = np.unique(allu, axis=0, return_counts=True)
    patterns = uniq.reshape(-1, pattern_width, pattern_width)
    return patterns, counts.astype(np.float64), tile_values


def build_adjacency(patterns: np.ndarray) -> np.ndarray:
    """(4, P, P) bool: adj[d, p, q] — q may sit at offset DIRECTIONS[d]
    from p (overlap regions agree, adjacency.py:17-47)."""
    P, n, _ = patterns.shape
    adj = np.zeros((len(DIRECTIONS), P, P), bool)
    for d, (dy, dx) in enumerate(DIRECTIONS):
        a = patterns[:, max(dy, 0): n + min(dy, 0), max(dx, 0): n + min(dx, 0)]
        b = patterns[:, max(-dy, 0): n + min(-dy, 0), max(-dx, 0): n + min(-dx, 0)]
        af = a.reshape(P, -1)
        bf = b.reshape(P, -1)
        adj[d] = (af[:, None, :] == bf[None, :, :]).all(-1)
    return adj
