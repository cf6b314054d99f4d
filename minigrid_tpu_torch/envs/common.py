"""Shared cells, colours and batched draws for the environment generators.

Counterpart of ``minigrid_tpu/envs/common.py``. A generator here builds B
layouts at once, so a cell may differ per env: :func:`cells` stacks (B,)
channel values into a (B, 5) uint8 cell that ``core/grid.py``'s writers
take. JAX draws with per-env bounds (``randint(key, (), lo, hi)`` under
``vmap``) and per-env permutations; ``torch.randint`` takes scalar bounds
only, so :func:`randint` draws ``lo + floor(u * (hi - lo))`` per env and
:func:`permutations` ranks uniform scores. :func:`hash_scores` is the
keyed integer hash of the draws that must be the same on both devices.
"""

from __future__ import annotations

import numpy as np
import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core.types import pack_cell

GREEN = C.COLOR_TO_IDX["green"]
BLUE = C.COLOR_TO_IDX["blue"]
RED = C.COLOR_TO_IDX["red"]
YELLOW = C.COLOR_TO_IDX["yellow"]
PURPLE = C.COLOR_TO_IDX["purple"]
GREY = C.COLOR_TO_IDX["grey"]

GOAL_CELL = [C.GOAL, GREEN, 0, 0, 0]
LAVA_CELL = [C.LAVA, RED, 0, 0, 0]
WALL_CELL = C.WALL_CELL
EMPTY_CELL = C.EMPTY_CELL

# Colours in sorted-name order (blue, green, grey, purple, red, yellow), the
# order of ``_rand_color``/``_rand_elem(sorted(...))`` draws
# (minigrid_env.py:294-299, envs/multiroom.py:174).
SORTED_COLOR_IDS = np.array([C.COLOR_TO_IDX[n] for n in C.COLOR_NAMES],
                            np.int64)


def cells(type_idx, color=0, state=0, cont_type=0, cont_color=0,
          device=None) -> torch.Tensor:
    """A (B, 5) uint8 cell per env from channel values, each an int or a
    (B,) tensor (JAX ``pack_cell`` under ``vmap``); ints give B=1."""
    return pack_cell(type_idx, color, state, cont_type, cont_color,
                     device).reshape(-1, C.NUM_CHANNELS)


def door(color, state=C.CLOSED, device=None) -> torch.Tensor:
    return pack_cell(C.DOOR, color, state, device=device)


def key(color, device=None) -> torch.Tensor:
    return pack_cell(C.KEY, color, device=device)


def ball(color, device=None) -> torch.Tensor:
    return pack_cell(C.BALL, color, device=device)


def box(color, cont_type=0, cont_color=0, device=None) -> torch.Tensor:
    return pack_cell(C.BOX, color, 0, cont_type, cont_color, device)


def randint(generator: torch.Generator, lo, hi, n: int,
            device=None) -> torch.Tensor:
    """(n,) int32 uniform in [lo, hi) per env; ``lo``/``hi`` are ints or
    (n,) tensors. Where ``hi <= lo`` the draw is ``lo``, as
    ``jax.random.randint`` returns."""
    lo_t = torch.as_tensor(lo, device=device).to(torch.int64)
    hi_t = torch.as_tensor(hi, device=device).to(torch.int64)
    span = (hi_t - lo_t).clamp(min=1)
    u = torch.rand((n,), generator=generator, device=device,
                   dtype=torch.float64)
    off = torch.minimum((u * span).floor().to(torch.int64), span - 1)
    return (lo_t + off).to(torch.int32)


def permutations(generator: torch.Generator, n: int, k: int,
                 device=None) -> torch.Tensor:
    """(n, k) int64: a uniform random permutation of range(k) per env."""
    u = torch.rand((n, k), generator=generator, device=device,
                   dtype=torch.float64)
    return u.argsort(dim=1)


MASK32 = 0xFFFFFFFF
# odd multipliers below 2**31, so that every product of a 32-bit value
# stays inside int64 (the hash runs in int64 on both devices)
_M1, _M2 = 0x7FEB352D, 0x2C1B3C6D
_GOLDEN = 0x1E3779B9
_CELL = 0x2545F491


def mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finalizer (xorshift-multiply, as in Wellons'
    lowbias32) on int64 tensors holding values in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = (x * _M1) & MASK32
    x = x ^ (x >> 15)
    x = (x * _M2) & MASK32
    return x ^ (x >> 16)


def hash_scores(keys: torch.Tensor, salt: int, n: int) -> torch.Tensor:
    """(B, n) int64 scores in [0, 2**32) of ``n`` cells, a hash of each
    env's (B, 2) int32 key bits, ``salt`` and the cell: the draws of the
    DynamicObstacles moves, StochasticActionWrapper and the WFC solver,
    the same on the CPU and on the card."""
    k0 = keys[:, 0].to(torch.int64) & MASK32
    k1 = keys[:, 1].to(torch.int64) & MASK32
    h = mix32(k0 ^ mix32(k1 ^ (((salt + 1) * _GOLDEN) & MASK32)))
    cell = (torch.arange(1, n + 1, device=keys.device) * _CELL) & MASK32
    return mix32(h[:, None] ^ cell[None, :])


def take(table, idx) -> torch.Tensor:
    """``table[idx]`` for a host table (numpy or list) and a device index
    tensor: the table moves to the index's device first."""
    t = torch.as_tensor(np.asarray(table), device=idx.device)
    return t[idx.to(torch.int64)]
