"""Shared cells, colours and batched draws for the environment generators.

Counterpart of ``minigrid_tpu/envs/common.py``. A generator here builds B
layouts at once, so a cell may differ per env: :func:`cells` stacks (B,)
channel values into a (B, 5) uint8 cell that ``core/grid.py``'s writers
take. JAX draws with per-env bounds (``randint(key, (), lo, hi)`` under
``vmap``) and per-env permutations; ``torch.randint`` takes scalar bounds
only, so :func:`randint` draws ``lo + floor(u * (hi - lo))`` per env and
:func:`permutations` ranks uniform scores.
"""

from __future__ import annotations

import numpy as np
import torch

from minigrid_tpu_torch.core import constants as C

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
    (B,) tensor (JAX ``pack_cell`` under ``vmap``)."""
    chans = [torch.as_tensor(v, device=device).to(torch.int64)
             for v in (type_idx, color, state, cont_type, cont_color)]
    shape = torch.broadcast_shapes(*(c.shape for c in chans))
    if not shape:
        shape = (1,)
    return torch.stack([c.expand(shape) for c in chans], dim=-1).to(
        torch.uint8)


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


def take(table, idx) -> torch.Tensor:
    """``table[idx]`` for a host table (numpy or list) and a device index
    tensor: the table moves to the index's device first."""
    t = torch.as_tensor(np.asarray(table), device=idx.device)
    return t[idx.to(torch.int64)]
