"""Occlusion / field-of-view, batched.

Counterpart of ``minigrid_tpu/core/visibility.py``: the reference's two-pass
sweep (``minigrid/core/grid.py:291-328``) with each view row packed into the
low bits of one int32 (int64 for views wider than 31, whose rows take 33-63
bits; the JAX package packs into int32 at every size and overflows there), so
a row pass is Kogge-Stone carry propagation (log2(V) shift-and-or steps) and
only the V-row bottom-to-top recurrence is sequential. Every operand is a
(B,) integer tensor. The CUDA kernel (``csrc/fused_step.cu``) runs the same
recurrence per thread on 32- or 64-bit rows.
"""

from __future__ import annotations

import torch


def _row_pass_bits(seed, t, V: int, full: int):
    """One row's two sweeps on bit-packed masks.

    seed: bit x set = cell x seeded visible before the passes.
    t:    bit x set = cell x transparent (``see_behind``).
    Returns (row visibility mask, seeds for the row above), both packed.
    """
    # pass 1, ascending x: m[i] = seed[i] | (m[i-1] & t[i-1])
    m = seed
    T = (t << 1) & full
    shift = 1
    while shift < V:
        m = m | ((m << shift) & T)
        T = T & ((T << shift) & full)
        shift *= 2
    m1 = m
    # pass 2, descending x: m[i] |= m[i+1] & t[i+1]
    U = t >> 1
    shift = 1
    while shift < V:
        m = m | ((m >> shift) & U)
        U = U & (U >> shift)
        shift *= 2
    m2 = m
    # seeds for the row above: a visited transparent cell marks the cell
    # above it and that cell's left/right neighbour
    e = m1 & t & (full >> 1)
    up1 = e | ((e << 1) & full)
    f = m2 & t & (full ^ 1)
    up2 = f | (f >> 1)
    return m2, up1 | up2


def process_vis(transparent: torch.Tensor, agent_x: int) -> torch.Tensor:
    """Visibility masks for view grids already in the agent frame.

    transparent: (B, V, V) bool, indexed [b, x, y]; the agent sits at
    (agent_x, V-1) looking towards y=0. Returns (B, V, V) bool.
    """
    V = transparent.shape[-1]
    full = (1 << V) - 1
    dt = torch.int32 if V <= 31 else torch.int64
    bits = torch.arange(V, device=transparent.device, dtype=dt)
    # row j packed: bit x = transparent[x, j]
    tcols = (transparent.to(dt) << bits[:, None]).sum(-2)  # (B, V)
    seed = torch.full_like(tcols[:, 0], 1 << agent_x)
    rows = [None] * V
    for j in range(V - 1, -1, -1):
        rows[j], seed = _row_pass_bits(seed, tcols[:, j], V, full)
    packed = torch.stack(rows, dim=-1)                               # (B, V)
    return ((packed[:, None, :] >> bits[:, None]) & 1).to(torch.bool)
