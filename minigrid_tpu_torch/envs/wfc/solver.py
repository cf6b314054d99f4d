"""Batched Wave Function Collapse solver.

Counterpart of ``minigrid_tpu/envs/wfc/solver.py`` (reference
``minigrid/envs/wfc/wfclogic/solver.py``), over B envs at once. The wave of
each env is a (P, H, W) bool array in the JAX package; here the batch's
waves are one (B, H, W, P) bool tensor, patterns last, so that each
direction's support product is one matrix product of the (B*H*W, P) wave by
the (P, P) adjacency. The same options are taken: the 6 location and 5
choice heuristics, ``backtracking`` and ``global_constraint="allpatterns"``,
with JAX's semantics (see the JAX module's docstring).

JAX runs an attempt as a ``lax.while_loop`` of collapses, each with a
``lax.while_loop`` propagation fixpoint inside, and freezes an env that
has finished under ``vmap`` while the others run on. Here the batch runs in
ticks, each env in a phase of its own (:data:`READY`, :data:`COLLAPSE`, the
three propagations, :data:`DONE`): every tick runs the entry checks of the
envs that are ready, the collapse of the envs whose wave is at its fixpoint
and one propagation pass of the envs propagating, all masked, so a tick
needs no host sync. Whether any env still runs is read once every
:data:`SYNC_EVERY` ticks (one counted host sync); a finished env does not
move, so the answer is the same for any period. On the card one tick is
captured as a CUDA graph and replayed, one launch a tick. The propagation
pass keeps JAX's order of the four directions, each on the wave the one
before left.

Randomness: an attempt takes one (B, 2) int32 key per env. The tie-break
noise of the location heuristics and the pattern draw of each collapse are
integer hashes of the key (``envs/common.py::hash_scores``), of
the cell and of the env's collapse count, so the same keys give the same
layouts on the CPU and on the card, whatever the schedule. The draws'
distributions, not JAX's threefry streams, are what match JAX.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from minigrid_tpu_torch.envs.base import random_keys
from minigrid_tpu_torch.envs.common import hash_scores
from minigrid_tpu_torch.envs.wfc.patterns import DIRECTIONS

LOC_HEURISTICS = ("lexical", "entropy", "anti-entropy", "simple", "random",
                  "spiral")
CHOICE_HEURISTICS = ("lexical", "weighted", "random", "rarest", "most common")

RUN, SOLVED, CONTRA = 0, 1, 2  # an attempt's status (JAX's values)
# the phase of an env in the batched loop
READY, COLLAPSE, PROP_INIT, PROP_TOP, PROP_INNER, DONE = range(6)
SYNC_EVERY = 16  # ticks between two reads of "any env still running"
GRAPH_WARMUP = 3  # eager ticks on the card before one is captured
NOISE_SALT, PATTERN_SALT = 0x51, 0x52  # hash salts of the two draws


@dataclasses.dataclass
class SolveCounters:
    """What the solver did since the last :meth:`reset`: host syncs (one
    per :data:`SYNC_EVERY` ticks of an attempt, one per retry round, one per
    fixpoint test of :func:`propagate`), ticks, the most collapses and
    propagation passes any env used in one attempt, the most attempts any
    env took, and the envs left without a solved layout."""

    host_syncs: int = 0
    ticks: int = 0
    collapses_max: int = 0
    passes_max: int = 0
    attempts_max: int = 0
    not_ok: int = 0

    def reset(self):
        self.host_syncs = self.ticks = 0
        self.collapses_max = self.passes_max = 0
        self.attempts_max = self.not_ok = 0


COUNTERS = SolveCounters()


# The support product's operand type. Its operands are 0/1 and its sums at
# most P (229 for the largest preset), and only whether a sum is 0 is read,
# so any type holding 0 and 1 exactly gives the same bits as JAX's f32.
# bf16 takes half the bytes of f32 and the card's tensor cores (cuBLAS
# accumulates in f32, and a positive sum never rounds to 0); on the CPU its
# products are no slower than f32's. ``chip_smoke.py`` times both on the card.
PRODUCT_DTYPE = torch.bfloat16


def _catalog(adj, weights, device):
    """(adj (4, P, P) bool, the support product's operands: adj transposed
    and the out-of-range support (4, P) in the product type, both padded
    with zeros to a multiple of 8 patterns, weights (P,) f64) on
    ``device``. The padding aligns each row of the product's operands to
    16 bytes; padded patterns support nothing and are never possible."""
    adj = torch.as_tensor(np.asarray(adj), device=device).to(torch.bool)
    P = adj.shape[1]
    pad = -P % 8
    adj_t = torch.nn.functional.pad(adj.transpose(1, 2).to(PRODUCT_DTYPE),
                                    (0, pad, 0, pad))
    edge = torch.nn.functional.pad(adj.any(2).to(PRODUCT_DTYPE), (0, pad))
    weights = torch.as_tensor(np.asarray(weights), device=device).to(
        torch.float64)
    return adj, adj_t.contiguous(), edge, weights


def _border_slices(dy, dx):
    """The border cells of the shift of direction (dy, dx), whose neighbour
    lies outside the grid, and where that neighbour is were the grid
    periodic (``S[i] = s[i + k]`` along the direction's axis)."""
    ax = (slice(None),) * (1 if dy else 2)
    first, last = ax + (slice(0, 1),), ax + (slice(-1, None),)
    return (first, last) if (dy or dx) < 0 else (last, first)


def _pass(wave, adj_t, edge, periodic):
    """One propagation pass of JAX's body: the four directions in order,
    each on the wave the one before left. Direction ``d`` keeps, at cell
    (i, j), the patterns that have a neighbour pattern at (i + dy, j + dx)
    that ``adj[d]`` allows (the support product, then the shift); out of
    range (not periodic) the neighbour is every pattern, as JAX's
    True-padded shift gives (``edge[d]``: any pattern allowed at all).

    The pass runs on the wave as 0/1 in the product type, padded to the
    operands' width: "possible and supported" is the minimum of the 0/1
    wave and the support count, one operation of one type. The shift is
    one contiguous minimum over the whole batch, offset by the neighbour's
    distance in memory; the cells it pairs across a row's or an env's end
    are the border cells, which a second minimum then writes."""
    B, H, W, P = wave.shape
    Pp = adj_t.shape[-1]
    x = torch.zeros((B, H, W, Pp), dtype=adj_t.dtype, device=wave.device)
    x[..., :P] = wave
    n = x.numel()
    for d, (dy, dx) in enumerate(DIRECTIONS):
        s = torch.matmul(x.view(-1, Pp), adj_t[d]).view(x.shape)
        out = torch.empty_like(x)
        step = (W * Pp if dy else Pp)
        xf, sf, of = x.view(-1), s.view(-1), out.view(-1)
        if (dy or dx) > 0:
            torch.minimum(xf[:n - step], sf[step:], out=of[:n - step])
        else:
            torch.minimum(xf[step:], sf[:n - step], out=of[step:])
        dst, src = _border_slices(dy, dx)
        torch.minimum(x[dst], s[src] if periodic else edge[d], out=out[dst])
        x = out
    return x[..., :P] > 0


def propagate(wave, adj, periodic: bool):
    """Fixpoint constraint propagation of a batch of waves (B, P, H, W)
    bool (JAX's layout with a batch axis), ``adj`` (4, P, P) bool. Returns
    (wave (B, P, H, W), contradiction (B,)). The fixpoint is tested every
    :data:`SYNC_EVERY` passes (passes at the fixpoint change nothing)."""
    _, adj_t, edge, _ = _catalog(adj, np.ones(1), wave.device)
    w = wave.permute(0, 2, 3, 1).contiguous()
    while True:
        before = w
        for _ in range(SYNC_EVERY):
            w = _pass(w, adj_t, edge, periodic)
        COUNTERS.host_syncs += 1
        if torch.equal(w, before):
            break
    contradiction = (~w.any(-1)).flatten(1).any(1)
    return w.permute(0, 3, 1, 2).contiguous(), contradiction


def spiral_order(shape: tuple[int, int]) -> np.ndarray:
    """(H, W) float in [0, 1): visit order of the reference spiral walk
    from the center (solver.py:213-245 spiral_transforms/spiral_coords +
    fill_with_curve :238-254), computed host-side once per config."""
    H, W = shape
    order = np.zeros((H, W), np.float64)
    x, y = H // 2, W // 2
    fill, total = 0, H * W

    def put(x, y):
        nonlocal fill
        if 0 <= x < H and 0 <= y < W and fill < total:
            order[x, y] = fill / total
            fill += 1

    put(x, y)
    N = 1
    # generous bound: the spiral covers any cell within max(H, W) rings
    while fill < total and N < 2 * max(H, W) + 4:
        if N % 2 == 0:
            moves = [(0, 1)] + [(1, 0)] * N + [(0, -1)] * N
        else:
            moves = [(0, -1)] + [(-1, 0)] * N + [(0, 1)] * N
        for dx, dy in moves:
            x += dx
            y += dy
            put(x, y)
        N += 1
    return order


def _choose_location(wave, loc_heuristic: str, noise, loc_order, counts=None):
    """The location each env collapses: (B,) int64 flat index into (H, W).
    ``wave`` (B, H, W, P) bool, ``noise`` (B, H, W) f32, ``loc_order`` (H,
    W) f32 (spiral only). Each heuristic is JAX's argmin/argmax of a
    per-cell score with the resolved cells masked; both libraries return
    the first extreme index."""
    if counts is None:
        counts = wave.sum(-1)
    unresolved = counts > 1
    inf = float("inf")
    B = wave.shape[0]
    if loc_heuristic == "entropy":
        score = torch.where(unresolved, noise + counts, inf)
        return score.reshape(B, -1).argmin(1)
    if loc_heuristic == "anti-entropy":
        score = torch.where(unresolved, noise + counts, -inf)
        return score.reshape(B, -1).argmax(1)
    if loc_heuristic == "simple":
        score = torch.where(unresolved, counts.to(torch.float32), inf)
        return score.reshape(B, -1).argmin(1)
    if loc_heuristic == "random":
        score = torch.where(unresolved, noise, inf)
        return score.reshape(B, -1).argmin(1)
    if loc_heuristic == "lexical":
        score = torch.where(unresolved, 1.0, inf)
        return score.reshape(B, -1).argmin(1)
    if loc_heuristic == "spiral":
        score = torch.where(unresolved, loc_order, inf)
        return score.reshape(B, -1).argmin(1)
    raise ValueError(
        f"unknown loc_heuristic {loc_heuristic!r}; supported: {LOC_HEURISTICS}"
    )


def _draw(u, weights):
    """(B,) int64: index i with probability ``weights[b, i] / sum`` by the
    inverse CDF at ``u`` (B,) f64 in [0, 1); integer weights sum exactly in
    f64, so both devices pick the same index."""
    c = weights.cumsum(1)
    t = u * c[:, -1]
    return (c <= t[:, None]).sum(1).clamp(max=weights.shape[1] - 1)


def _choose_pattern(u, cell, wave, weights, choice_heuristic: str):
    """The pattern each env collapses to, (B,) int64. ``u`` (B,) f64 in
    [0, 1) is the env's draw for this collapse, ``cell`` (B, P) the chosen
    cell's possibilities."""
    if choice_heuristic == "weighted":
        return _draw(u, torch.where(cell, weights, 0.0))
    if choice_heuristic == "random":
        return _draw(u, cell.to(torch.float64))
    if choice_heuristic == "lexical":
        return cell.to(torch.uint8).argmax(1)
    if choice_heuristic in ("rarest", "most common"):
        # uniform among the patterns of extreme whole-wave support, not
        # restricted to the cell (JAX solver.py:150-166): the most supported
        # for "rarest", the least for "most common", as the reference does
        sums = wave.sum((1, 2))
        ext = (sums.amax(1, keepdim=True) if choice_heuristic == "rarest"
               else sums.amin(1, keepdim=True))
        return _draw(u, (sums == ext).to(torch.float64))
    raise ValueError(
        f"unknown choice_heuristic {choice_heuristic!r}; "
        f"supported: {CHOICE_HEURISTICS}"
    )


def _check_options(loc_heuristic, choice_heuristic, global_constraint):
    if loc_heuristic not in LOC_HEURISTICS:
        raise ValueError(f"unknown loc_heuristic {loc_heuristic!r}; "
                         f"supported: {LOC_HEURISTICS}")
    if choice_heuristic not in CHOICE_HEURISTICS:
        raise ValueError(f"unknown choice_heuristic {choice_heuristic!r}; "
                         f"supported: {CHOICE_HEURISTICS}")
    if global_constraint not in (None, "allpatterns"):
        raise ValueError(f"unknown global_constraint {global_constraint!r}")


def attempt_noise(keys, out_shape, noise_scale=0.1):
    """(B, H, W) f32 tie-break noise of an attempt: uniform [0, 1) (24-bit
    hashes of the key and the cell) times ``noise_scale``."""
    H, W = out_shape
    bits = hash_scores(keys, NOISE_SALT, H * W) >> 8
    u = bits.to(torch.float32) * (2.0 ** -24)
    scale = torch.tensor(noise_scale, dtype=torch.float32, device=keys.device)
    return (u * scale).reshape(-1, H, W)


def solve(keys, adj, weights, out_shape, periodic: bool,
          loc_heuristic: str = "entropy", choice_heuristic: str = "weighted",
          backtracking: bool = False, global_constraint: str | None = None,
          noise_scale=0.1):
    """One WFC attempt for each of B envs, ``keys`` (B, 2) int32 on the
    device to run on. Returns (pattern index grids (B, H, W) int64, ok
    (B,) bool).

    An env whose status left RUN, or whose collapse count reached
    ``max_iters``, keeps its wave; on the exit paths the wave is the one its
    last body entered with, and the grid is the wave's first maximal
    pattern per cell (JAX's ``wave.argmax(0)``)."""
    _check_options(loc_heuristic, choice_heuristic, global_constraint)
    dev = keys.device
    B = keys.shape[0]
    H, W = out_shape
    adj, adj_t, edge, weights = _catalog(adj, weights, dev)
    P = adj.shape[1]
    noise = attempt_noise(keys, out_shape, noise_scale)
    loc_order = (torch.as_tensor(spiral_order(out_shape), device=dev).to(
        torch.float32) if loc_heuristic == "spiral" else None)
    # a backtracking run can revisit cells after undos; bound generously
    max_iters = (4 if backtracking else 1) * (H * W + 1)
    draws = hash_scores(keys, PATTERN_SALT, max_iters).to(torch.float64) * (
        2.0 ** -32)
    allpatterns = global_constraint == "allpatterns"
    env = torch.arange(B, device=dev)
    pat_ids = torch.arange(P, device=dev)

    # the batch's state, in buffers the ticks update in place (so that on
    # the card one tick is captured once as a CUDA graph and replayed); a
    # wave's cell counts are carried with it
    S = {"wave": torch.ones((B, H, W, P), dtype=torch.bool, device=dev),
         "counts": torch.full((B, H, W), P, dtype=torch.int32, device=dev),
         # without backtracking the loop body relies on a fixpoint wave, so
         # the first propagation runs before it (JAX solver.py:262-266)
         "mode": torch.full((B,), READY if backtracking else PROP_INIT,
                            dtype=torch.int8, device=dev),
         "status": torch.full((B,), RUN, dtype=torch.int8, device=dev)}
    S["entry"] = torch.ones_like(S["wave"])
    S["entry_counts"] = S["counts"].clone()
    for k in ("it", "passes", "loc", "pat"):
        S[k] = torch.zeros((B,), dtype=torch.int64, device=dev)

    def at(m, x):
        return m.reshape((-1,) + (1,) * (x.ndim - 1))

    def at_cell(loc):
        """(B, H*W) bool: True at cell ``loc`` of each env."""
        return torch.arange(H * W, device=dev) == loc[:, None]

    def tick():
        wave, counts, mode, status, it = (S["wave"], S["counts"], S["mode"],
                                          S["status"], S["it"])
        # the entry checks of the body (JAX solver.py:200-207)
        ready = mode == READY
        stop = ready & (it >= max_iters)
        go = ready & ~stop
        solved = (counts == 1).flatten(1).all(1)
        fin = go & solved
        if allpatterns:
            fin = fin | (go & ~wave.flatten(1, 2).any(1).all(1))
        status = torch.where(fin, torch.where(solved, SOLVED, CONTRA),
                             status).to(torch.int8)
        it = it + fin
        cont = go & ~fin
        torch.where(at(cont, wave), wave, S["entry"], out=S["entry"])
        torch.where(at(cont, counts), counts, S["entry_counts"],
                    out=S["entry_counts"])
        mode = torch.where(stop | fin, DONE, torch.where(
            cont, PROP_TOP if backtracking else COLLAPSE, mode)).to(
                torch.int8)
        # observe and collapse the envs at a fixpoint (:209-222)
        col = mode == COLLAPSE
        new_loc = _choose_location(wave, loc_heuristic, noise, loc_order,
                                   counts)
        u = draws.gather(1, it.clamp(max=max_iters - 1)[:, None])[:, 0]
        cells = wave.view(B, H * W, P)
        new_pat = _choose_pattern(u, cells[env, new_loc], wave, weights,
                                  choice_heuristic)
        loc = torch.where(col, new_loc, S["loc"])
        pat = torch.where(col, new_pat, S["pat"])
        cells[env, loc] = torch.where(col[:, None],
                                      pat_ids == pat[:, None], cells[env, loc])
        counts = torch.where(col[:, None, None] & at_cell(loc).view(B, H, W),
                             1, counts)
        mode = torch.where(col, PROP_INNER, mode).to(torch.int8)
        # one propagation pass of the propagating envs. Without backtracking
        # every other env's wave is at its fixpoint, which a pass leaves as
        # it is, so the pass runs on the whole batch unmasked
        prop = (mode == PROP_INIT) | (mode == PROP_TOP) | (mode == PROP_INNER)
        new = _pass(wave, adj_t, edge, periodic)
        if backtracking:
            new = torch.where(at(prop, wave), new, wave)
        # a pass only removes patterns: it changed the wave iff the totals
        # differ
        new_counts = new.sum(-1, dtype=torch.int32)
        changed = new_counts.sum((1, 2)) != counts.sum((1, 2))
        contra = (new_counts == 0).flatten(1).any(1)
        # a contradiction inside the body ends its propagation at once: its
        # outcome does not depend on the rest of the fixpoint (the first
        # propagation's wave is kept when it contradicts, so it runs on)
        end = prop & (~changed | (contra & (mode != PROP_INIT)))
        init_end = end & (mode == PROP_INIT)
        top_end = end & (mode == PROP_TOP)
        inner_end = end & (mode == PROP_INNER)
        fatal = (init_end | top_end | (inner_end if not backtracking
                                       else torch.zeros_like(end))) & contra
        # the exit paths keep the body's entry wave (:248-253); with
        # backtracking, an inner contradiction restores it and bans the
        # tried pattern at the chosen cell (:238-242)
        restore = fatal & ~init_end
        if backtracking:
            ban = inner_end & contra
            tried = at_cell(loc).view(B, H, W, 1) & (
                pat_ids == pat[:, None])[:, None, None]
            new = torch.where(at(ban, new), S["entry"] & ~tried, new)
            banned = S["entry_counts"] - (
                at_cell(loc) & S["entry"].view(B, H * W, P)[env, loc, pat][
                    :, None]).view(B, H, W).to(torch.int32)
            new_counts = torch.where(at(ban, new_counts), banned, new_counts)
        torch.where(at(restore, new), S["entry"], new, out=S["wave"])
        torch.where(at(restore, new_counts), S["entry_counts"], new_counts,
                    out=S["counts"])
        S["status"].copy_(torch.where(fatal, CONTRA, status))
        S["it"].copy_(it + (top_end & contra) + inner_end)
        S["passes"].add_(prop)
        S["mode"].copy_(torch.where(fatal, DONE, torch.where(
            top_end, COLLAPSE, torch.where(init_end | inner_end, READY,
                                           mode))))
        S["loc"].copy_(loc)
        S["pat"].copy_(pat)

    n = 0
    run = tick
    if dev.type == "cuda":
        # warm-up ticks on a side stream, then one tick captured (capturing
        # runs nothing) and replayed: one launch a tick
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(GRAPH_WARMUP):
                tick()
                n += 1
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            tick()
        run = graph.replay
    while True:
        run()
        n += 1
        if n % SYNC_EVERY == 0:
            COUNTERS.host_syncs += 1
            if not bool((S["mode"] != DONE).any()):
                break
    most = torch.stack([S["it"].max(), S["passes"].max()]).tolist()
    COUNTERS.host_syncs += 1
    COUNTERS.ticks += n
    COUNTERS.collapses_max = max(COUNTERS.collapses_max, most[0])
    COUNTERS.passes_max = max(COUNTERS.passes_max, most[1])
    grid = S["wave"].to(torch.uint8).argmax(-1)
    return grid, S["status"] == SOLVED


def solve_with_retries(generator: torch.Generator, adj, weights, out_shape,
                       periodic: bool, num_envs: int, max_attempts: int = 64,
                       **options):
    """Attempts with fresh keys until consistent (wfclogic/control.py
    :231-295), for ``num_envs`` envs on the generator's device: the first
    attempt for every env, then one round of attempts for the envs not yet
    ok (one fresh key each from ``generator``, one counted host sync a
    round), ``max_attempts`` in all. An env whose attempts all fail keeps
    its first attempt's grid, as JAX's ``jnp.where(ok, g, grid)`` does
    (solver.py:318-327). Returns (grids (B, H, W) int64, ok (B,) bool,
    attempts (B,) int64)."""
    dev = generator.device
    keys = random_keys(generator, (num_envs, 2), dev)
    grid, ok = solve(keys, adj, weights, out_shape, periodic, **options)
    attempts = torch.ones((num_envs,), dtype=torch.int64, device=dev)
    for _ in range(max_attempts - 1):
        COUNTERS.host_syncs += 1
        idx = (~ok).nonzero()[:, 0]
        if idx.numel() == 0:
            break
        keys = random_keys(generator, (idx.numel(), 2), dev)
        g, ok_n = solve(keys, adj, weights, out_shape, periodic, **options)
        grid[idx] = torch.where(ok_n[:, None, None], g, grid[idx])
        ok[idx] = ok_n
        attempts[idx] += 1
    most, failed = torch.stack([attempts.max(), (~ok).sum()]).tolist()
    COUNTERS.host_syncs += 1
    COUNTERS.attempts_max = max(COUNTERS.attempts_max, most)
    COUNTERS.not_ok += failed
    return grid, ok, attempts


def solve_with_stats(generator: torch.Generator, adj, weights, out_shape,
                     periodic: bool, max_attempts: int = 64,
                     log_path: str | None = None, **options):
    """Host-side retry loop for one env recording per-attempt timings and
    outcomes, the analog of the reference's stats dict
    (wfclogic/control.py:262-284) and TSV logger (make_log_stats, :45-61).
    Each attempt draws its key from ``generator`` and runs on its device;
    on the card the clock is read after a synchronisation.

    Returns (pattern grid (H, W), ok, stats) where stats is a list of
    {"attempt", "time", "success"} dicts."""
    dev = generator.device
    stats = []
    grid, ok = None, False
    for n in range(max_attempts):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        g, ok_a = solve(random_keys(generator, (1, 2), dev), adj, weights,
                        out_shape, periodic, **options)
        grid, ok = g[0], bool(ok_a[0])
        stats.append({
            "attempt": n,
            "time": time.perf_counter() - t0,
            "success": ok,
        })
        if ok:
            break
    if log_path is not None:
        with open(log_path, "w") as f:
            f.write("attempt\ttime\tsuccess\n")
            for s in stats:
                f.write(f"{s['attempt']}\t{s['time']:.6f}\t{s['success']}\n")
    return grid, ok, stats
