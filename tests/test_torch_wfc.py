"""The port's WaveFunctionCollapse (minigrid_tpu_torch/envs/wfc) against the
JAX package's: the catalogs of all 22 presets, ``spiral_order``,
``propagate`` on seeded waves, ``_choose_location`` with exported noise, the
deterministic solves and ``largest_component`` bit for bit; the random
heuristics by consistency; ``WFCEnv`` by invariants and, against JAX's
``vmap(reset)``, by distribution; the graph transforms bit for bit; WFC
states stepped by the fused step's plain version against JAX's core step.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import minigrid_tpu
from minigrid_tpu.envs.wfc import graphtransforms as JGT
from minigrid_tpu.envs.wfc import solver as JS
from minigrid_tpu.envs.wfc import wfcenv as JW
from minigrid_tpu.envs.wfc.config import WFC_PRESETS_ALL as J_PRESETS

import minigrid_tpu_torch
from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.envs.base import random_keys
from minigrid_tpu_torch.envs.wfc import graphtransforms as GT
from minigrid_tpu_torch.envs.wfc import solver as S
from minigrid_tpu_torch.envs.wfc import wfcenv as W
from minigrid_tpu_torch.envs.wfc.config import WFC_PRESETS, WFC_PRESETS_ALL
from minigrid_tpu_torch.envs.wfc.wfcenv import WFCEnv

from tests.torch_port_utils import share_cpu  # noqa: F401
from tests.torch_port_utils import (CPU, check_fused_step_against_jax,
                                    export, reachable)

pytestmark = pytest.mark.usefixtures("share_cpu")

WFC_IDS = [f"MiniGrid-WFC-{n}-v0" for n in WFC_PRESETS]
SIZE, NB = 15, 64  # the env tests' grid size and batch


@functools.lru_cache(maxsize=None)
def catalog(preset: str):
    """(adj (4, P, P) bool, weights (P,) f64, periodic) of a preset, from
    the port's own catalog."""
    env = WFCEnv(wfc_config=preset, device=CPU)
    return env._adj, env._weights, env.config.output_periodic


def random_waves(P_, shape, n, seed, keep=(0.35, 0.6, 0.9)):
    """(n, P, H, W) bool waves: each pattern kept per cell with one of the
    ``keep`` rates (sparse waves contradict, dense ones do not)."""
    rng = np.random.default_rng(seed)
    rates = np.array(keep)[rng.integers(0, len(keep), n)]
    return rng.random((n, P_) + shape) < rates[:, None, None, None]


@pytest.mark.parametrize("preset", sorted(WFC_PRESETS_ALL))
def test_catalog_matches_jax(preset):
    """Patterns, weights, adjacency and the wall map of every preset."""
    p = WFCEnv(wfc_config=preset, device=CPU)
    j = JW.WFCEnv(wfc_config=J_PRESETS[preset])
    np.testing.assert_array_equal(p._patterns, np.asarray(j._patterns))
    np.testing.assert_array_equal(p._weights, np.asarray(j._weights))
    np.testing.assert_array_equal(p._adj, np.asarray(j._adj))
    np.testing.assert_array_equal(p._is_wall, np.asarray(j._is_wall))
    assert (dataclasses.asdict(p.config)
            == dataclasses.asdict(J_PRESETS[preset]))


@pytest.mark.parametrize("shape", [(1, 1), (4, 7), (12, 12), (23, 23)])
def test_spiral_order_matches_jax(shape):
    np.testing.assert_array_equal(S.spiral_order(shape),
                                  JS.spiral_order(shape))


@pytest.mark.parametrize("preset", ["MazeSimple", "DungeonMazeScaled",
                                    "ObstaclesAngular"])
def test_propagate_matches_jax(preset):
    """Seeded random waves to their fixpoint, periodic (DungeonMazeScaled,
    ObstaclesAngular) and not (MazeSimple), the contradiction flag
    included."""
    adj, _, periodic = catalog(preset)
    waves = random_waves(adj.shape[1], (9, 11), 24, seed=len(preset))
    want_w, want_c = jax.jit(jax.vmap(
        lambda w: JS.propagate(w, jnp.asarray(adj), periodic)))(
            jnp.asarray(waves))
    got_w, got_c = S.propagate(torch.from_numpy(waves), adj, periodic)
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    assert 0 < int(np.asarray(want_c).sum()) < len(waves)


@pytest.mark.parametrize("loc", S.LOC_HEURISTICS)
def test_choose_location_matches_jax(loc):
    """Every location heuristic on random waves with JAX's own noise
    (resolved cells in every wave, ties in counts)."""
    adj, _, _ = catalog("MazeSimple")
    shape = (8, 10)
    waves = random_waves(adj.shape[1], shape, 32, seed=7, keep=(0.1, 0.3))
    keys = jax.random.split(jax.random.PRNGKey(3), len(waves))
    noise = jax.vmap(lambda k: jax.random.uniform(k, shape) * 0.1)(keys)
    order = jnp.asarray(JS.spiral_order(shape), jnp.float32)
    want = jax.jit(jax.vmap(lambda w, n: JS._choose_location(
        w, loc, n, order)))(jnp.asarray(waves), noise)
    got = S._choose_location(
        torch.from_numpy(waves).permute(0, 2, 3, 1), loc,
        torch.from_numpy(np.array(noise)),
        torch.as_tensor(S.spiral_order(shape)).to(torch.float32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# the deterministic cases: (preset, location heuristic, shape); the last
# two contradict without backtracking and solve with it (undo and ban)
SOLVES = [(preset, loc, shape)
          for preset in ("MazeSimple", "DungeonMazeScaled")
          for loc in ("simple", "spiral", "lexical")
          for shape in ((8, 8), (12, 12))]
CONTRADICTING = [("Mazelike", "simple", (12, 12)),
                 ("RoomsMagicOffice", "spiral", (8, 8))]
OPTIONS = {"plain": {}, "backtracking": {"backtracking": True},
           "allpatterns": {"global_constraint": "allpatterns"},
           "backtracking+allpatterns": {"backtracking": True,
                                        "global_constraint": "allpatterns"}}


def jax_solve(preset, loc, shape, options):
    adj, w, periodic = catalog(preset)
    kw = dict(loc_heuristic=loc, choice_heuristic="lexical", **options)
    grid, ok = jax.jit(lambda k: JS.solve(
        k, jnp.asarray(adj), jnp.asarray(w), shape, periodic, **kw))(
            jax.random.PRNGKey(0))
    return np.asarray(grid), bool(ok)


@pytest.mark.parametrize("options", list(OPTIONS))
@pytest.mark.parametrize("preset,loc,shape", SOLVES + CONTRADICTING)
def test_deterministic_solves_match_jax(preset, loc, shape, options):
    """With a noise-free location heuristic and the lexical choice a solve
    draws nothing: the grid and ``ok`` equal JAX's bit for bit, periodic
    or not, with and without backtracking and ``allpatterns``."""
    adj, w, periodic = catalog(preset)
    grid, ok = jax_solve(preset, loc, shape, OPTIONS[options])
    keys = torch.zeros((2, 2), dtype=torch.int32)
    got, got_ok = S.solve(keys, adj, w, shape, periodic,
                          loc_heuristic=loc, choice_heuristic="lexical",
                          **OPTIONS[options])
    for b in range(2):
        np.testing.assert_array_equal(got[b].numpy(), grid)
        assert bool(got_ok[b]) == ok


@pytest.mark.parametrize("preset,loc,shape", CONTRADICTING)
def test_deterministic_contradiction_and_ban(preset, loc, shape):
    """The contradicting cases: JAX fails without backtracking and solves
    with it; the port's backtracking run collapses more often than the
    plain one (an undo and a ban happened)."""
    assert not jax_solve(preset, loc, shape, {})[1]
    assert jax_solve(preset, loc, shape, {"backtracking": True})[1]
    adj, w, periodic = catalog(preset)
    used = []
    for bt in (False, True):
        S.COUNTERS.reset()
        S.solve(torch.zeros((1, 2), dtype=torch.int32), adj, w, shape,
                periodic, loc_heuristic=loc, choice_heuristic="lexical",
                backtracking=bt)
        used.append(S.COUNTERS.collapses_max)
    assert used[1] > used[0]


def pattern_consistent(patterns, grid) -> bool:
    """Every pair of neighbouring cells of a (H, W) pattern grid agrees on
    its overlap (the solved layout's defining property)."""
    pats = patterns[grid]                                  # (H, W, n, n)
    right = (pats[:, :-1, :, 1:] == pats[:, 1:, :, :-1]).all()
    down = (pats[:-1, :, 1:, :] == pats[1:, :, :-1, :]).all()
    return bool(right and down)


@pytest.mark.parametrize("loc,choice", [
    ("entropy", "weighted"), ("anti-entropy", "weighted"),
    ("random", "random"), ("entropy", "random"), ("spiral", "weighted")])
def test_random_heuristics_solve_consistently(loc, choice):
    """Hash-drawn solves: every solved grid is pattern-consistent, most
    envs solve, and two keys give different layouts."""
    adj, w, periodic = catalog("MazeSimple")
    pats = WFCEnv(device=CPU)._patterns
    g = torch.Generator().manual_seed(1)
    grid, ok, _ = S.solve_with_retries(g, adj, w, (12, 12), periodic, 16, 8,
                                       loc_heuristic=loc,
                                       choice_heuristic=choice)
    assert bool(ok.all()), (loc, choice)
    for b in range(16):
        assert pattern_consistent(pats, grid[b].numpy())
    assert len({tuple(grid[b].flatten().tolist()) for b in range(16)}) > 8


@pytest.mark.parametrize("choice", ["rarest", "most common"])
def test_extreme_support_choices_solve(choice):
    """'rarest'/'most common' draw among whole-wave extremes (not the
    cell's own patterns); on JAX's unconstrained fixture they solve."""
    adj = np.ones((4, 3, 3), bool)
    g = torch.Generator().manual_seed(5)
    _, ok, _ = S.solve_with_retries(g, adj, np.ones(3), (6, 6), False, 4, 16,
                                    choice_heuristic=choice)
    assert bool(ok.all())


def test_solve_is_independent_of_schedule_and_batch(monkeypatch):
    """The same keys give the same grids whatever the tick period of the
    host sync and whichever envs share the batch; and the same keys give
    the same grids on every device (hash draws, no device RNG)."""
    adj, w, periodic = catalog("ObstaclesBlackdots")
    keys = torch.randint(-2**31, 2**31, (6, 2), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(2))
    kw = dict(loc_heuristic="entropy", choice_heuristic="weighted",
              backtracking=True)
    base, ok = S.solve(keys, adj, w, (10, 10), periodic, **kw)
    for period in (1, 5):
        monkeypatch.setattr(S, "SYNC_EVERY", period)
        got, got_ok = S.solve(keys, adj, w, (10, 10), periodic, **kw)
        assert torch.equal(got, base) and torch.equal(got_ok, ok)
    got, got_ok = S.solve(keys[3:5], adj, w, (10, 10), periodic, **kw)
    assert torch.equal(got, base[3:5]) and torch.equal(got_ok, ok[3:5])


def test_solve_with_retries_keeps_the_first_grid_when_all_fail():
    """An env whose attempts all fail keeps its first attempt's grid (JAX
    ``jnp.where(ok, g, grid)``), and its attempts count the bound."""
    adj, w, periodic = catalog("Skew2")
    kw = dict(loc_heuristic="anti-entropy")
    first_keys = random_keys(torch.Generator().manual_seed(0), (32, 2), CPU)
    first, first_ok = S.solve(first_keys, adj, w, (8, 8), periodic, **kw)
    grid, ok, attempts = S.solve_with_retries(
        torch.Generator().manual_seed(0), adj, w, (8, 8), periodic, 32, 2,
        **kw)
    failed = ~ok
    assert bool(failed.any())
    assert torch.equal(grid[failed], first[failed])
    assert (attempts[failed] == 2).all()
    assert torch.equal(grid[first_ok], first[first_ok])


def test_solve_with_stats(tmp_path):
    """The instrumented retry loop records per-attempt stats and the TSV
    log (reference control.py:262-284 / make_log_stats :45-61)."""
    adj, w, periodic = catalog("MazeSimple")
    log = tmp_path / "wfc_stats.tsv"
    grid, ok, stats = S.solve_with_stats(
        torch.Generator().manual_seed(2), adj, w, (8, 8), periodic, 16,
        log_path=str(log))
    assert ok and grid.shape == (8, 8)
    assert stats[-1]["success"] and all(s["time"] > 0 for s in stats)
    lines = log.read_text().strip().split("\n")
    assert lines[0] == "attempt\ttime\tsuccess"
    assert len(lines) == len(stats) + 1


def test_solver_rejects_unknown_options():
    adj, w, periodic = catalog("MazeSimple")
    keys = torch.zeros((1, 2), dtype=torch.int32)
    for kw in ({"loc_heuristic": "hilbert"},
               {"choice_heuristic": "least-common"},
               {"global_constraint": "nope"}):
        with pytest.raises(ValueError):
            S.solve(keys, adj, w, (4, 4), periodic, **kw)


@pytest.mark.parametrize("shape", [(7, 7), (13, 17)])
def test_largest_component_matches_jax(shape):
    """Random masks of several densities (ties between equal components
    included): the mask of the first largest label, bit for bit."""
    rng = np.random.default_rng(shape[1])
    rates = np.array([0.2, 0.45, 0.6, 0.8])[rng.integers(0, 4, 48)]
    masks = rng.random((48,) + shape) < rates[:, None, None]
    masks[0] = False                     # no empty cell at all
    want = jax.jit(jax.vmap(JW.largest_component))(jnp.asarray(masks))
    got = W.largest_component(torch.from_numpy(masks))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@functools.lru_cache(maxsize=None)
def jax_wfc_states(env_id: str, size: int = SIZE, n: int = NB):
    """(JAX env, a batch of ``n`` JAX resets of ``env_id``)."""
    env = minigrid_tpu.make(env_id, size=size)
    _, st = jax.jit(jax.vmap(env.reset))(
        jax.random.split(jax.random.PRNGKey(0), n))
    return env, st


def graph_layouts():
    """(B, W, H) type planes of JAX WFC layouts with the agent stamped,
    and the encoded grids."""
    _, st = jax_wfc_states("MiniGrid-WFC-MazeSimple-v0")
    grids = np.asarray(st.grid)[:8, ..., :3].copy()
    pos = np.asarray(st.agent_pos)[:8]
    for b, (x, y) in enumerate(pos):
        grids[b, x, y] = (C.AGENT, C.COLOR_TO_IDX["blue"], 0)
    return grids[..., 0], grids


def assert_tree_equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            assert_tree_equal(got[k], want[k])
        return
    if isinstance(want, tuple):
        for a, b in zip(got, want):
            assert_tree_equal(a, b)
        return
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fn", ["grid_adjacency", "layout_to_dense_graph",
                                "features_to_dense_graph", "get_edge_layers",
                                "graph_features_to_minigrid",
                                "dense_graph_to_minigrid",
                                "minigrid_to_bitmap"])
def test_graph_transforms_match_jax(fn):
    layouts, grids = graph_layouts()
    shape = layouts.shape[1:]
    inner = (shape[0] - 2, shape[1] - 2)
    j_feats, _ = JGT.minigrid_layout_to_dense_graph(layouts)
    p_feats, _ = GT.minigrid_layout_to_dense_graph(torch.from_numpy(layouts))
    partial = {k: v for k, v in j_feats.items()
               if k in ("navigable", "goal", "start")}
    if fn == "grid_adjacency":
        got, want = GT.grid_adjacency(inner), JGT.grid_adjacency(inner)
    elif fn == "layout_to_dense_graph":
        got = GT.minigrid_layout_to_dense_graph(
            torch.from_numpy(layouts), edge_config=GT.EDGE_CONFIG)
        want = JGT.minigrid_layout_to_dense_graph(
            layouts, edge_config=JGT.EDGE_CONFIG)
    elif fn == "features_to_dense_graph":
        got = GT.features_to_dense_graph(p_feats, inner, GT.EDGE_CONFIG)
        want = JGT.features_to_dense_graph(j_feats, inner, JGT.EDGE_CONFIG)
    elif fn == "get_edge_layers":
        cfg = {"nav": GT.EdgeDescriptor(("navigable", "goal"), "grid"),
               "sg": GT.EdgeDescriptor(("start", "goal")),
               "missing": GT.EdgeDescriptor(("lava_x",))}
        jcfg = {"nav": JGT.EdgeDescriptor(("navigable", "goal"), "grid"),
                "sg": JGT.EdgeDescriptor(("start", "goal")),
                "missing": JGT.EdgeDescriptor(("lava_x",))}
        got = GT.get_edge_layers(p_feats, cfg, inner)
        want = JGT.get_edge_layers(j_feats, jcfg, inner)
    elif fn == "graph_features_to_minigrid":
        # without a wall plane, non-navigable cells become walls
        got = GT.graph_features_to_minigrid(
            {k: torch.from_numpy(np.array(v)) for k, v in partial.items()},
            shape)
        want = JGT.graph_features_to_minigrid(partial, shape)
    elif fn == "dense_graph_to_minigrid":
        got = GT.dense_graph_to_minigrid(p_feats, shape)
        want = JGT.dense_graph_to_minigrid(j_feats, shape)
        np.testing.assert_array_equal(got[..., 0].numpy(), layouts)
    else:
        got = GT.minigrid_to_bitmap(torch.from_numpy(grids))
        want = JGT.minigrid_to_bitmap(grids)
    assert_tree_equal(got, want)


def check_layouts(env, st, pat_grid, ok):
    """The pool invariants: the wall ring, one goal, the agent on an empty
    cell apart from the goal, the goal reachable; the walls those of the
    pattern grid (plus the cells outside the largest component), every pair
    of neighbouring pattern cells allowed by ``adj`` where ``ok``."""
    grids = st.grid.numpy()
    pos = st.agent_pos.numpy()
    is_wall = env._is_wall[pat_grid.numpy()]           # (B, H-2, W-2)
    for b in range(len(grids)):
        t = grids[b][..., 0]
        assert (t[0, :] == C.WALL).all() and (t[-1, :] == C.WALL).all()
        assert (t[:, 0] == C.WALL).all() and (t[:, -1] == C.WALL).all()
        assert (t == C.GOAL).sum() == 1
        assert t[pos[b, 0], pos[b, 1]] == C.EMPTY
        seen = reachable(grids[b], pos[b], (C.EMPTY, C.GOAL))
        assert seen[t == C.GOAL].all(), b
        inner = t[1:-1, 1:-1].T                         # [row, col]
        assert ((inner == C.WALL) >= is_wall[b]).all()
        if bool(ok[b]):
            pg = pat_grid[b].numpy()
            adj = env._adj
            assert adj[3][pg[:, :-1], pg[:, 1:]].all()   # right
            assert adj[1][pg[:-1, :], pg[1:, :]].all()   # down


@pytest.mark.parametrize("env_id", WFC_IDS)
def test_wfc_env_invariants(env_id):
    env = minigrid_tpu_torch.make(env_id, device=CPU, size=SIZE)
    g = env.generator(0)
    pat, ok, attempts = env.solve(g, NB)
    st = env.layout(g, pat)
    check_layouts(env, st, pat, ok)
    assert int(ok.sum()) >= NB - 2 and int(attempts.min()) >= 1
    assert env.mission_text(st) == "traverse the maze to get to the goal"
    assert env.params.max_steps == 20 * SIZE


@pytest.mark.parametrize("env_id", ["MiniGrid-WFC-MazeSimple-v0",
                                    "MiniGrid-WFC-DungeonMazeScaled-v0"])
def test_wfc_env_distribution_matches_jax(env_id):
    """Mean wall share and largest-component size of B=64 layouts within
    4 standard errors of JAX's ``vmap(reset)`` at size 15."""
    _, jst = jax_wfc_states(env_id)
    env = minigrid_tpu_torch.make(env_id, device=CPU, size=SIZE)
    _, pst = env.reset(env.generator(0), NB)

    def stats(grids):
        inner = grids[:, 1:-1, 1:-1, 0]
        walls = (inner == C.WALL).mean((1, 2))
        free = (inner != C.WALL).sum((1, 2))
        return walls, free

    for a, b in zip(stats(np.asarray(jst.grid)), stats(pst.grid.numpy())):
        se = np.sqrt(a.var(ddof=1) / len(a) + b.var(ddof=1) / len(b))
        assert abs(a.mean() - b.mean()) < 4 * se + 1e-9, (a.mean(), b.mean())


def test_wfc_states_step_like_jax():
    """WFC layouts (JAX's) through the port's fused step (plain version)
    against JAX's core step: no step hooks, the 25x25-type shape."""
    env_id = "MiniGrid-WFC-MazeSimple-v0"
    jenv, jst = jax_wfc_states(env_id)
    jenv = jenv.packed()
    jst = jst.replace(step_count=jnp.full_like(jst.step_count,
                                               jenv.params.max_steps - 8))
    check_fused_step_against_jax(env_id, jenv, jst, "uniform", T=16, B=NB)
    p = minigrid_tpu_torch.make(env_id, device=CPU)
    from minigrid_tpu_torch.ops.fused_step import has_step_hooks
    assert not has_step_hooks(p)
    assert export(jst).grid.shape == (NB, SIZE, SIZE, 5)


def test_wfc_counters_count_the_syncs():
    """The solver's counters: syncs, ticks, collapses and passes of the
    longest env, attempts, envs not ok."""
    env = minigrid_tpu_torch.make("MiniGrid-WFC-ObstaclesBlackdots-v0",
                                  device=CPU, size=12)
    S.COUNTERS.reset()
    _, ok, attempts = env.solve(env.generator(3), 8)
    c = S.COUNTERS
    assert c.host_syncs >= c.ticks // S.SYNC_EVERY + 2
    assert 0 < c.collapses_max <= c.passes_max <= c.ticks
    assert c.attempts_max == int(attempts.max())
    assert c.not_ok == int((~ok).sum())
