"""The port's core-dynamics families (FourRooms, LavaGap, DistShift,
Crossing, LockedRoom, Playground, MultiRoom) against the JAX package: each
generator's layouts by invariants and by chi-square against
``jax.vmap(env._gen_grid)`` draws (p > 1e-3; the two RNGs cannot replay
each other; DistShift's fixed layout exactly), and the port's plain fused
step bit-exact against JAX's core transition on exported states, with the
uniform and the interaction-biased action streams."""

from __future__ import annotations

import numpy as np
import pytest

import minigrid_tpu_torch
from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core.mission import tokenize

from tests.torch_port_utils import (share_cpu,  # noqa: F401
                                    CPU, assert_state_equal, binned,
                                    categories,
                                    check_fused_step_against_jax,
                                    chi2_same_distribution, jax_layouts,
                                    reachable)

pytestmark = pytest.mark.usefixtures("share_cpu")

N = 1000  # layouts per side for the chi-square tests

FAMILIES = {
    "fourrooms": "MiniGrid-FourRooms-v0",
    "lavagap": "MiniGrid-LavaGapS7-v0",
    "distshift": "MiniGrid-DistShift2-v0",
    "crossing": "MiniGrid-LavaCrossingS11N5-v0",
    "simplecrossing": "MiniGrid-SimpleCrossingS9N2-v0",
    "lockedroom": "MiniGrid-LockedRoom-v0",
    "playground": "MiniGrid-Playground-v0",
    "multiroom": "MiniGrid-MultiRoom-N6-v0",
}
WALL = np.array(C.WALL_CELL)
_CACHE: dict = {}


def batches(name):
    """(env id, JAX env, JAX layouts, port layouts), N each, shared by the
    module's tests."""
    if name not in _CACHE:
        env_id = FAMILIES[name]
        jenv, jst = jax_layouts(env_id, N, seed=3)
        penv = minigrid_tpu_torch.make(env_id, device=CPU).packed()
        _CACHE[name] = (env_id, jenv, jst,
                        penv._gen_grid(penv.generator(3), N))
    return _CACHE[name]


def arrays(st):
    """grid, agent_pos, agent_dir, mission of a JAX or port batch."""
    return tuple(np.asarray(getattr(st, k)) for k in
                 ("grid", "agent_pos", "agent_dir", "mission"))


def cells_of(grid, t):
    """(n, 3) [env, x, y] of every cell of type ``t``."""
    return np.argwhere(grid[..., 0] == t)


def one_per_env(grid, t):
    found = cells_of(grid, t)
    assert (found[:, 0] == np.arange(len(grid))).all(), t
    return found[:, 1], found[:, 2]


def border_walls(grid):
    for border in (grid[:, 0], grid[:, -1], grid[:, :, 0], grid[:, :, -1]):
        assert (border == WALL).all()


# --- features for the chi-square tests, per family --------------------------

def f_fourrooms(grid, pos, d, mission):
    gx, gy = one_per_env(grid, C.GOAL)
    gap_v = np.argmax(grid[:, 9, 1:9, 0] != C.WALL, axis=1)
    gap_h = np.argmax(grid[:, 1:9, 9, 0] != C.WALL, axis=1)
    return {"agent_x": pos[:, 0], "agent_y": pos[:, 1], "dir": d,
            "goal_x": gx, "goal_y": gy, "gap_v": gap_v, "gap_h": gap_h}


def f_lavagap(grid, pos, d, mission):
    lx = np.argmax((grid[..., 0] == C.LAVA).any(2), axis=1)
    col = grid[np.arange(len(grid)), lx]
    gap_y = np.argmax(col[:, 1:-1, 0] == C.EMPTY, axis=1)
    return {"gap_x": lx, "gap_y": gap_y}


def _river_code(grid, obstacle):
    size = grid.shape[1]
    inner = grid[:, 1:-1, 1:-1, 0] == obstacle
    cols = inner.sum(2) == size - 3          # a vertical river
    rows = inner.sum(1) == size - 3
    w = 1 << np.arange(size - 2)
    return (cols * w).sum(1) + (rows * w).sum(1) * (1 << (size - 2))


def _crossing_features(grid, obstacle):
    code = _river_code(grid, obstacle)
    n_obst = (grid[..., 0] == obstacle).sum((1, 2))
    # the first opening in x-major order: an empty interior cell with
    # obstacles on both sides along one axis
    g = grid[..., 0]
    e = g[:, 1:-1, 1:-1] == C.EMPTY
    sides = (((g[:, :-2, 1:-1] == obstacle) & (g[:, 2:, 1:-1] == obstacle))
             | ((g[:, 1:-1, :-2] == obstacle) & (g[:, 1:-1, 2:] == obstacle)))
    first = np.argmax((e & sides).reshape(len(g), -1), axis=1)
    return {"rivers": code, "obstacles": n_obst, "first_opening": first}


def f_crossing(grid, pos, d, mission):
    return _crossing_features(grid, C.LAVA)


def f_simplecrossing(grid, pos, d, mission):
    return _crossing_features(grid, C.WALL)


def _room_of(x, y):
    """LockedRoom's room index (0-5) of an interior room cell."""
    return (y // 6) * 2 + (x > 9)


def f_lockedroom(grid, pos, d, mission):
    B = len(grid)
    locked = np.argwhere((grid[..., 0] == C.DOOR) & (grid[..., 2] == C.LOCKED))
    assert (locked[:, 0] == np.arange(B)).all()
    lx, ly = locked[:, 1], locked[:, 2]
    kx, ky = one_per_env(grid, C.KEY)
    gx, gy = one_per_env(grid, C.GOAL)
    return {"locked_room": _room_of(lx, ly),
            "locked_color": grid[np.arange(B), lx, ly, 1],
            "key_room": _room_of(kx, ky), "goal_x": gx % 10,
            "goal_y": gy % 6, "agent_x": pos[:, 0], "agent_y": pos[:, 1] // 3}


def f_playground(grid, pos, d, mission):
    t, c = grid[..., 0], grid[..., 1]
    out = {f"n_{k}": (t == v).sum((1, 2)) for k, v in
           (("key", C.KEY), ("ball", C.BALL), ("box", C.BOX))}
    out["red_doors"] = ((t == C.DOOR) & (c == C.COLOR_TO_IDX["red"])).sum(
        (1, 2))
    out["agent_x"] = pos[:, 0]
    out["dir"] = d
    return out


def f_multiroom(grid, pos, d, mission):
    gx, gy = one_per_env(grid, C.GOAL)
    t = grid[..., 0]
    return {"agent_x": pos[:, 0] // 3, "agent_y": pos[:, 1] // 3,
            "goal_x": gx // 3, "goal_y": gy // 3,
            "walls": (t == C.WALL).sum((1, 2)),
            "green_doors": ((t == C.DOOR)
                            & (grid[..., 1] == C.COLOR_TO_IDX["green"])
                            ).sum((1, 2))}


FEATURES = {"fourrooms": f_fourrooms, "lavagap": f_lavagap,
            "crossing": f_crossing, "simplecrossing": f_simplecrossing,
            "lockedroom": f_lockedroom, "playground": f_playground,
            "multiroom": f_multiroom}
BINNED = {"walls", "obstacles"}


@pytest.mark.parametrize("name", sorted(FEATURES))
def test_distribution_matches_jax(name):
    _, _, jst, pst = batches(name)
    jf = FEATURES[name](*arrays(jst))
    pf = FEATURES[name](*arrays(pst))
    if name == "lockedroom":
        jm, pm = categories(np.asarray(jst.mission), pst.mission.numpy())
        jf["mission"], pf["mission"] = jm, pm
    for k in jf:
        a, b = (binned(jf[k], pf[k]) if k in BINNED else (jf[k], pf[k]))
        p = chi2_same_distribution(a, b)
        assert p > 1e-3, (name, k, p)


def test_distshift_layout_exact():
    env_id, jenv, jst, pst = batches("distshift")
    assert_state_equal(pst, jst, ("grid", "agent_pos", "agent_dir",
                                  "carrying", "step_count", "terminated",
                                  "truncated", "mission", "extra"))
    g = pst.grid.numpy()
    assert (g[:, 3:6, 5, 0] == C.LAVA).all()   # the second strip, row 5


@pytest.mark.parametrize("name", sorted(FAMILIES))
@pytest.mark.parametrize("kind", ["uniform", "interact"])
def test_plain_fused_step_matches_jax(name, kind):
    env_id, jenv, jst, _ = batches(name)
    check_fused_step_against_jax(env_id, jenv, jst, kind)


# --- layout invariants ------------------------------------------------------

def test_fourrooms_invariants():
    g, pos, _, mission = arrays(batches("fourrooms")[3])
    border_walls(g)
    for line in (g[:, 9, 1:-1], g[:, 1:-1, 9]):
        # each half of a dividing wall has exactly one gap (which may
        # hold the goal)
        assert ((line[:, :8, 0] != C.WALL).sum(1) == 1).all()
        assert ((line[:, 9:, 0] != C.WALL).sum(1) == 1).all()
    gx, gy = one_per_env(g, C.GOAL)
    assert not ((gx == pos[:, 0]) & (gy == pos[:, 1])).any()
    assert (g[np.arange(len(g)), pos[:, 0], pos[:, 1], 0] == C.EMPTY).all()
    np.testing.assert_array_equal(mission[0], tokenize("reach the goal"))
    env = minigrid_tpu_torch.make("MiniGrid-FourRooms-v0", device=CPU,
                                  agent_pos=(2, 3), goal_pos=(15, 16))
    _, st = env.reset(env.generator(0), 64)
    assert (st.agent_pos.numpy() == [2, 3]).all()
    assert (st.grid[:, 15, 16, 0] == C.GOAL).all()


def test_lavagap_invariants():
    g, pos, d, _ = arrays(batches("lavagap")[3])
    border_walls(g)
    assert ((g[..., 0] == C.LAVA).sum((1, 2)) == 4).all()   # 5 rows, 1 gap
    assert (g[:, 5, 5, 0] == C.GOAL).all()
    assert (pos == [1, 1]).all() and (d == 0).all()
    env = minigrid_tpu_torch.make("MiniGrid-LavaGapS5-v0", device=CPU,
                                  obstacle_type="wall")
    _, st = env.reset(env.generator(0), 16)
    assert not (st.grid[..., 0] == C.LAVA).any()
    assert env.default_mission().startswith("find the opening")


@pytest.mark.parametrize("name,obstacle,k", [("crossing", C.LAVA, 5),
                                             ("simplecrossing", C.WALL, 2)])
def test_crossing_invariants(name, obstacle, k):
    env_id, _, _, pst = batches(name)
    g, pos, d, _ = arrays(pst)
    size = g.shape[1]
    border_walls(g)
    assert (g[:, size - 2, size - 2, 0] == C.GOAL).all()
    assert (pos == [1, 1]).all() and (d == 0).all()
    code = _river_code(g, obstacle)
    n_rivers = np.array([bin(c).count("1") for c in code])
    assert (n_rivers == k).all()
    for b in range(200):  # the staircase keeps the goal reachable
        seen = reachable(g[b], (1, 1), (C.EMPTY, C.GOAL))
        assert seen[size - 2, size - 2], (env_id, b)


def test_lockedroom_invariants():
    g, pos, _, mission = arrays(batches("lockedroom")[3])
    B = len(g)
    doors = cells_of(g, C.DOOR)
    assert (np.bincount(doors[:, 0], minlength=B) == 6).all()
    colors = g[doors[:, 0], doors[:, 1], doors[:, 2], 1].reshape(B, 6)
    assert (np.sort(colors, 1) == np.arange(6)).all()   # distinct
    f = f_lockedroom(g, pos, None, mission)
    kx, ky = one_per_env(g, C.KEY)
    gx, gy = one_per_env(g, C.GOAL)
    assert (g[np.arange(B), kx, ky, 1] == f["locked_color"]).all()
    assert (f["key_room"] != f["locked_room"]).all()
    assert (_room_of(gx, gy) == f["locked_room"]).all()
    assert ((pos[:, 0] > 7) & (pos[:, 0] < 11)).all()   # the hallway
    for b in range(0, B, 97):
        words = mission[b]
        locked = C.IDX_TO_COLOR[int(f["locked_color"][b])]
        assert words[2] == tokenize(locked)[0]


def test_playground_invariants():
    g, pos, _, mission = arrays(batches("playground")[3])
    B = len(g)
    border_walls(g)
    assert ((g[..., 0] == C.DOOR).sum((1, 2)) == 12).all()
    objects = np.isin(g[..., 0], [C.KEY, C.BALL, C.BOX]).sum((1, 2))
    assert (objects == 12).all()
    assert (g[np.arange(B), pos[:, 0], pos[:, 1], 0] == C.EMPTY).all()
    assert (mission == 0).all()


def test_multiroom_invariants():
    env_id, _, _, pst = batches("multiroom")
    g, pos, _, _ = arrays(pst)
    B = len(g)
    assert ((g[..., 0] == C.DOOR).sum((1, 2)) == 5).all()  # 6 rooms
    doors = cells_of(g, C.DOOR)
    assert (g[doors[:, 0], doors[:, 1], doors[:, 2], 2] == C.CLOSED).all()
    gx, gy = one_per_env(g, C.GOAL)
    assert not ((gx == pos[:, 0]) & (gy == pos[:, 1])).any()
    for b in range(100):  # the goal is reachable through the doors
        seen = reachable(g[b], pos[b], (C.EMPTY, C.GOAL, C.DOOR))
        assert seen[gx[b], gy[b]], (env_id, b)
    small = minigrid_tpu_torch.make("MiniGrid-MultiRoom-N2-S4-v0",
                                    device=CPU)
    _, st = small.reset(small.generator(1), 64)
    assert ((st.grid[..., 0] == C.DOOR).sum((1, 2)) == 1).all()
