"""The port's RoomGrid builder (minigrid_tpu_torch/core/roomgrid.py) and its
three MiniGrid families (Unlock, KeyCorridor, ObstructedMaze) against the
JAX package:

- the deterministic builder operations bit-exact on JAX-exported builders
  (``reachable_rooms``, ``door_exists``/``has_neighbor``, ``remove_wall``,
  ``add_door`` with every argument given, the cells ``place_in_room`` may
  draw);
- ``connect_all`` joins every room, with JAX's distribution of added doors;
- each family's layouts by invariants and by chi-square against
  ``jax.vmap(env._gen_grid)`` draws (p > 1e-3);
- ObstructedMaze solvability: v1 never unsolvable, v0 at the documented
  rates within a binomial band (tests/test_obstructed_maze.py's analysis);
- the hook steps (``PickupTargetMixin`` and Unlock's ``_post_step``, the
  hook path around the fused step) bit-exact against JAX ``step_state`` on
  exported states."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from minigrid_tpu.core import roomgrid as JRG
from minigrid_tpu.core.obs import gen_obs as j_gen_obs

import minigrid_tpu_torch
from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import roomgrid as RG
from minigrid_tpu_torch.core.mission import detokenize
from minigrid_tpu_torch.envs.base import has_step_hooks
from minigrid_tpu_torch.ops.fused_step import require_core_dynamics

from tests.torch_port_utils import (share_cpu,  # noqa: F401
                                    ALL_FIELDS, CPU, action_stream,
                                    assert_state_equal, categories,
                                    chi2_same_distribution, export,
                                    jax_layouts, reachable)

pytestmark = pytest.mark.usefixtures("share_cpu")

N = 1000  # layouts per side for the chi-square tests
FAMILIES = {
    "unlock": "MiniGrid-Unlock-v0",
    "unlockpickup": "MiniGrid-UnlockPickup-v0",
    "blockedunlockpickup": "MiniGrid-BlockedUnlockPickup-v0",
    "keycorridor": "MiniGrid-KeyCorridorS4R3-v0",
    "obstructedmaze": "MiniGrid-ObstructedMaze-1Dlhb-v0",
    "obstructedmaze_full": "MiniGrid-ObstructedMaze-Full-v1",
}
_CACHE: dict = {}


def batches(name):
    """(env id, JAX env, JAX layouts, port env, port layouts), N each."""
    if name not in _CACHE:
        env_id = FAMILIES[name]
        jenv, jst = jax_layouts(env_id, N, seed=6)
        penv = minigrid_tpu_torch.make(env_id, device=CPU).packed()
        _CACHE[name] = (env_id, jenv, jst, penv,
                        penv._gen_grid(penv.generator(6), N))
    return _CACHE[name]


def _np(st):
    return {"grid": np.asarray(st.grid), "pos": np.asarray(st.agent_pos),
            "dir": np.asarray(st.agent_dir),
            "mission": np.asarray(st.mission)} | {
        k: np.asarray(v) for k, v in (st.extra or {}).items()}


# --- builders -----------------------------------------------------------------

LAYOUT = (4, 3, 3)  # room size, rows, cols: KeyCorridorS4R3's 10x10 maze


def _jax_builders(n, seed, doors: int = 3, layout=LAYOUT):
    """n JAX builders of ``layout`` with ``doors`` random doors added."""
    key = ("builders", n, seed, doors, layout)
    if key not in _CACHE:
        L = JRG.RoomLayout(*layout)

        def make(k):
            ks = jax.random.split(k, 2 + 3 * doors)
            b = JRG.init_builder(L, ks[0])
            for t in range(doors):
                i = jax.random.randint(ks[1 + 3 * t], (), 0, L.num_cols)
                j = jax.random.randint(ks[2 + 3 * t], (), 0, L.num_rows)
                nb, _, _ = JRG.add_door(b, L, ks[3 + 3 * t], i, j, None)
                # a room whose walls all have doors keeps its builder
                valid = jnp.stack([JRG.has_neighbor(L, i, j, d)
                                   & ~JRG.door_exists(b, i, j, d)
                                   for d in range(4)]).any()
                b = jax.tree.map(lambda a, c: jnp.where(valid, c, a), b, nb)
            return b

        _CACHE[key] = (L, jax.jit(jax.vmap(make))(
            jax.random.split(jax.random.PRNGKey(seed), n)))
    return _CACHE[key]


def port_builder(jb) -> RG.Builder:
    return RG.Builder(**{f.name: torch.as_tensor(np.array(getattr(jb, f.name)))
                         for f in dataclasses.fields(RG.Builder)})


def assert_builder_equal(pb: RG.Builder, jb, msg=""):
    for f in dataclasses.fields(RG.Builder):
        np.testing.assert_array_equal(getattr(pb, f.name).numpy(),
                                      np.asarray(getattr(jb, f.name)),
                                      err_msg=f"{msg} {f.name}")


def test_init_builder_walls_and_slots():
    L, jb = _jax_builders(64, 0, doors=0)
    pl = RG.RoomLayout(*LAYOUT)
    pb = RG.init_builder(pl, torch.Generator().manual_seed(0), 512)
    np.testing.assert_array_equal(pb.grid[0].numpy(), np.asarray(jb.grid[0]))
    for f in ("agent_pos", "agent_dir", "doors_r", "doors_d", "locked",
              "combo_used"):
        np.testing.assert_array_equal(getattr(pb, f)[:64].numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)
    # the slots: the shared wall's coordinate exact, the other uniform
    # inside the room
    rs = LAYOUT[0]
    dr, dd = pb.door_pos_r.numpy(), pb.door_pos_d.numpy()
    np.testing.assert_array_equal(dr[..., 0], np.asarray(jb.door_pos_r[..., 0])
                                  [:1].repeat(512, 0))
    off = dr[..., 1] - np.arange(3)[None, :, None] * (rs - 1)
    assert set(np.unique(off)) == set(range(1, rs - 1))
    off = dd[..., 0] - np.arange(3)[None, None, :] * (rs - 1)
    assert set(np.unique(off)) == set(range(1, rs - 1))
    assert pb.door_pos_r.dtype == torch.int32
    assert pb.doors_r.dtype == torch.int8 and pb.locked.dtype == torch.bool


def test_reachable_rooms_matches_jax():
    L, jb = _jax_builders(256, 1, doors=4)
    pb = port_builder(jb)
    want = jax.jit(jax.vmap(lambda b: JRG.reachable_rooms(b, L)))(jb)
    got = RG.reachable_rooms(pb, RG.RoomLayout(*LAYOUT))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    counts = got.reshape(256, -1).sum(1).numpy()
    assert counts.min() >= 1 and len(set(counts.tolist())) > 3


def test_door_tables_match_jax():
    L, jb = _jax_builders(128, 2, doors=4)
    pb, pl = port_builder(jb), RG.RoomLayout(*LAYOUT)
    ask = jax.jit(jax.vmap(lambda b, i, j, d: (
        JRG.door_exists(b, i, j, d), JRG.has_neighbor(L, i, j, d)),
        in_axes=(0, None, None, None)))
    seen = 0
    for i in range(3):
        for j in range(3):
            for d in range(4):
                de, hn = ask(jb, i, j, d)
                np.testing.assert_array_equal(
                    RG.door_exists(pb, i, j, d).numpy(), np.asarray(de))
                np.testing.assert_array_equal(
                    np.broadcast_to(RG.has_neighbor(pl, i, j, d).numpy(),
                                    (128,)), np.asarray(hn))
                seen += int(np.asarray(de).sum())
    assert seen > 0


@pytest.mark.parametrize("wall", [0, 1, 2, 3])
def test_remove_wall_matches_jax(wall):
    L, jb = _jax_builders(32, 3, doors=2)
    pb, pl = port_builder(jb), RG.RoomLayout(*LAYOUT)
    for i, j in ((1, 1), (0, 1), (2, 2)):
        if not bool(RG.has_neighbor(pl, i, j, wall)):
            continue
        want = jax.jit(jax.vmap(lambda b: JRG.remove_wall(b, L, i, j,
                                                          wall)))(jb)
        assert_builder_equal(RG.remove_wall(pb, pl, i, j, wall), want,
                             f"room {i},{j}")


def test_add_door_with_fixed_arguments_matches_jax():
    L, jb = _jax_builders(64, 4, doors=1)
    pb, pl = port_builder(jb), RG.RoomLayout(*LAYOUT)
    g = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(0)
    for _ in range(6):
        i, j = int(rng.integers(0, 3)), int(rng.integers(0, 3))
        d = int(rng.choice([d for d in range(4)
                            if bool(RG.has_neighbor(pl, i, j, d))]))
        color = rng.integers(0, 6, 64).astype(np.uint8)
        locked = rng.integers(0, 2, 64).astype(bool)
        jadd = jax.jit(jax.vmap(lambda b, c, lk: JRG.add_door(
            b, L, jax.random.PRNGKey(0), i, j, d, c, lk)))
        jnb, jc, jpos = jadd(jb, jnp.asarray(color), jnp.asarray(locked))
        pnb, pc, ppos = RG.add_door(pb, pl, g, i, j, d,
                                    torch.from_numpy(color),
                                    torch.from_numpy(locked))
        assert_builder_equal(pnb, jnb, f"add_door {i},{j},{d}")
        np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(ppos.numpy(), np.asarray(jpos))
        jb, pb = jnb, pnb


def test_place_in_room_cells_match_jax():
    """The cells JAX's ``place_in_room`` lands on over 1024 keys are
    exactly the port's mask, for objects next to the agent's room."""
    L, jb = _jax_builders(4, 5, doors=2)
    pb, pl = port_builder(jb), RG.RoomLayout(*LAYOUT)
    cell = jnp.asarray([C.KEY, 0, 0, 0, 0], jnp.uint8)
    keys = jax.random.split(jax.random.PRNGKey(1), 1024)
    for i, j in ((1, 1), (0, 1)):
        mask = RG.place_in_room_mask(pb, pl, i, j).numpy()
        draw = jax.jit(jax.vmap(lambda b1, k: JRG.place_in_room(
            b1, L, k, i, j, cell)[1], in_axes=(None, 0)))
        for e in range(4):
            pos = draw(jax.tree.map(lambda x: x[e], jb), keys)
            got = np.zeros_like(mask[e])
            got[np.asarray(pos)[:, 0], np.asarray(pos)[:, 1]] = True
            np.testing.assert_array_equal(got, mask[e], err_msg=f"{i},{j}")
    # the port draws inside the mask
    g = torch.Generator().manual_seed(2)
    mask = RG.place_in_room_mask(pb, pl, 1, 1).numpy()
    for _ in range(20):
        nb, pos = RG.place_in_room(pb, pl, g, 1, 1, torch.as_tensor(cell))
        assert mask[np.arange(4), pos[:, 0], pos[:, 1]].all()


def test_connect_all_joins_every_room_with_jax_door_counts():
    n = 600
    L, jb = _jax_builders(n, 6, doors=0)
    pl = RG.RoomLayout(*LAYOUT)
    jc = jax.jit(jax.vmap(lambda b, k: JRG.connect_all(b, L, k)))(
        jb, jax.random.split(jax.random.PRNGKey(7), n))
    pb = RG.connect_all(port_builder(jb), pl, torch.Generator().manual_seed(7))
    assert RG.reachable_rooms(pb, pl).all()
    t = pb.grid[..., 0].numpy()
    # every door added is closed and unlocked, on a door slot
    assert (pb.grid[..., 2].numpy()[t == C.DOOR] == C.CLOSED).all()
    pdoors = (t == C.DOOR).sum((1, 2))
    jdoors = (np.asarray(jc.grid[..., 0]) == C.DOOR).sum((1, 2))
    assert pdoors.min() >= 8  # a spanning tree of 9 rooms
    p = chi2_same_distribution(np.minimum(jdoors, 12), np.minimum(pdoors, 12))
    assert p > 1e-3, p
    colors = pb.grid[..., 1].numpy()[t == C.DOOR]
    assert set(colors.tolist()) == set(range(6))


def test_connect_all_excludes_a_colour_and_respects_locks():
    pl = RG.RoomLayout(*LAYOUT)
    g = torch.Generator().manual_seed(8)
    b = RG.init_builder(pl, g, 256)
    b, dc, _ = RG.add_door(b, pl, g, 0, 0, 0, color=C.COLOR_TO_IDX["red"],
                           locked=True)
    excl = torch.full((256,), C.COLOR_TO_IDX["blue"])
    excl[::2] = -1
    b = RG.connect_all(b, pl, g, exclude_color=excl)
    t, col = b.grid[..., 0].numpy(), b.grid[..., 1].numpy()
    closed = (t == C.DOOR) & (b.grid[..., 2].numpy() == C.CLOSED)
    blue = (closed & (col == C.COLOR_TO_IDX["blue"])).any((1, 2))
    assert not blue[1::2].any() and blue[::2].any()
    # the locked room (0, 0) gets no other door: its right wall has the
    # locked one and the draws never open a locked room
    assert (b.doors_d[:, 0, 0] == 0).all()
    rr = RG.reachable_rooms(b, pl)
    assert rr.reshape(256, -1).sum(1).min() >= 8


def test_add_distractors_unique_and_in_room():
    pl = RG.RoomLayout(7, 1, 1)
    g = torch.Generator().manual_seed(9)
    b = RG.init_builder(pl, g, 128)
    b, kinds, colors, pos = RG.add_distractors(b, pl, g, 0, 0, 6)
    combo = kinds * 6 + colors.to(torch.int64)
    assert all(len(set(r.tolist())) == 6 for r in combo)
    x, y = pos[..., 0].long(), pos[..., 1].long()
    bi = torch.arange(128)[:, None]
    assert (b.grid[bi, x, y, 0] == torch.as_tensor(RG.KIND_IDS)[kinds]).all()
    assert b.combo_used.sum(1).eq(6).all()
    d = (pos - b.agent_pos[:, None]).abs().sum(-1)
    assert (d >= 2).all()  # never next to the agent


def test_place_agent_never_faces_an_object():
    pl = RG.RoomLayout(5, 1, 2)
    g = torch.Generator().manual_seed(10)
    b = RG.init_builder(pl, g, 512)
    b, *_ = RG.add_distractors(b, pl, g, 0, 0, 5)
    b = RG.place_agent(b, pl, g, 0, 0)
    ax, ay = b.agent_pos[:, 0].long(), b.agent_pos[:, 1].long()
    bi = torch.arange(512)
    assert (b.grid[bi, ax, ay, 0] == C.EMPTY).all()
    vec = torch.as_tensor(C.DIR_TO_VEC).long()[b.agent_dir.long()]
    front = b.grid[bi, ax + vec[:, 0], ay + vec[:, 1], 0]
    assert ((front == C.EMPTY) | (front == C.WALL)).all()
    assert (ax < 5).all() and set(b.agent_dir.tolist()) == {0, 1, 2, 3}


# --- the families' layouts ------------------------------------------------------

def _room_of(pos, rs):
    return pos[..., 0] // (rs - 1), pos[..., 1] // (rs - 1)


def _cells(g, b, t, color=None):
    m = g[b, ..., 0] == t
    if color is not None:
        m &= g[b, ..., 1] == color
    return np.argwhere(m)


def f_unlock(s):
    g = s["grid"]
    dp = np.argwhere(g[..., 0] == C.DOOR)
    key = np.argwhere(g[..., 0] == C.KEY)
    return {"door_y": dp[:, 2], "door_color": g[dp[:, 0], dp[:, 1], dp[:, 2],
                                                 1],
            "key": key[:, 1] * 6 + key[:, 2], "agent_x": s["pos"][:, 0],
            "agent_y": s["pos"][:, 1], "dir": s["dir"]}


def f_unlockpickup(s):
    f = f_unlock(s)
    box = np.argwhere(s["grid"][..., 0] == C.BOX)
    f["box"] = box[:, 1] * 6 + box[:, 2]
    f["target_color"] = s["target_color"]
    return f


def f_blockedunlockpickup(s):
    f = f_unlockpickup(s)
    g = s["grid"]
    dp = np.argwhere(g[..., 0] == C.DOOR)
    f["blocker_color"] = g[dp[:, 0], dp[:, 1] - 1, dp[:, 2], 1]
    return f


def f_keycorridor(s):
    g, rs = s["grid"], 4
    locked = np.argwhere((g[..., 0] == C.DOOR) & (g[..., 2] == C.LOCKED))
    key = np.argwhere(g[..., 0] == C.KEY)
    return {"locked_y": locked[:, 2], "key_room": _room_of(key[:, 1:], rs)[1],
            "n_doors": (g[..., 0] == C.DOOR).sum((1, 2)),
            "agent": s["pos"][:, 0] * 10 + s["pos"][:, 1], "dir": s["dir"],
            "target_color": s["target_color"]}


def f_obstructedmaze(s):
    g = s["grid"]
    box = np.argwhere(g[..., 0] == C.BOX)
    blocker = np.argwhere((g[..., 0] == C.BALL)
                          & (g[..., 1] == C.COLOR_TO_IDX["green"]))
    return {"door_color": g[..., 1][g[..., 0] == C.DOOR],
            "box": box[:, 1] * 6 + box[:, 2], "n_blockers": np.bincount(
                blocker[:, 0], minlength=len(g)),
            "agent_x": s["pos"][:, 0], "dir": s["dir"]}


def f_obstructedmaze_full(s):
    g = s["grid"]
    ball = np.argwhere((g[..., 0] == C.BALL)
                       & (g[..., 1] == C.COLOR_TO_IDX["blue"]))
    ri, rj = _room_of(ball[:, 1:], 6)
    return {"corner": ri * 3 + rj, "door_color": g[..., 1][
        g[..., 0] == C.DOOR], "agent": s["pos"][:, 0] * 16 + s["pos"][:, 1],
        "dir": s["dir"]}


FEATURES = {k: globals()[f"f_{k}"] for k in FAMILIES}


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_distribution_matches_jax(name):
    _, _, jst, _, pst = batches(name)
    js, ps = _np(jst), _np(pst)
    jf, pf = FEATURES[name](js), FEATURES[name](ps)
    jf["mission"], pf["mission"] = categories(js["mission"], ps["mission"])
    for k in jf:
        p = chi2_same_distribution(jf[k], pf[k])
        assert p > 1e-3, (name, k, p)


def _agent_ok(s, b, ahead=(C.EMPTY, C.WALL)):
    """The agent on an empty cell, facing one of ``ahead``."""
    g = s["grid"]
    x, y = s["pos"][b]
    dx, dy = C.DIR_TO_VEC[s["dir"][b]]
    return g[b, x, y, 0] == C.EMPTY and g[b, x + dx, y + dy, 0] in ahead


@pytest.mark.parametrize("name", ["unlock", "unlockpickup",
                                  "blockedunlockpickup"])
def test_unlock_invariants(name):
    env_id, _, _, penv, pst = batches(name)
    s = _np(pst)
    g = s["grid"]
    assert (penv.params.width, penv.params.height) == (11, 6)
    for b in range(0, N, 5):
        doors = _cells(g, b, C.DOOR)
        assert len(doors) == 1 and doors[0][0] == 5
        dx, dy = doors[0]
        assert g[b, dx, dy, 2] == C.LOCKED and 1 <= dy <= 4
        color = g[b, dx, dy, 1]
        keys = _cells(g, b, C.KEY, color)
        assert len(keys) == 1 and keys[0][0] < 5
        assert s["pos"][b][0] < 5 and _agent_ok(s, b)
        if name == "unlock":
            assert s["door_pos"].dtype == np.int32
            assert tuple(s["door_pos"][b]) == (dx, dy)
            assert detokenize(s["mission"][b]) == "open the door"
        else:
            boxes = _cells(g, b, C.BOX)
            assert len(boxes) == 1 and boxes[0][0] > 5
            bc = g[b, boxes[0][0], boxes[0][1], 1]
            assert s["target_type"][b] == C.BOX and s["target_color"][b] == bc
            assert detokenize(s["mission"][b]) == \
                f"pick up the {C.IDX_TO_COLOR[int(bc)]} box"
        if name == "blockedunlockpickup":
            assert g[b, dx - 1, dy, 0] == C.BALL


def test_keycorridor_invariants():
    env_id, _, _, penv, pst = batches("keycorridor")
    s, rs = _np(pst), 4
    g = s["grid"]
    for b in range(0, N, 5):
        locked = np.argwhere((g[b, ..., 0] == C.DOOR)
                             & (g[b, ..., 2] == C.LOCKED))
        assert len(locked) == 1 and locked[0][0] == 2 * (rs - 1)
        room_j = locked[0][1] // (rs - 1)
        color = g[b, locked[0][0], locked[0][1], 1]
        keys = _cells(g, b, C.KEY, color)
        assert len(keys) == 1 and keys[0][0] < rs - 1
        balls = _cells(g, b, C.BALL)
        assert len(balls) == 1 and balls[0][0] > 2 * (rs - 1)
        assert balls[0][1] // (rs - 1) == room_j
        assert s["target_color"][b] == g[b, balls[0][0], balls[0][1], 1]
        # in room (1, 1), its walls included (the hallway opened them)
        assert ((s["pos"][b] >= rs - 1) & (s["pos"][b] <= 2 * (rs - 1))).all()
        # placed before connect_all, which may turn the wall ahead into a
        # door
        assert _agent_ok(s, b, (C.EMPTY, C.WALL, C.DOOR))
        # with the locked door open every cell of the maze is reachable
        open_grid = g[b].copy()
        seen = reachable(open_grid, s["pos"][b], (C.EMPTY, C.DOOR, C.KEY,
                                                   C.BALL))
        floor = np.isin(open_grid[..., 0], [C.EMPTY, C.KEY, C.BALL])
        assert seen[floor].all()
    assert (s["target_type"] == C.BALL).all()


def test_obstructedmaze_invariants():
    for name in ("obstructedmaze", "obstructedmaze_full"):
        env_id, _, _, penv, pst = batches(name)
        s = _np(pst)
        g = s["grid"]
        blue = (g[..., 0] == C.BALL) & (g[..., 1] == C.COLOR_TO_IDX["blue"])
        assert (blue.sum((1, 2)) == 1).all()
        assert (s["target_type"] == C.BALL).all()
        assert (s["target_color"] == C.COLOR_TO_IDX["blue"]).all()
        locked = (g[..., 0] == C.DOOR) & (g[..., 2] == C.LOCKED)
        boxes = (g[..., 0] == C.BOX) & (g[..., 3] == C.KEY)
        assert (locked.sum((1, 2)) == boxes.sum((1, 2))).all()
        for b in range(0, N, 25):
            assert _agent_ok(s, b)
            for x, y in np.argwhere(locked[b]):
                assert (boxes[b] & (g[b, ..., 4] == g[b, x, y, 1])).any()


# --- ObstructedMaze solvability (tests/test_obstructed_maze.py) --------------

def unsolvable_rate(env_id: str, n: int) -> float:
    """The share of layouts whose blue-ball room has no door with a key in
    a box on the map (a blocker overwrote it)."""
    env = minigrid_tpu_torch.make(env_id, device=CPU)
    g = env._gen_grid(env.generator(11), n).grid.numpy()
    S = 6
    types, colors = g[..., 0], g[..., 1]
    B, W, H = types.shape
    ball = (types == C.BALL) & (colors == C.COLOR_TO_IDX["blue"])
    pos = ball.reshape(B, -1).argmax(1)
    bx, by = pos // H, pos % H
    x0, y0 = (bx - 1) // (S - 1) * (S - 1), (by - 1) // (S - 1) * (S - 1)
    x1, y1 = x0 + S - 1, y0 + S - 1
    xs, ys = np.arange(W)[None, :], np.arange(H)[None, :]
    in_x = (xs >= x0[:, None]) & (xs <= x1[:, None])
    in_y = (ys >= y0[:, None]) & (ys <= y1[:, None])
    edge_x = (xs == x0[:, None]) | (xs == x1[:, None])
    edge_y = (ys == y0[:, None]) | (ys == y1[:, None])
    border = (edge_x[:, :, None] & in_y[:, None, :]) | (
        in_x[:, :, None] & edge_y[:, None, :])
    room_doors = (types == C.DOOR) & border
    solvable = np.zeros(B, bool)
    for color in range(C.NUM_COLORS):
        has_door = (room_doors & (colors == color)).any((1, 2))
        boxed = ((types == C.BOX) & (g[..., 3] == C.KEY)
                 & (g[..., 4] == color)).any((1, 2))
        solvable |= has_door & boxed
    return float((~solvable).mean())


OM_CASES = [("MiniGrid-ObstructedMaze-2Dlhb", 1 / 15),
            ("MiniGrid-ObstructedMaze-1Q", 1 / 15),
            ("MiniGrid-ObstructedMaze-2Q", 1 / 30),
            ("MiniGrid-ObstructedMaze-Full", 0.0)]


@pytest.mark.parametrize("base_id,expected", OM_CASES)
def test_obstructedmaze_solvability(base_id, expected):
    """v1: never unsolvable; v0: the documented covering-bug rate within a
    4-sigma binomial band, over 3000 layouts each."""
    n = 3000
    assert unsolvable_rate(base_id + "-v1", n) == 0.0
    rate = unsolvable_rate(base_id + "-v0", n)
    tol = 4 * (max(expected, 1e-9) * (1 - expected) / n) ** 0.5 + 1e-3
    assert abs(rate - expected) <= tol, (base_id, rate, expected)


# --- the hook steps --------------------------------------------------------------

def _jax_step(jenv):
    if ("step", jenv) not in _CACHE:
        def one(k, s, a):
            ns, r, te, tr = jenv.step_state(k, s, a)
            return j_gen_obs(jenv.params, ns)["packed"], ns, r, te, tr

        _CACHE[("step", jenv)] = jax.jit(jax.vmap(one))
    return _CACHE[("step", jenv)]


def _keys(seed, n):
    k = np.array(jax.random.split(jax.random.PRNGKey(seed), n))
    return jnp.asarray(k), torch.from_numpy(k.view(np.int32))


def _check_steps(name, jst, actions, msg):
    env_id, jenv, _, penv, _ = batches(name)
    pst = export(jst)
    step = _jax_step(jenv)
    paid = 0
    for t in range(actions.shape[0]):
        jk, pk = _keys(40 + t, actions.shape[1])
        a = torch.from_numpy(actions[t])
        o, jst, r, te, tr = step(jk, jst, jnp.asarray(actions[t]))
        po, pst, pr, pte, ptr, _ = penv.step(pk, pst, a)
        m = f"{env_id} {msg} step {t}"
        np.testing.assert_array_equal(po["packed"].numpy(), np.asarray(o),
                                      err_msg=m)
        assert_state_equal(pst, jst, ALL_FIELDS, msg=m)
        for got, want in ((pr, r), (pte, te), (ptr, tr)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=m)
        paid += int((np.asarray(r) > 0).sum())
    return paid


@pytest.mark.parametrize("name", sorted(FAMILIES))
@pytest.mark.parametrize("kind", ["uniform", "interact"])
def test_hook_step_matches_jax(name, kind):
    """16 steps of ``step`` (the hook path) on exported states:
    observation, every field with ``extra``, reward and flags bit-exact."""
    _, _, jst, _, _ = batches(name)
    jst = jax.tree.map(lambda x: x[:128], jst)
    _check_steps(name, jst, action_stream(kind, 16, 128, seed=6), kind)


def _facing(jst, target, carrying=None):
    """States with the agent left of ``target`` ((B, 2)) facing it, where
    that cell is free, optionally holding ``carrying`` ((B, 5))."""
    g = np.asarray(jst.grid)
    B = len(g)
    cand = target - [1, 0]
    free = g[np.arange(B), cand[:, 0], cand[:, 1], 0] == C.EMPTY
    pos = np.where(free[:, None], cand, np.asarray(jst.agent_pos))
    kw = {}
    if carrying is not None:
        kw["carrying"] = jnp.asarray(carrying)
    return jst.replace(agent_pos=jnp.asarray(pos.astype(np.int32)),
                       agent_dir=jnp.zeros(B, jnp.int32), **kw)


def test_hook_rewards_match_jax():
    """The agent put before what each family's hook pays for (the door
    with its key in hand, the target object), then every action: bit-exact
    rewards, and some paid."""
    for name in sorted(FAMILIES):
        _, _, jst, _, _ = batches(name)
        jst = jax.tree.map(lambda x: x[:64], jst)
        g = np.asarray(jst.grid)
        if name == "unlock":
            dp = np.asarray(jst.extra["door_pos"])
            key = np.stack([np.array([C.KEY, g[b, dp[b, 0], dp[b, 1], 1], 0,
                                      0, 0], np.uint8) for b in range(64)])
            jst = _facing(jst, dp, key)
        else:
            tt = np.asarray(jst.extra["target_type"])
            tc = np.asarray(jst.extra["target_color"])
            tgt = np.stack([np.argwhere((g[b, ..., 0] == tt[b])
                                        & (g[b, ..., 1] == tc[b]))[0]
                            for b in range(64)])
            jst = _facing(jst, tgt)
        paid = 0
        for a in range(7):
            acts = np.full((1, 64), a, np.int32)
            paid += _check_steps(name, jst, acts, f"action {a}")
        assert paid > 0, name


def test_families_route_through_the_hook_path():
    for env_id in FAMILIES.values():
        env = minigrid_tpu_torch.make(env_id, device=CPU)
        assert has_step_hooks(env)
        with pytest.raises(NotImplementedError, match="overrides"):
            require_core_dynamics(env)
