"""The port's hook families (Memory, RedBlueDoors, GoToObject, Fetch,
GoToDoor, PutNear, Dynamic-Obstacles) and the hook path around the fused
step (minigrid_tpu_torch/envs/base.py::hooked_step) against the JAX
package:

- each generator's layouts by invariants and by chi-square against
  ``jax.vmap(env._gen_grid)`` draws (p > 1e-3);
- the plain fused step on their states bit-exact against JAX's core
  transition, and ``step``/``step_state`` of the six families whose hooks
  are deterministic bit-exact against JAX ``vmap(env.step_state)`` (with
  ``gen_obs`` for the observation), ``extra`` included;
- Dynamic-Obstacles: ``_transform_action`` and ``_post_step`` bit-exact,
  ``_pre_step`` by invariants and a chi-square of the moves against JAX's;
- the pooled, fresh and regen auto-resets of Fetch bit-exact against JAX
  given the same rows, ``extra`` and the per-episode mission carried
  through (the pooled reward within rtol 1e-6: XLA:CPU contracts it into
  a fused multiply-add in that program), and the pooled rollout's carried
  mission counts;
- the layout pool's round trip with ``extra``."""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from minigrid_tpu.core.obs import gen_obs as j_gen_obs
from minigrid_tpu.envs.base import autoreset_step_fresh as j_autoreset_fresh
from minigrid_tpu.envs.base import (autoreset_step_presampled as
                                    j_autoreset_presampled)
from minigrid_tpu.envs.base import presample_reset_states as j_presample

import minigrid_tpu_torch
from minigrid_tpu_torch.convert import layout_pool_from_entries
from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core.mission import detokenize
from minigrid_tpu_torch.envs import base as B
from minigrid_tpu_torch.envs.base import has_step_hooks
from minigrid_tpu_torch.envs.common import hash_scores
from minigrid_tpu_torch.envs.empty import EmptyEnv
from minigrid_tpu_torch.models.actor_critic import (ActorCritic, init_params,
                                                    mission_counts)
from minigrid_tpu_torch.models.ppo import rollout, sample_rollout_noise
from minigrid_tpu_torch.ops.fused_step import (fused_observe,
                                               require_core_dynamics)

from tests.torch_port_utils import (share_cpu,  # noqa: F401
                                    ALL_FIELDS, CPU, action_stream,
                                    assert_state_equal, categories,
                                    check_fused_step_against_jax,
                                    chi2_same_distribution, export,
                                    jax_layouts)

pytestmark = pytest.mark.usefixtures("share_cpu")

N = 1000  # layouts per side for the chi-square tests

FAMILIES = {
    "memory": "MiniGrid-MemoryS13Random-v0",
    "redbluedoors": "MiniGrid-RedBlueDoors-8x8-v0",
    "gotoobject": "MiniGrid-GoToObject-8x8-N2-v0",
    "fetch": "MiniGrid-Fetch-8x8-N3-v0",
    "gotodoor": "MiniGrid-GoToDoor-8x8-v0",
    "putnear": "MiniGrid-PutNear-8x8-N3-v0",
    "dynamicobstacles": "MiniGrid-Dynamic-Obstacles-16x16-v0",
}
DETERMINISTIC = sorted(set(FAMILIES) - {"dynamicobstacles"})
DO_RANDOM = "MiniGrid-Dynamic-Obstacles-Random-6x6-v0"
_CACHE: dict = {}


def batches(name):
    """(env id, JAX env, JAX layouts, port env, port layouts), N each,
    shared by the module's tests."""
    if name not in _CACHE:
        env_id = FAMILIES.get(name, name)
        jenv, jst = jax_layouts(env_id, N, seed=4)
        penv = minigrid_tpu_torch.make(env_id, device=CPU).packed()
        _CACHE[name] = (env_id, jenv, jst, penv,
                        penv._gen_grid(penv.generator(4), N))
    return _CACHE[name]


def _keys(seed, n):
    """(JAX uint32 keys, the port's int32 view of the same bits)."""
    k = np.array(jax.random.split(jax.random.PRNGKey(seed), n))
    return jnp.asarray(k), torch.from_numpy(k.view(np.int32))


def _np(st):
    return {k: np.asarray(v) for k, v in
            (("grid", st.grid), ("pos", st.agent_pos), ("dir", st.agent_dir),
             ("mission", st.mission))} | {
        k: np.asarray(v) for k, v in (st.extra or {}).items()}


def _words(mission_row):
    return detokenize(mission_row).split()


def _color(word):
    return C.COLOR_TO_IDX[word]


# --- features for the chi-square tests --------------------------------------

def f_memory(s):
    g, h = s["grid"], s["grid"].shape[2]
    row = g[:, :, h // 2 - 2, 0]
    obj_x = np.argmax(np.isin(row, [C.KEY, C.BALL]), axis=1)
    return {"hallway_end": obj_x - 1, "agent_x": s["pos"][:, 0],
            "start": g[:, 1, h // 2 - 1, 0],
            "top": row[np.arange(len(g)), obj_x],
            "success_y": s["success_pos"][:, 1]}


def f_redbluedoors(s):
    g = s["grid"]
    return {"red_y": s["red_pos"][:, 1], "blue_y": s["blue_pos"][:, 1],
            "agent_x": s["pos"][:, 0], "agent_y": s["pos"][:, 1],
            "dir": s["dir"],
            "red_cell": g[np.arange(len(g)), s["red_pos"][:, 0],
                          s["red_pos"][:, 1], 1]}


def f_gotoobject(s):
    t = s["grid"][..., 0]
    return {"agent_x": s["pos"][:, 0], "n_keys": (t == C.KEY).sum((1, 2)),
            "target_x": s["target_pos"][:, 0]}


def f_fetch(s):
    t = s["grid"][..., 0]
    return {"agent_x": s["pos"][:, 0], "n_keys": (t == C.KEY).sum((1, 2)),
            "target_type": s["target_type"],
            "target_color": s["target_color"]}


def f_gotodoor(s):
    g = s["grid"]
    return {"w": (g[:, :, 0, 0] != C.EMPTY).sum(1),
            "h": (g[:, 0, :, 0] != C.EMPTY).sum(1),
            "agent_x": s["pos"][:, 0], "target_y": s["target_pos"][:, 1]}


def f_putnear(s):
    g = s["grid"]
    tp = s["target_pos"]
    return {"move_type": s["move_type"], "move_color": s["move_color"],
            "target_type": g[np.arange(len(g)), tp[:, 0], tp[:, 1], 0],
            "agent_x": s["pos"][:, 0]}


def f_dynamicobstacles(s):
    ob = s["obstacles"]
    return {"ball_x": ob[..., 0].reshape(-1), "ball_y": ob[..., 1].reshape(-1)}


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


# --- layout invariants ------------------------------------------------------

def test_memory_invariants():
    s = _np(batches("memory")[4])
    g, h = s["grid"], s["grid"].shape[2]
    f = f_memory(s)
    b = np.arange(len(g))
    assert ((f["hallway_end"] >= 4) & (f["hallway_end"] <= 10)).all()
    assert ((s["pos"][:, 0] >= 1)
            & (s["pos"][:, 0] <= f["hallway_end"])).all()
    assert (s["pos"][:, 1] == h // 2).all() and (s["dir"] == 0).all()
    x = f["hallway_end"] + 1
    top, bottom = g[b, x, h // 2 - 2, 0], g[b, x, h // 2 + 2, 0]
    assert (np.sort(np.stack([top, bottom], 1), 1) == [C.KEY, C.BALL]).all()
    match_top = top == f["start"]
    np.testing.assert_array_equal(
        s["success_pos"], np.where(match_top[:, None],
                                   np.stack([x, x * 0 + h // 2 - 1], 1),
                                   np.stack([x, x * 0 + h // 2 + 1], 1)))
    assert (s["failure_pos"][:, 1] + s["success_pos"][:, 1] == h - 1).all()
    assert s["success_pos"].dtype == np.int32


def test_redbluedoors_invariants():
    env = minigrid_tpu_torch.make("MiniGrid-RedBlueDoors-6x6-v0", device=CPU)
    assert (env.params.width, env.params.height) == (12, 6)
    s = _np(batches("redbluedoors")[4])
    g = s["grid"]
    b = np.arange(len(g))
    rp, bp = s["red_pos"], s["blue_pos"]
    assert (rp[:, 0] == 4).all() and (bp[:, 0] == 11).all()
    assert (g[b, rp[:, 0], rp[:, 1]] == [C.DOOR, C.COLOR_TO_IDX["red"],
                                        C.CLOSED, 0, 0]).all()
    assert (g[b, bp[:, 0], bp[:, 1]] == [C.DOOR, C.COLOR_TO_IDX["blue"],
                                        C.CLOSED, 0, 0]).all()
    assert ((g[..., 0] == C.DOOR).sum((1, 2)) == 2).all()
    assert ((s["pos"][:, 0] > 4) & (s["pos"][:, 0] < 11)).all()


def _objects(g, b):
    """{(type, colour): (x, y)} of env b's keys, balls and boxes."""
    xy = np.argwhere(np.isin(g[b, ..., 0], [C.KEY, C.BALL, C.BOX]))
    return {(int(g[b, x, y, 0]), int(g[b, x, y, 1])): (int(x), int(y))
            for x, y in xy}


TYPE_OF = {"key": C.KEY, "ball": C.BALL, "box": C.BOX}


@pytest.mark.parametrize("name,n", [("gotoobject", 2), ("fetch", 3),
                                    ("putnear", 3)])
def test_object_room_invariants(name, n):
    s = _np(batches(name)[4])
    g = s["grid"]
    for b in range(0, len(g), 7):
        objs = _objects(g, b)
        if name != "fetch":  # GoToObject/PutNear draw distinct pairs
            assert len(objs) == n
        assert (np.isin(g[b, ..., 0], [C.KEY, C.BALL, C.BOX]).sum() == n)
        w = _words(s["mission"][b])
        if name == "gotoobject":
            want = (TYPE_OF[w[-1]], _color(w[-2]))
            assert objs[want] == tuple(s["target_pos"][b])
        elif name == "fetch":
            want = (TYPE_OF[w[-1]], _color(w[-2]))
            assert want in objs
            assert want == (s["target_type"][b], s["target_color"][b])
        else:
            mover = (TYPE_OF[w[3]], _color(w[2]))
            target = (TYPE_OF[w[-1]], _color(w[-2]))
            assert mover == (s["move_type"][b], s["move_color"][b])
            assert objs[target] == tuple(s["target_pos"][b])
            assert mover in objs and mover != target
            pts = np.array(list(objs.values()))
            d = np.abs(pts[:, None] - pts[None]).max(-1)
            assert (d + np.eye(n, dtype=int) * 9 > 1).all()  # not adjacent
        x, y = s["pos"][b]
        assert g[b, x, y, 0] == C.EMPTY


def test_gotodoor_invariants():
    s = _np(batches("gotodoor")[4])
    g = s["grid"]
    f = f_gotodoor(s)
    assert ((f["w"] >= 5) & (f["w"] <= 8)).all()
    for b in range(0, len(g), 7):
        doors = np.argwhere(g[b, ..., 0] == C.DOOR)
        assert len(doors) == 4
        colors = g[b, doors[:, 0], doors[:, 1], 1]
        assert len(set(colors.tolist())) == 4
        assert (g[b, doors[:, 0], doors[:, 1], 2] == C.OPEN).all()
        tx, ty = s["target_pos"][b]
        assert g[b, tx, ty, 0] == C.DOOR
        assert g[b, tx, ty, 1] == _color(_words(s["mission"][b])[3])
        x, y = s["pos"][b]
        assert 0 < x < f["w"][b] - 1 and 0 < y < f["h"][b] - 1


def test_dynamicobstacles_reset_invariants():
    for name in ("dynamicobstacles", DO_RANDOM):
        env_id, _, _, penv, pst = batches(name)
        s = _np(pst)
        ob = s["obstacles"]
        n = penv.n_obstacles
        assert ob.shape == (N, n, 2) and ob.dtype == np.int32
        g = s["grid"]
        b = np.arange(N)[:, None]
        assert (g[b, ob[..., 0], ob[..., 1], 0] == C.BALL).all()
        assert ((g[..., 0] == C.BALL).sum((1, 2)) == n).all()
        assert not ((ob == s["pos"][:, None, :]).all(-1)).any()
    assert minigrid_tpu_torch.make(DO_RANDOM, device=CPU).n_obstacles == 3


# --- steps against JAX ------------------------------------------------------

@pytest.mark.parametrize("name", sorted(FAMILIES))
@pytest.mark.parametrize("kind", ["uniform", "interact"])
def test_plain_fused_step_matches_jax(name, kind):
    env_id, jenv, jst, _, _ = batches(name)
    check_fused_step_against_jax(env_id, jenv, jst, kind)


def _jax_step_state_obs(jenv):
    """JAX ``vmap(env.step_state)`` with the packed observation of the
    new state, jitted once per env."""
    if jenv not in _CACHE:
        def one(k, s, a):
            ns, r, te, tr = jenv.step_state(k, s, a)
            return j_gen_obs(jenv.params, ns)["packed"], ns, r, te, tr

        _CACHE[jenv] = jax.jit(jax.vmap(one))
    return _CACHE[jenv]


@pytest.mark.parametrize("name", DETERMINISTIC)
@pytest.mark.parametrize("kind", ["uniform", "interact"])
def test_hook_step_matches_jax(name, kind):
    """16 steps of ``step`` (the hook path) and ``step_state`` on exported
    states: observation, every state field with ``extra``, reward and
    flags bit-exact."""
    T, Bsz = 16, 128
    env_id, jenv, jst, penv, _ = batches(name)
    jst = jax.tree.map(lambda x: x[:Bsz], jst)
    pst = export(jst)
    step = _jax_step_state_obs(jenv)
    actions = action_stream(kind, T, Bsz, seed=5)
    n_term = 0
    for t in range(T):
        jk, pk = _keys(30 + t, Bsz)
        a = torch.from_numpy(actions[t])
        o, jst, r, te, tr = step(jk, jst, jnp.asarray(actions[t]))
        s2, r2, te2, tr2 = penv.step_state(pk, pst, a)
        po, pst, pr, pte, ptr, _ = penv.step(pk, pst, a)
        msg = f"{env_id} {kind} step {t}"
        np.testing.assert_array_equal(po["packed"].numpy(), np.asarray(o),
                                      err_msg=msg)
        assert_state_equal(pst, jst, ALL_FIELDS, msg=msg)
        assert_state_equal(s2, jst, ALL_FIELDS, msg=msg + " step_state")
        for got, want in ((pr, r), (pte, te), (ptr, tr), (r2, r), (te2, te),
                          (tr2, tr)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=msg)
        n_term += int(np.asarray(te).sum())
    if kind == "uniform" and name in ("gotoobject", "gotodoor"):
        assert n_term > 0  # done/toggle end episodes through _post_step


def test_hook_rewards_match_jax():
    """States where the hooks pay: each deterministic family's agent is
    put in front of the cell its hook rewards, then stepped with every
    action; rewards and flags bit-exact against JAX."""
    for name in DETERMINISTIC:
        env_id, jenv, jst, penv, _ = batches(name)
        jst = jax.tree.map(lambda x: x[:64], jst)
        g = np.asarray(jst.grid)
        pos = np.asarray(jst.agent_pos).copy()
        d = np.zeros(64, np.int32)
        target = _hook_target(name, jst)
        if target is not None:
            # stand left of the target, facing it (dir 0), where free
            cand = target - [1, 0]
            free = np.isin(g[np.arange(64), cand[:, 0], cand[:, 1], 0],
                           [C.EMPTY, C.DOOR])
            pos = np.where(free[:, None], cand, pos).astype(np.int32)
        jst = jst.replace(agent_pos=jnp.asarray(pos),
                          agent_dir=jnp.asarray(d))
        step = _jax_step_state_obs(jenv)
        jk, pk = _keys(50, 64)
        paid = 0
        for a in range(7):
            acts = np.full(64, a, np.int32)
            o, js, r, te, tr = step(jk, jst, jnp.asarray(acts))
            po, ps, pr, pte, ptr, _ = penv.step(pk, export(jst),
                                                torch.from_numpy(acts))
            np.testing.assert_array_equal(po["packed"].numpy(),
                                          np.asarray(o))
            assert_state_equal(ps, js, ALL_FIELDS, msg=f"{env_id} a={a}")
            np.testing.assert_array_equal(pr.numpy(), np.asarray(r))
            np.testing.assert_array_equal(pte.numpy(), np.asarray(te))
            paid += int((np.asarray(r) > 0).sum())
        if name in ("fetch", "gotodoor", "gotoobject", "memory"):
            assert paid > 0, name


def _hook_target(name, jst):
    """A cell next to which the family's hook pays, per env, or None."""
    ex = jst.extra
    if name == "memory":
        return np.asarray(ex["success_pos"]) + [1, 0]
    if name in ("gotoobject", "gotodoor", "putnear"):
        return np.asarray(ex["target_pos"])
    if name == "redbluedoors":
        return np.asarray(ex["red_pos"])
    if name == "fetch":
        g = np.asarray(jst.grid)
        tt, tc = np.asarray(ex["target_type"]), np.asarray(ex["target_color"])
        out = []
        for b in range(len(g)):
            xy = np.argwhere((g[b, ..., 0] == tt[b]) & (g[b, ..., 1] == tc[b]))
            out.append(xy[0])
        return np.array(out)
    return None


def test_dynamicobstacles_transform_and_post_step_match_jax():
    env_id, jenv, jst, penv, _ = batches(DO_RANDOM)
    Bsz = 256
    jst = jax.tree.map(lambda x: x[:Bsz], jst)
    pst = export(jst)
    acts = np.arange(Bsz, dtype=np.int32) % 7
    ja = jax.vmap(jenv._transform_action)(jst, jnp.asarray(acts))
    pa = penv._transform_action(pst, torch.from_numpy(acts))
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
    assert pa.dtype == torch.int32 and int(pa.max()) == 2
    # the post-step on JAX-stepped states, forward-heavy so balls are hit
    step = jax.jit(jax.vmap(jenv.step_state))
    post = jax.jit(jax.vmap(jenv._post_step))
    hits = 0
    for t in range(6):
        a = np.where(np.arange(Bsz) % 4 == 0, 1, 2).astype(np.int32)
        jk, pk = _keys(60 + t, Bsz)
        new, r, te, _ = step(jk, jst, jnp.asarray(a))
        core_r = jnp.zeros(Bsz, jnp.float32)
        core_te = jnp.asarray(np.arange(Bsz) % 9 == 0)
        js, jr, jte = post(jst, new, jnp.asarray(a), core_r, core_te)
        ps, pr, pte = penv._post_step(export(jst), export(new),
                                      torch.from_numpy(a),
                                      torch.from_numpy(np.array(core_r)),
                                      torch.from_numpy(np.array(core_te)))
        np.testing.assert_array_equal(pr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(pte.numpy(), np.asarray(jte))
        hits += int((np.asarray(jr) < 0).sum())
        jst = new
    assert hits > 0


def test_dynamicobstacles_pre_step_invariants_and_moves():
    """Every ball stays in its 3x3 neighbourhood, lands on a cell that was
    free (after the earlier balls' moves), never on the agent; the ball
    count and the grid's balls agree with ``extra``; the move offsets'
    distribution matches JAX's ``_pre_step`` on the same states, and the
    moves are a function of the keys."""
    env_id, jenv, jst, penv, _ = batches(DO_RANDOM)
    Bsz = N
    pst = export(jst)
    jk, pk = _keys(70, Bsz)
    acts = torch.full((Bsz,), 2, dtype=torch.int32)
    new = penv._pre_step(pk, pst, acts)
    again = penv._pre_step(pk, pst, acts)
    assert torch.equal(new.grid, again.grid)
    old = pst.extra["obstacles"].numpy()
    moved = new.extra["obstacles"].numpy()
    assert new.extra["obstacles"].dtype == torch.int32
    off = moved - old
    assert (np.abs(off) <= 1).all()
    g0, g1 = pst.grid.numpy(), new.grid.numpy()
    b = np.arange(Bsz)
    assert ((g1[..., 0] == C.BALL).sum((1, 2)) == penv.n_obstacles).all()
    assert (g1[b[:, None], moved[..., 0], moved[..., 1], 0] == C.BALL).all()
    agent = pst.agent_pos.numpy()
    assert not (moved == agent[:, None]).all(-1).any()
    stayed = (off == 0).all(-1)
    # a ball that moved landed on a cell empty before the step or left by
    # an earlier ball
    for i in range(penv.n_obstacles):
        src = g0[b, moved[:, i, 0], moved[:, i, 1], 0]
        left = (old[:, :i] == moved[:, i:i + 1]).all(-1).any(1)
        assert (stayed[:, i] | (src == C.EMPTY) | left).all()
    jnew = jax.jit(jax.vmap(jenv._pre_step))(jk, jst, jnp.asarray(acts))
    joff = np.asarray(jnew.extra["obstacles"]) - old
    code = lambda o: ((o[..., 0] + 1) * 3 + o[..., 1] + 1).reshape(-1)
    p = chi2_same_distribution(code(joff), code(off))
    assert p > 1e-3, p
    other = penv._pre_step(pk ^ 1, pst, acts).extra["obstacles"].numpy()
    assert (other != moved).any()


def test_dynamicobstacles_hash_is_uniform():
    keys = torch.randint(-2**31, 2**31, (20000, 2), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(0))
    for ball in (0, 7):
        s = hash_scores(keys, ball, 9)
        assert s.dtype == torch.int64 and int(s.min()) >= 0
        assert int(s.max()) < 2**32
        counts = np.bincount(s.argmax(1).numpy(), minlength=9)
        from scipy import stats as sps
        assert sps.chisquare(counts).pvalue > 1e-3


def test_dynamicobstacles_step_runs_the_hooks():
    env = minigrid_tpu_torch.make("MiniGrid-Dynamic-Obstacles-6x6-v0",
                                  device=CPU)
    assert env.num_actions == 3 and env.reward_range == (-1, 1)
    g = env.generator(0)
    obs, st = env.reset(g, 256)
    total = 0.0
    for t in range(20):
        keys = B.random_keys(g, (256, 2), CPU)
        a = torch.randint(0, 7, (256,), generator=g)
        obs, new, r, te, tr, _ = env.step(keys, st, a)
        balls = (new.grid[..., 0] == C.BALL).sum((1, 2))
        assert (balls == env.n_obstacles).all()
        assert torch.equal(obs["image"][..., 0].to(torch.int32),
                           (fused_observe(env.params, new) & 15))
        total += float(r[r < 0].sum())
        st = new
    assert total < 0  # collisions happen and cost -1


# --- auto-resets of a hook family -------------------------------------------

def _fetch_case(Bsz, seed):
    env_id, jenv, jst, penv, _ = batches("fetch")
    jst = jax.tree.map(lambda x: x[:Bsz], jst)
    ms = jenv.params.max_steps
    jst = jst.replace(step_count=jnp.asarray(
        ms - 1 - (np.arange(Bsz) % 6), jnp.int32))
    return jenv, jst, penv, export(jst)


def test_fetch_pooled_autoreset_matches_jax():
    Bsz, T = 96, 6
    jenv, jst, penv, pst = _fetch_case(Bsz, 0)
    jpool = jenv.make_pool(jax.random.PRNGKey(8), 16)
    j_rows = j_presample(jax.random.PRNGKey(9), jpool, T)
    p_rows = B.pool_from_states(export(j_rows))
    assert set(p_rows.extra) == {"target_type", "target_color"}
    step = jax.jit(lambda k, s, a, r: j_autoreset_presampled(jenv, k, s, a,
                                                             r))
    actions = action_stream("interact", T, Bsz, seed=2)
    n_done = 0
    for t in range(T):
        jk, pk = _keys(80 + t, Bsz)
        jo, jst, jr, jte, jtr, _ = step(jk, jst, jnp.asarray(actions[t]),
                                        jax.tree.map(lambda x: x[t], j_rows))
        po, pst, pr, pte, ptr, _ = penv.step_autoreset_presampled(
            pk, pst, torch.from_numpy(actions[t]), p_rows.rows(t))
        msg = f"pooled step {t}"
        np.testing.assert_array_equal(po["packed"].numpy(),
                                      np.asarray(jo["packed"]), err_msg=msg)
        assert_state_equal(pst, jst, ALL_FIELDS, msg=msg)
        # XLA:CPU contracts this program's 1 - 0.9 * (t / max_steps) into a
        # fused multiply-add, which rounds once where the port (and the
        # JAX step alone, above) round twice: the last bit may differ
        np.testing.assert_allclose(pr.numpy(), np.asarray(jr), rtol=1e-6)
        np.testing.assert_array_equal((pte | ptr).numpy(),
                                      np.asarray(jte | jtr))
        n_done += int((pte | ptr).sum())
    assert n_done >= Bsz


def test_fetch_fresh_autoreset_matches_jax():
    Bsz, T, window = 96, 6, 8
    jenv, jst, penv, pst = _fetch_case(Bsz, 1)
    jbuf = jax.jit(lambda k: jenv.presample_fresh(k, 120))(
        jax.random.PRNGKey(10))
    pbuf = export(jbuf)
    step = jax.jit(lambda k, s, a, c: j_autoreset_fresh(jenv, k, s, a, jbuf,
                                                        c, window))
    jc, pc = jnp.asarray(0, jnp.int32), torch.tensor(0, dtype=torch.int32)
    actions = action_stream("uniform", T, Bsz, seed=3)
    overflow = 0
    for t in range(T):
        jk, pk = _keys(90 + t, Bsz)
        jo, jst, jr, jte, jtr, jinfo, jc = step(jk, jst,
                                               jnp.asarray(actions[t]), jc)
        po, pst, pr, pte, ptr, pinfo, pc = penv.step_autoreset_fresh(
            pk, pst, torch.from_numpy(actions[t]), pbuf, pc, window)
        msg = f"fresh step {t}"
        np.testing.assert_array_equal(po["packed"].numpy(),
                                      np.asarray(jo["packed"]), err_msg=msg)
        assert_state_equal(pst, jst, ALL_FIELDS, msg=msg)
        np.testing.assert_array_equal(pr.numpy(), np.asarray(jr))
        assert int(pc) == int(jc)
        assert int(pinfo["reset_overflow"]) == int(jinfo["reset_overflow"])
        overflow += int(pinfo["reset_overflow"])
    assert int(pc) >= Bsz and overflow > 0


def test_fetch_regen_autoreset_matches_jax_given_candidates():
    """JAX ``step_autoreset`` (the regen reset) against the port's select
    given the same candidates: JAX's own fresh layouts, regenerated from
    the reset half of each step key."""
    Bsz, T = 96, 4
    jenv, jst, penv, pst = _fetch_case(Bsz, 2)
    step = jax.jit(jax.vmap(jenv.step_autoreset))
    cands = jax.jit(jax.vmap(
        lambda k: jenv._gen_grid(jax.random.split(k)[1])))
    actions = action_stream("interact", T, Bsz, seed=4)
    for t in range(T):
        jk, pk = _keys(100 + t, Bsz)
        jo, jst, jr, jte, jtr, _ = step(jk, jst, jnp.asarray(actions[t]))
        po, pst, pr, pte, ptr, _ = B.autoreset_step_select(
            penv, pst, torch.from_numpy(actions[t]), export(cands(jk)), pk)
        msg = f"regen step {t}"
        np.testing.assert_array_equal(po["packed"].numpy(),
                                      np.asarray(jo["packed"]), err_msg=msg)
        assert_state_equal(pst, jst, ALL_FIELDS, msg=msg)
        np.testing.assert_array_equal(pr.numpy(), np.asarray(jr))


def test_pooled_rollout_carries_per_episode_mission_counts():
    """A Fetch rollout with pooled resets (the hook path) carries each
    env's mission counts from its reset row: the counts the policy saw
    equal those of the mission each env held, replayed step by step."""
    env = minigrid_tpu_torch.make("MiniGrid-Fetch-5x5-N2-v0",
                                  device=CPU).packed()
    g = env.generator(11)
    pool = env.make_pool(g, 16)
    obs, st = env.reset_staggered(g, 48)
    st = st.replace(step_count=torch.clamp(st.step_count, min=env.params
                                           .max_steps - 6))
    model = init_params(ActorCritic(hidden=32, dtype=torch.float32,
                                    device=CPU), g)
    noise = sample_rollout_noise(g, pool, 48, 8, model.num_actions)
    st0, obs0 = st, obs
    _, _, traj, _ = rollout(model, env, st, obs, noise)
    st, obs = st0, obs0
    n_new = 0
    for t in range(8):
        want = mission_counts(obs["mission"])
        assert torch.equal(traj.obs["mission_counts"][t], want), t
        obs, st2, r, te, tr, _ = env.step_autoreset_presampled(
            noise.step_keys[t], st, traj.action[t], noise.reset_rows.rows(t))
        done = te | tr
        n_new += int((done & (obs["mission"] != st.mission).any(1)).sum())
        assert torch.equal(r, traj.reward[t]) and torch.equal(done,
                                                              traj.done[t])
        st = st2
    assert n_new > 0  # some reset changed an env's mission


# --- pools and the hook path's mechanics ------------------------------------

def test_pool_round_trip_with_extra():
    _, jenv, _, penv, pst = batches("gotodoor")
    pool = B.pool_from_states(pst)
    back = B.states_from_pool(pool)
    for k, v in pst.tensors().items():
        if k != "rng":
            assert torch.equal(back.tensors()[k], v), k
    assert (back.rng == 0).all()
    idx = torch.tensor([3, 0, 7])
    rows = pool.rows(idx)
    assert torch.equal(rows.extra["target_pos"],
                       pst.extra["target_pos"][idx])
    assert rows.to(CPU).extra["target_pos"].dtype == torch.int32
    one = pool.entry(5)
    assert torch.equal(one.extra["target_pos"][0],
                       pst.extra["target_pos"][5])
    jpool = jenv.make_pool(jax.random.PRNGKey(12), 10)
    entries = [jax.tree.map(np.asarray, jpool.entry(i)) for i in range(10)]
    ppool = layout_pool_from_entries(entries, CPU)
    for i in (0, 9):
        assert_state_equal(ppool.entry(i), jax.tree.map(
            lambda x: x[None], jpool.entry(i)), ALL_FIELDS[:-2] + ("extra",))
    # the select carries extra: a broadcast row into the finished envs
    done = torch.arange(N) % 3 == 0
    cand = B.broadcast_candidates(torch.zeros((N, 2), dtype=torch.int32),
                                  pool.rows(2))
    sel = B.select_reset_states(done, pst, cand)
    tp = sel.extra["target_pos"]
    assert (tp[done] == pst.extra["target_pos"][2]).all()
    assert torch.equal(tp[~done], pst.extra["target_pos"][~done])


def test_step_hooks_route_every_family():
    hooked = {"DynamicObstaclesEnv", "FetchEnv", "GoToDoorEnv",
              "GoToObjectEnv", "MemoryEnv", "PutNearEnv", "RedBlueDoorEnv",
              # the RoomGrid families' success tests
              "UnlockEnv", "UnlockPickupEnv", "BlockedUnlockPickupEnv",
              "KeyCorridorEnv", "ObstructedMaze_1Dlhb", "ObstructedMaze_Full"}
    for env_id in minigrid_tpu_torch.registered_ids():
        env = minigrid_tpu_torch.make(env_id, device=CPU)
        # every BabyAI level: its verifier is a step hook
        want = (type(env).__name__ in hooked or env_id.startswith("BabyAI-"))
        assert has_step_hooks(env) == want, env_id
        if has_step_hooks(env):
            with pytest.raises(NotImplementedError, match="overrides"):
                require_core_dynamics(env)


class _Turning(EmptyEnv):
    """An env whose _post_step returns a new state (it turns the agent):
    ``step`` must observe it again rather than keep the step entry's
    observation."""

    def _post_step(self, prev, state, action, reward, terminated):
        return (state.replace(agent_dir=(state.agent_dir + 1) % 4), reward,
                terminated)


def test_step_observes_again_when_post_step_replaces_the_state():
    env = _Turning(size=6, agent_start_pos=None, device=CPU).packed()
    g = env.generator(0)
    _, st = env.reset(g, 64)
    keys = B.random_keys(g, (64, 2), CPU)
    a = torch.from_numpy(action_stream("uniform", 1, 64)[0])
    obs, new, *_ = env.step(keys, st, a)
    assert torch.equal(obs["packed"], fused_observe(env.params, new))
    core = EmptyEnv(size=6, agent_start_pos=None, device=CPU).packed()
    o2, s2, *_ = core.step(keys, st, a)
    assert torch.equal(s2.agent_dir, (new.agent_dir - 1) % 4)
    assert not torch.equal(o2["packed"], obs["packed"])


def test_eval_draws_step_keys_from_the_generator():
    """Dynamic-Obstacles reads its step keys: the evaluation draws them
    from its generator every step (past the reset's draws)."""
    from minigrid_tpu_torch.models.eval import evaluate_success

    env = minigrid_tpu_torch.make("MiniGrid-Dynamic-Obstacles-5x5-v0",
                                  device=CPU)
    model = ActorCritic(hidden=16, device=CPU)
    g, after_reset = env.generator(0), env.generator(0)
    env.reset(after_reset, 32)
    rate = evaluate_success(env, model, 32, g, max_steps=10,
                            require_all_done=False)
    assert 0.0 <= rate <= 1.0
    assert not torch.equal(g.get_state(), after_reset.get_state())
