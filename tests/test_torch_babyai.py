"""The port's BabyAI stack (minigrid_tpu_torch/envs/babyai) against the JAX
package:

- ``match_mask``, ``pack_mask``/``unpack_mask``, ``verify`` (both
  done-action modes), ``surface_tokens``, ``num_navs_needed``,
  ``_validate`` and ``check_objs_reachable`` bit-exact, on JAX-exported
  grids and instructions and on the port's own levels converted to JAX;
- the level step through the hook path (the verifier as ``_post_step``
  around the fused step) bit-exact against JAX ``step_state`` on the same
  states, covering the four leaf kinds, the four root kinds, strict
  failures, the carried start and the done-action mode;
- generation invariants on each of the 96 IDs;
- layouts by chi-square against JAX draws on GoToObj, GoToLocal and
  PutNextLocal (the LevelGen level is in tests/test_torch_levelgen.py);
- the JAX behaviours the port keeps: a level still invalid after the 64
  retries keeps its last attempt, and ``reset_staggered`` draws the offset
  below the 2^30 budget sentinel;
- the fresh-buffer auto-reset of a level bit-exact against JAX, and the
  nested ``extra`` across ``convert``."""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import minigrid_tpu
from minigrid_tpu.core.obs import gen_obs as j_gen_obs
from minigrid_tpu.core.step import step_core as j_step_core
from minigrid_tpu.envs.babyai.core import instrs as JI
from minigrid_tpu.envs.babyai.core import level as JL
from minigrid_tpu.envs.babyai.core import levelgen as JLG
from minigrid_tpu.core import roomgrid as JRG
from minigrid_tpu.envs.base import autoreset_step_fresh as j_autoreset_fresh

import minigrid_tpu_torch
from minigrid_tpu_torch.convert import flatten_extra, layout_pool_from_entries
from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import roomgrid as RG
from minigrid_tpu_torch.core.mission import ID_TO_WORD, detokenize
from minigrid_tpu_torch.envs.babyai.core import instrs as I
from minigrid_tpu_torch.envs.babyai.core import level as L
from minigrid_tpu_torch.envs.babyai.core import levelgen as LG
from minigrid_tpu_torch.envs.babyai.levels import GoToObj
from minigrid_tpu_torch.envs.babyai.core import post_step as PS
from minigrid_tpu_torch.envs.base import has_step_hooks
from minigrid_tpu_torch.ops import native
from minigrid_tpu_torch.ops.fused_step import (fused_rollout,
                                               require_core_dynamics)

from minigrid_tpu_torch.utils import trace
from tests.torch_port_utils import (share_cpu,  # noqa: F401
                                    ALL_FIELDS, CPU, action_stream,
                                    assert_state_equal, categories,
                                    chi2_same_distribution, export,
                                    jax_env_fns, jax_layouts, reachable,
                                    to_jax_instr, to_jax_state)

pytestmark = pytest.mark.usefixtures("share_cpu")

BABYAI_IDS = [i for i in minigrid_tpu_torch.registered_ids()
              if i.startswith("BabyAI-")]
N = 1000  # layouts per side for the chi-square tests
JAX_BATCHES = {"gotoobj": "BabyAI-GoToObj-v0",
               "gotolocal": "BabyAI-GoToLocal-v0",
               "putnextlocal": "BabyAI-PutNextLocal-v0"}
# levels stepped through the hook path: all leaf kinds (goto, open,
# pickup, putnext) and root kinds (action, and, before, after), strict
# failures (Debug) and a carried start
STEP_LEVELS = ["BabyAI-GoToObj-v0", "BabyAI-OpenDoorsOrderN4-v0",
               "BabyAI-PutNextLocal-v0", "BabyAI-GoToSeq-v0",
               "BabyAI-SynthSeq-v0", "BabyAI-PickupDistDebug-v0",
               "BabyAI-PutNextS5N2Carrying-v0"]
_CACHE: dict = {}


def jax_batch(name):
    """(JAX env, N JAX layouts, the port's export of them)."""
    if name not in _CACHE:
        jenv, jst = jax_layouts(JAX_BATCHES[name], N, seed=3)
        _CACHE[name] = (jenv, jst, export(jst))
    return _CACHE[name]


def port_levels(env_id, n=64, seed=0):
    """(port env, n of its levels), generated once per module."""
    key = ("port", env_id, n, seed)
    if key not in _CACHE:
        env = minigrid_tpu_torch.make(env_id, device=CPU).packed()
        _CACHE[key] = (env, env._gen_grid(env.generator(seed), n))
    return _CACHE[key]


def _keys(seed, n):
    k = np.array(jax.random.split(jax.random.PRNGKey(seed), n))
    return jnp.asarray(k), torch.from_numpy(k.view(np.int32))


def _port_instr(state) -> I.InstrState:
    return I.InstrState.from_extra(state.extra)


def _jax_instr(state):
    return to_jax_instr({k: v for k, v in state.extra.items()
                         if k.startswith("instr.")})


def _assert_instr_equal(port: I.InstrState, ref, msg=""):
    want = flatten_extra({"instr": ref})
    got = port.to_extra()
    assert set(got) == set(want), msg
    for k, v in want.items():
        assert got[k].numpy().dtype == v.dtype, f"{msg} {k}"
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=f"{msg} {k}")


# --- the instruction encoding on JAX-exported data ------------------------------

def test_pack_and_unpack_match_jax():
    rng = np.random.default_rng(0)
    for W, H in ((8, 8), (22, 22), (24, 9)):
        mask = rng.random((5, 8, W, H)) < 0.3
        want = np.asarray(jax.vmap(JI.pack_mask)(jnp.asarray(mask)))
        got = I.pack_mask(torch.from_numpy(mask))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want.view(np.int32))
        np.testing.assert_array_equal(I.unpack_mask(got, W).numpy(), mask)
        np.testing.assert_array_equal(
            np.asarray(JI.unpack_mask(jnp.asarray(want), W)), mask)
    with pytest.raises(ValueError, match="width"):
        I.pack_mask(torch.zeros((1, 25, 4), dtype=torch.bool))


@pytest.mark.parametrize("name", ["gotolocal", "putnextlocal"])
def test_match_mask_matches_jax(name):
    """Random (type, colour, location) descriptors, the location words in
    the agent's room, on exported grids."""
    jenv, jst, pst = jax_batch(name)
    B = 256
    rng = np.random.default_rng(1)
    d = [rng.integers(0, hi, B).astype(np.int32) for hi in (5, 7, 5)]
    jl = JRG.RoomLayout(jenv.layout.room_size, jenv.layout.num_rows,
                        jenv.layout.num_cols)

    def one(g, pos, dr, t, c, lc):
        ri, rj = jl.room_from_pos(pos)
        return JI.match_mask(g, pos, dr, jl.room_rect_mask(ri, rj), t, c, lc)

    want = jax.jit(jax.vmap(one))(jst.grid[:B], jst.agent_pos[:B],
                                  jst.agent_dir[:B],
                                  *(jnp.asarray(x) for x in d))
    pl = minigrid_tpu_torch.make(JAX_BATCHES[name], device=CPU).layout
    ri, rj = pl.room_from_pos(pst.agent_pos[:B])
    got = I.match_mask(pst.grid[:B], pst.agent_pos[:B], pst.agent_dir[:B],
                       pl.room_rect_mask(ri, rj), *(torch.from_numpy(x)
                                                    for x in d))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.any() and not got.all()


@pytest.mark.parametrize("name", ["gotolocal", "putnextlocal"])
def test_surface_tokens_and_num_navs_match_jax(name):
    """On the exported instructions: the mission JAX generated, its
    surface form and budget factor."""
    jenv, jst, pst = jax_batch(name)
    instr = _port_instr(pst)
    np.testing.assert_array_equal(I.surface_tokens(instr).numpy(),
                                  np.asarray(jst.mission))
    want = jax.vmap(JI.num_navs_needed)(jst.extra["instr"])
    got = I.num_navs_needed(instr)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("level", ["BabyAI-SynthSeq-v0", "BabyAI-BossLevel-v0",
                                   "BabyAI-OpenDoorsOrderN4-v0"])
def test_surface_tokens_of_port_levels_match_jax(level):
    """The port's instruction trees (every root kind) through JAX's
    ``surface_tokens`` and ``num_navs_needed``."""
    _, pst = port_levels(level)
    jinstr = _jax_instr(pst)
    np.testing.assert_array_equal(
        pst.mission.numpy(), np.asarray(jax.vmap(JI.surface_tokens)(jinstr)))
    np.testing.assert_array_equal(
        I.num_navs_needed(_port_instr(pst)).numpy(),
        np.asarray(jax.vmap(JI.num_navs_needed)(jinstr)))
    roots = set(pst.extra["instr.root_kind"].tolist())
    if level != "BabyAI-OpenDoorsOrderN4-v0":
        assert len(roots) >= 3


def _jax_verify(params, mode):
    key = ("verify", params, mode)
    if key not in _CACHE:
        _CACHE[key] = jax.jit(jax.vmap(
            lambda i, p, n, a: JI.verify(params, i, p, n, a, mode)))
    return _CACHE[key]


@pytest.mark.parametrize("mode", [False, True])
def test_verify_matches_jax_on_exported_states(mode):
    """JAX core steps of exported PutNextLocal levels, then ``verify`` in
    both packages on the same (instruction, previous, new, action), for
    24 steps (statuses and every InstrState field)."""
    jenv, jst, pst = jax_batch("putnextlocal")
    B = 256
    jst = jax.tree.map(lambda x: x[:B], jst)
    jinstr = jst.extra["instr"]
    pinstr = _port_instr(export(jst))
    step = jax.jit(jax.vmap(lambda s, a: j_step_core(jenv.params, s, a)[0]))
    ver = _jax_verify(jenv.params, mode)
    acts = action_stream("interact" if not mode else "uniform", 24, B, 7)
    statuses, carried = set(), 0
    for t in range(24):
        a = jnp.asarray(acts[t])
        jnew = step(jst, a)
        js, jinstr = ver(jinstr, jst, jnew, a)
        ps, pinstr = I.verify(jenv.params, pinstr, export(jst), export(jnew),
                              torch.from_numpy(acts[t]), mode)
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
        _assert_instr_equal(pinstr, jinstr, f"step {t}")
        statuses |= set(ps.tolist())
        carried += int(pinstr.descs.carried.sum())
        jst = jnew
    assert carried > 0  # objects tracked through the agent's hands
    if mode:
        assert I.FAILURE in statuses  # 'done' without a match


def test_validate_and_reachability_match_jax():
    """Raw attempts (before validation) of BossLevel (locked colours,
    putnext), PutNextLocal and UnblockPickup: ``_validate`` and
    ``check_objs_reachable`` against JAX's on the same builders."""
    for level in ("BabyAI-BossLevel-v0", "BabyAI-PutNextLocal-v0",
                  "BabyAI-UnblockPickup-v0"):
        env = minigrid_tpu_torch.make(level, device=CPU)
        jenv = minigrid_tpu.make(level)
        g = env.generator(5)
        b, spec, _ = env.gen_mission(g, env.builder(g, 128))
        instr = env._instr_from_spec(spec, b)
        jb = JRG.Builder(**{k: jnp.asarray(v.numpy())
                            for k, v in b.tensors().items()})
        jinstr = to_jax_instr(instr.to_extra())
        ok = env._validate(b, instr)
        np.testing.assert_array_equal(ok.numpy(), np.asarray(
            jax.jit(jax.vmap(jenv._validate))(jb, jinstr)), err_msg=level)
        reach = L.check_objs_reachable(b)
        np.testing.assert_array_equal(reach.numpy(), np.asarray(
            jax.jit(jax.vmap(JL.check_objs_reachable))(jb)), err_msg=level)
        assert reach.any() and not reach.all(), level
        if level != "BabyAI-UnblockPickup-v0":
            assert ok.any() and not ok.all(), level


# --- the level step through the hook path -----------------------------------------

def _jax_level_step(jenv, mode):
    key = ("step", jenv, mode)
    if key not in _CACHE:
        def one(k, s, a):
            ns, r, te, tr = jenv.step_state(k, s, a)
            return j_gen_obs(jenv.params, ns)["packed"], ns, r, te, tr

        _CACHE[key] = jax.jit(jax.vmap(one))
    return _CACHE[key]


def _check_level_steps(level, kind, T=24, mode=False):
    penv, pst = port_levels(level)
    jenv = jax_env_fns(level)[0]  # one JAX env a level: its step jits once
    jst = to_jax_state(pst)
    step = _jax_level_step(jenv, mode)
    acts = action_stream(kind, T, pst.batch_size, seed=11)
    ends = statuses = 0
    for t in range(T):
        jk, pk = _keys(20 + t, pst.batch_size)
        a = torch.from_numpy(acts[t])
        o, jst, r, te, tr = step(jk, jst, jnp.asarray(acts[t]))
        if t % 2:
            po, pst, pr, pte, ptr, _ = penv.step(pk, pst, a)
        else:
            pst, pr, pte, ptr = penv.step_state(pk, pst, a)
            po = {"packed": penv._observe(pst)["packed"]}
        msg = f"{level} {kind} step {t}"
        np.testing.assert_array_equal(po["packed"].numpy(), np.asarray(o),
                                      err_msg=msg)
        assert_state_equal(pst, jst, ALL_FIELDS, msg=msg)
        for got, want in ((pr, r), (pte, te), (ptr, tr)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=msg)
        ends += int(np.asarray(te).sum())
        statuses += int((np.asarray(te) & (np.asarray(r) == 0)).sum())
    # CPU tensors take the plain version: no post-step kernel launch
    assert trace.counters()["kernel.verify_launches"] == 0
    return ends, statuses


@pytest.mark.parametrize("level", STEP_LEVELS)
@pytest.mark.parametrize("kind", ["uniform", "interact"])
def test_level_step_matches_jax(level, kind):
    """24 steps of ``step``/``step_state`` (the hook path) on the port's
    levels converted to JAX: observation, every field with the nested
    ``extra``, reward, terminated and the dynamic-budget truncation
    bit-exact."""
    ends, failures = _check_level_steps(level, kind)
    if kind == "interact" and level in ("BabyAI-GoToObj-v0",
                                        "BabyAI-OpenDoorsOrderN4-v0"):
        assert ends > 0, level
    if level == "BabyAI-PickupDistDebug-v0" and kind == "interact":
        assert failures > 0  # strict pickups of the wrong object


@pytest.mark.parametrize("level", ["BabyAI-PutNextLocal-v0",
                                   "BabyAI-SynthSeq-v0"])
def test_level_step_in_done_action_mode_matches_jax(level, monkeypatch):
    """BABYAI_DONE_ACTIONS: success and failure only on ``done``."""
    monkeypatch.setattr(L, "USE_DONE_ACTIONS", True)
    monkeypatch.setattr(JL, "USE_DONE_ACTIONS", True)
    ends, _ = _check_level_steps(level, "uniform", mode=True)
    assert ends > 0


def test_truncation_at_the_dynamic_budget():
    penv, pst = port_levels("BabyAI-GoToSeq-v0")
    ms = pst.extra["max_steps"]
    st = pst.replace(step_count=ms - 1 - (torch.arange(64) % 2))
    _, new, _, te, tr, _ = penv.step(_keys(3, 64)[1], st,
                                     torch.full((64,), 0))
    np.testing.assert_array_equal(tr.numpy(), np.arange(64) % 2 == 0)
    assert penv.params.max_steps == 1 << 30


@pytest.mark.parametrize("done_actions", [False, True])
@pytest.mark.parametrize("level", ["BabyAI-GoToObj-v0",
                                   "BabyAI-PutNextLocal-v0",
                                   "BabyAI-SynthSeq-v0",
                                   "BabyAI-PickupDistDebug-v0"])
def test_post_step_on_cpu_is_the_plain_verifier(level, done_actions,
                                                monkeypatch):
    """On CPU tensors a level's ``_post_step`` runs the plain version
    (``babyai_post_step_reference``) in the done-action mode set, never the
    kernel's wrapper, and launches nothing (``kernel.verify_launches`` reads
    0); it writes no input in place, and every state it writes is one the
    kernel takes: its inputs pass the kernel's device, dtype, shape and
    contiguity checks (``native.check``) at each of 12 steps."""
    monkeypatch.setattr(L, "USE_DONE_ACTIONS", done_actions)
    plain, modes = PS.babyai_post_step_reference, []

    def counted(*a):
        modes.append(a[-1])
        return plain(*a)

    def kernel(*a):
        raise AssertionError("the kernel's wrapper ran on CPU tensors")

    monkeypatch.setattr(PS, "babyai_post_step_reference", counted)
    monkeypatch.setattr(PS, "_babyai_post_step_cuda", kernel)
    penv, st = port_levels(level)
    B, W, H = st.batch_size, penv.params.width, penv.params.height
    acts = action_stream("interact" if not done_actions else "uniform", 12,
                         B, seed=5)
    ended = 0
    for t in range(12):
        a = torch.from_numpy(acts[t])
        new, _, reward, term, _ = fused_rollout(penv.params, st, a[None])
        inputs = PS._inputs(st, new, a, reward[0], term[0])
        native.check(inputs, PS._specs(B, W, H))
        before = [x.clone() for x in inputs]
        got, _, got_te = penv._post_step(st, new, a, reward[0], term[0])
        for x, y in zip(inputs, before):
            assert torch.equal(x, y), t
        ended += int((got_te & ~term[0]).sum())
        st = got.replace(terminated=got_te)
    assert modes == [done_actions] * 12
    # a put-next seldom succeeds in 12 steps and never fails unstrict
    assert ended > 0 or (level, done_actions) == ("BabyAI-PutNextLocal-v0",
                                                  False)
    assert trace.counters()["kernel.verify_launches"] == 0


def test_post_step_routes_by_device_and_checks_the_kernel_inputs():
    """``babyai_post_step`` takes CPU or CUDA tensors only; the kernel's
    input checks (``native.check`` of device, dtype, shape and contiguity
    every call, the packed width) hold on the CPU, and its pointer table
    is the inputs and its six outputs."""
    penv, st = port_levels("BabyAI-PutNextLocal-v0")
    a = torch.zeros(st.batch_size, dtype=torch.int32)
    new, _, reward, term, _ = fused_rollout(penv.params, st, a[None])
    args = [st, new, a, reward[0], term[0]]
    meta = [x.map(lambda t: t.to("meta")) for x in args[:2]] + [
        x.to("meta") for x in args[2:]]
    with pytest.raises(ValueError, match="cpu or cuda"):
        PS.babyai_post_step(penv.params, *meta, False)
    B, W, H = st.batch_size, penv.params.width, penv.params.height
    specs = PS._specs(B, W, H)
    native.check(PS._inputs(*args), specs)
    bad = st.replace(extra={**st.extra, "max_steps":
                            st.extra["max_steps"].long()})
    with pytest.raises(ValueError, match="max_steps must be torch.int32"):
        native.check(PS._inputs(bad, *args[1:]), specs)
    with pytest.raises(ValueError, match="packed widths"):
        PS._specs(B, 25, H)
    strided = st.replace(agent_pos=st.agent_pos.t().contiguous().t())
    with pytest.raises(ValueError, match="contiguous"):
        native.check(PS._inputs(strided, *args[1:]), specs)
    src = PS.SOURCE.read_text()
    assert f"kPointers = {len(PS._specs(B, W, H)) + 6};" in src


def test_levels_route_through_the_hook_path():
    for level in BABYAI_IDS:
        env = minigrid_tpu_torch.make(level, device=CPU)
        assert has_step_hooks(env), level
        with pytest.raises(NotImplementedError, match="overrides"):
            require_core_dynamics(env)


# --- generation ---------------------------------------------------------------------

REACHABLE_LEVELS = {"GoToRedBallGrey", "GoToRedBall", "GoToRedBallNoDists",
                    "GoToLocal", "GoTo", "GoToRedBlueBall", "GoToObjDoor",
                    "Open", "Pickup", "PutNextLocal", "Unlock", "GoToSeq"}
# doors locked at random with no key (add_door's coin, goto.py)
KEYLESS_LOCKS = {"GoToDoorLevel", "GoToObjDoor"}
TYPE_OF = {0: C.BOX, 1: C.BALL, 2: C.KEY, 3: C.DOOR}


def _num_navs(kinds, root, a_and, b_and):
    per = np.where(kinds == I.PUTNEXT, 2, np.where(kinds == I.UNUSED, 0, 1))
    act = np.stack([np.ones_like(a_and), a_and, np.ones_like(a_and), b_and],
                   1).astype(int)
    act = np.where((root == I.ROOT_ACTION)[:, None], [1, 0, 0, 0],
                   np.where((root == I.ROOT_AND)[:, None], [1, 1, 0, 0], act))
    return (per * act).sum(1)


@pytest.mark.parametrize("level", BABYAI_IDS)
def test_generation_invariants(level):
    """16 levels of each ID: the mission is the instruction's surface form
    and reads as words; each active descriptor tracks exactly the matching
    objects and at least one; objects reachable where validation asks it;
    every locked door has its key; the dynamic budget."""
    env = minigrid_tpu_torch.make(level, device=CPU)
    g = env.generator(1)
    st, ok, attempts = env.generate(g, 16)
    name = type(env).__name__
    ex = {k: v.numpy() for k, v in st.extra.items()}
    grid = st.grid.numpy()
    instr = _port_instr(st)
    np.testing.assert_array_equal(st.mission.numpy(),
                                  I.surface_tokens(instr).numpy())
    for b in range(16):
        words = detokenize(st.mission[b].numpy()).split()
        assert words[0] in ("go", "pick", "open", "put"), (level, words)
        assert all(int(t) in ID_TO_WORD for t in st.mission[b] if t)
    masks = I.unpack_mask(instr.descs.mask_objs, env.params.width).numpy()
    kinds = ex["instr.kinds"]
    for b in np.flatnonzero(ok.numpy()):
        for slot in range(8):
            leaf = kinds[b, slot // 2]
            if leaf == I.UNUSED or (slot % 2 and leaf != I.PUTNEXT):
                continue
            t, c = ex["instr.descs.type"][b, slot], ex["instr.descs.color"][
                b, slot]
            m = masks[b, slot]
            assert ex["instr.descs.count"][b, slot] >= 1, (level, b, slot)
            cells = grid[b][m]
            assert (cells[:, 0] != C.EMPTY).all()
            if t != I.TYPE_NONE:
                assert (cells[:, 0] == TYPE_OF[int(t)]).all()
            if c != I.COLOR_NONE:
                assert (cells[:, 1] == c).all()
            if ex["instr.descs.loc"][b, slot] == I.LOC_NONE and not \
                    ex["instr.descs.carried"][b, slot]:
                want = (grid[b][..., 0] != C.EMPTY)
                if t != I.TYPE_NONE:
                    want &= grid[b][..., 0] == TYPE_OF[int(t)]
                if c != I.COLOR_NONE:
                    want &= grid[b][..., 1] == c
                np.testing.assert_array_equal(m, want, err_msg=level)
        objs = ~np.isin(grid[b][..., 0], [C.EMPTY, C.WALL])
        seen = reachable(grid[b], st.agent_pos[b], (C.EMPTY, C.DOOR))
        grow = seen.copy()  # objects next to a reached cell are reached
        grow[1:] |= seen[:-1]
        grow[:-1] |= seen[1:]
        grow[:, 1:] |= seen[:, :-1]
        grow[:, :-1] |= seen[:, 1:]
        if name in REACHABLE_LEVELS:
            assert grow[objs].all(), (level, b)
        if name == "UnblockPickup":
            assert not grow[objs].all(), (level, b)
        if name not in KEYLESS_LOCKS:
            t = grid[b][..., 0]
            for x, y in np.argwhere((t == C.DOOR)
                                    & (grid[b][..., 2] == C.LOCKED)):
                col = grid[b][x, y, 1]
                assert ((t == C.KEY) & (grid[b][..., 1] == col)).any() or (
                    (grid[b][..., 3] == C.KEY)
                    & (grid[b][..., 4] == col)).any(), (level, b)
    Lt = env.layout
    if env.fixed_max_steps:
        assert (ex["max_steps"] == env.params.max_steps).all()
    else:
        want = _num_navs(kinds, ex["instr.root_kind"], ex["instr.a_is_and"],
                         ex["instr.b_is_and"]) * (
            Lt.room_size ** 2 * Lt.num_rows * Lt.num_cols)
        np.testing.assert_array_equal(ex["max_steps"], want)
    assert ex["max_steps"].dtype == np.int32
    assert (attempts >= 1).all() and (attempts <= 65).all()
    assert ex["instr.descs.mask_objs"].dtype == np.int32


def _features(s, W, H):
    g = s["grid"]
    t = g[..., 0]
    obj = np.isin(t, [C.KEY, C.BALL, C.BOX])
    first = obj.reshape(len(g), -1).argmax(1)
    return {"agent": s["pos"][:, 0] * H + s["pos"][:, 1], "dir": s["dir"],
            "n_keys": (t == C.KEY).sum((1, 2)),
            "n_balls": (t == C.BALL).sum((1, 2)),
            "first_obj": first, "first_color": g.reshape(len(g), -1, 5)[
                np.arange(len(g)), first, 1]}


@pytest.mark.parametrize("name", sorted(JAX_BATCHES))
def test_distribution_matches_jax(name):
    jenv, jst, _ = jax_batch(name)
    penv, pst = port_levels(JAX_BATCHES[name], N, seed=4)
    W, H = jenv.params.width, jenv.params.height
    js = {"grid": np.asarray(jst.grid), "pos": np.asarray(jst.agent_pos),
          "dir": np.asarray(jst.agent_dir), "mission": np.asarray(jst.mission)}
    ps = {"grid": pst.grid.numpy(), "pos": pst.agent_pos.numpy(),
          "dir": pst.agent_dir.numpy(), "mission": pst.mission.numpy()}
    jf, pf = _features(js, W, H), _features(ps, W, H)
    jf["mission"], pf["mission"] = categories(js["mission"], ps["mission"])
    for k in jf:
        p = chi2_same_distribution(jf[k], pf[k])
        assert p > 1e-3, (name, k, p)


# --- the JAX behaviours the port keeps ------------------------------------------

class _NeverValid(GoToObj):
    """GoToObj whose attempts are never valid; records each attempt's
    agent position."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.seen = []

    def gen_mission(self, generator, b):
        b, spec, ok = super().gen_mission(generator, b)
        self.seen.append(b.agent_pos.clone())
        return b, spec, torch.zeros_like(ok)


def test_a_level_never_valid_keeps_its_last_attempt():
    """JAX level.py:264-277: after the first attempt and 64 retries an
    invalid level keeps the last attempt (and its ``ok`` is dropped).
    PickupLoc is such a level in both packages: its door descriptor never
    matches in a room without doors."""
    env = _NeverValid(device=CPU)
    st, ok, attempts = env.generate(env.generator(0), 8)
    assert not ok.any() and (attempts == 65).all() and len(env.seen) == 65
    assert torch.equal(st.agent_pos, env.seen[-1])
    pick = minigrid_tpu_torch.make("BabyAI-PickupLoc-v0", device=CPU)
    _, ok, attempts = pick.generate(pick.generator(0), 4)
    assert not ok.any() and (attempts == 65).all()
    b = pick.builder(pick.generator(1), 64)
    _, door_ok = LG.rand_obj(b, pick.layout, pick.generator(2),
                             types=LG.DOOR_ONLY)
    jenv = minigrid_tpu.make("BabyAI-PickupLoc-v0")
    _, jok = jax.jit(jax.vmap(lambda k: JLG.rand_obj(
        JRG.init_builder(jenv.layout, k), jenv.layout, k,
        types=JLG.DOOR_ONLY)))(jax.random.split(jax.random.PRNGKey(0), 64))
    assert not door_ok.any() and not np.asarray(jok).any()


def test_reset_staggered_draws_below_the_budget_sentinel():
    """JAX base.py:536-539 draws the offset from ``params.max_steps``,
    2^30 for a dynamic budget: every env then truncates at its first
    step, in both packages."""
    env = minigrid_tpu_torch.make("BabyAI-GoToObj-v0", device=CPU)
    _, st = env.reset_staggered(env.generator(0), 64)
    assert (st.step_count > st.extra["max_steps"]).all()
    _, _, _, _, tr, _ = env.step(_keys(0, 64)[1], st, torch.zeros(64))
    assert tr.all()
    jenv = minigrid_tpu.make("BabyAI-GoToObj-v0")
    _, jst = jax.jit(jax.vmap(jenv.reset_staggered))(
        jax.random.split(jax.random.PRNGKey(0), 64))
    assert (np.asarray(jst.step_count)
            > np.asarray(jst.extra["max_steps"])).all()


# --- resets and conversion ----------------------------------------------------------

def test_fresh_autoreset_matches_jax():
    """GoToObj's fresh-buffer reset on exported states and buffer: every
    field with the nested ``extra`` carried into the finished envs."""
    jenv, jst, _ = jax_batch("gotoobj")
    Bsz, T, window = 96, 6, 8
    buf = jax.tree.map(lambda x: x[Bsz:Bsz + 120], jst)
    ms = np.asarray(jst.extra["max_steps"][:Bsz])
    jst = jax.tree.map(lambda x: x[:Bsz], jst)
    jst = jst.replace(step_count=jnp.asarray(ms - 1 - (np.arange(Bsz) % 6),
                                             jnp.int32))
    pst, pbuf = export(jst), export(buf)
    step = jax.jit(lambda k, s, a, c: j_autoreset_fresh(jenv, k, s, a, buf,
                                                        c, window))
    penv = minigrid_tpu_torch.make("BabyAI-GoToObj-v0", device=CPU).packed()
    jc, pc = jnp.asarray(0, jnp.int32), torch.tensor(0, dtype=torch.int32)
    acts = action_stream("uniform", T, Bsz, seed=3)
    for t in range(T):
        jk, pk = _keys(90 + t, Bsz)
        jo, jst, jr, jte, jtr, jinfo, jc = step(jk, jst,
                                               jnp.asarray(acts[t]), jc)
        po, pst, pr, pte, ptr, pinfo, pc = penv.step_autoreset_fresh(
            pk, pst, torch.from_numpy(acts[t]), pbuf, pc, window)
        msg = f"fresh step {t}"
        np.testing.assert_array_equal(po["packed"].numpy(),
                                      np.asarray(jo["packed"]), err_msg=msg)
        assert_state_equal(pst, jst, ALL_FIELDS, msg=msg)
        np.testing.assert_array_equal(pr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(ptr.numpy(), np.asarray(jtr))
        assert int(pc) == int(jc)
    assert int(pc) >= Bsz


def test_nested_extra_round_trips_through_convert():
    jenv, jst, pst = jax_batch("gotoobj")
    assert pst.extra["instr.descs.mask_objs"].dtype == torch.int32
    assert pst.extra["instr.kinds"].shape == (N, 4)
    back = to_jax_state(pst)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jst)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    entries = [jax.tree.map(lambda x: np.asarray(x[i]), jst)
               for i in range(8)]
    pool = layout_pool_from_entries(entries, CPU)
    assert set(pool.extra) == set(pst.extra)
    for i in (0, 7):
        e = pool.entry(i)
        for k, v in pst.extra.items():
            assert torch.equal(e.extra[k][0], v[i]), k
