"""The port's wrappers (minigrid_tpu_torch/wrappers) against the JAX
package's, one wrapper at a time, on exported JAX states and the same
actions (the fast paths and training: tests/test_torch_wrapper_paths.py):

- each stateless observation wrapper's reset (from the same layouts) and
  steps against its JAX ``observation`` of JAX's own steps (what JAX's
  ``ObservationWrapper.step`` computes), bit-exact;
- the stateful and transition wrappers and two stacks against
  ``jax.vmap(wrapper.reset/step)``, bit-exact but for the reward (rtol
  1e-6, ``tests/torch_wrapper_utils.py::assert_outputs``);
- the repair: a NoDeath stack steps on the hook path, so an env walking
  into lava keeps its episode under pooled resets;
- StochasticActionWrapper by distribution (threefry is not replayed);
- ReseedWrapper's layouts and cycle order, FlatObs on long missions,
  DirectionObs' zero divisors, ViewSize's bound, the exports and
  ``convert``'s WrappedState round trip."""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from minigrid_tpu import wrappers as JW
from minigrid_tpu.envs.base import presample_reset_states as j_presample

from minigrid_tpu_torch import wrappers as PW
from minigrid_tpu_torch.envs import base as B
from minigrid_tpu_torch.envs.base import has_step_hooks
from minigrid_tpu_torch.ops.fused_step import require_core_dynamics

from tests.torch_port_utils import (share_cpu,  # noqa: F401
                                    action_stream, doorkey_features, export,
                                    export_state, to_jax_state)
from tests.torch_wrapper_utils import (DOORKEY, NB, OBSERVATION, STEPPED,
                                       T_STEPS, _CACHE, actions_for,
                                       assert_obs_equal, assert_outputs,
                                       assert_wrapped_equal, base_layouts,
                                       envs, jitted, keys_of, reset_both,
                                       stacks, staggered)

pytestmark = pytest.mark.usefixtures("share_cpu")


def base_trajectory(env_id, packed):
    """JAX's base env from its reset layouts through T_STEPS steps of the
    interaction stream: [(JAX keys, port keys, actions, obs, state, reward,
    terminated, truncated)], shared."""
    key = ("trajectory", env_id, packed)
    if key not in _CACHE:
        jenv, _ = envs(env_id, packed)
        _, _, st = base_layouts(env_id, packed)
        step = jax.jit(jax.vmap(jenv.step))
        acts = action_stream("interact", T_STEPS, NB)
        out = []
        for t in range(T_STEPS):
            jk, pk = keys_of(10 + t)
            o, st, r, te, tr, _ = step(jk, st, jnp.asarray(acts[t]))
            out.append((pk, torch.from_numpy(acts[t]), o, st, r, te, tr))
        _CACHE[key] = out
    return _CACHE[key]


@pytest.mark.parametrize("name", list(OBSERVATION))
def test_observation_wrapper_matches_jax(name):
    env_id, packed, _ = OBSERVATION[name]
    jw, pw = stacks(name)
    observe = jitted(name, "observation", lambda w: jax.vmap(w.observation))
    _, obs0, st0 = base_layouts(env_id, packed)
    pobs, pst = pw.reset_from(export(st0))
    assert_obs_equal(pobs, observe(obs0, st0), f"{name} reset")
    for t, (pk, a, o, st, r, te, tr) in enumerate(base_trajectory(env_id,
                                                                  packed)):
        p = pw.step(pk, pst, a)
        assert_outputs(p, (observe(o, st), st, r, te, tr), f"{name} step {t}")
        pst = p[1]


@pytest.mark.parametrize("name", [n for n in STEPPED
                                  if n != "ImgObs(NoDeath)"])
def test_reset_and_step_match_jax(name):
    jw, pw = stacks(name)
    (jobs, jst), (pobs, pst) = reset_both(name)
    assert_obs_equal(pobs, jobs, f"{name} reset obs")
    assert_wrapped_equal(pst, jst, f"{name} reset")
    step = jitted(name, "step", lambda w: jax.vmap(w.step))
    acts = actions_for(name, T_STEPS)
    for t in range(T_STEPS):
        jk, pk = keys_of(10 + t)
        j = step(jk, jst, jnp.asarray(acts[t]))
        p = pw.step(pk, pst, torch.from_numpy(acts[t]))
        assert_outputs(p, j, f"{name} step {t}")
        jst, pst = j[1], p[1]


def test_direction_obs_divides_by_zero_as_jax_does():
    """The reference's swapped coordinates divide by the agent's x minus
    the goal's row: where they are equal the slope is +-inf, or NaN where
    the numerator is 0 too, in the port as in JAX."""
    jw, pw = stacks("DirectionObs")
    (jobs, jst), _ = reset_both("DirectionObs")
    goal = jst.wrapper
    pos = jst.inner.agent_pos
    # half the agents moved to x = the goal's row, a few onto y = its column
    x = jnp.where(jnp.arange(NB) % 2 == 0, goal[:, 0], pos[:, 0])
    y = jnp.where(jnp.arange(NB) % 8 == 0, goal[:, 1], pos[:, 1])
    inner = jst.inner.replace(agent_pos=jnp.stack([x, y], -1))
    want = jax.vmap(jw._augment)(jobs, inner, goal)["goal_direction"]
    got = pw._augment({}, export(inner), torch.from_numpy(np.array(goal)))
    g = got["goal_direction"]
    assert torch.isinf(g).any() and torch.isnan(g).any()
    np.testing.assert_array_equal(g.numpy(), np.asarray(want))


# --- the repair: a transition stack never takes the reset-row entry ---------

def test_nodeath_lava_keeps_the_episode_on_pooled_resets():
    """NoDeath(LavaGapS5) with pooled resets and an action stream that
    walks into lava: an env that walks into lava keeps its episode (it is
    not reset), gets death_cost added to its reward and equals JAX's
    ``jax.vmap(NoDeath.step)`` on the same exported states; the whole
    step equals JAX's pooled step. The stack steps on the hook path."""
    jw, pw = stacks("NoDeath")
    jst, pst = staggered("NoDeath")
    env, _ = pw._fast_base()
    assert has_step_hooks(env) and env.transitions == (pw,)
    with pytest.raises(NotImplementedError, match="NoDeath"):
        require_core_dynamics(env)
    T = 12
    jpool = jw.make_pool(jax.random.PRNGKey(11), 16)
    j_rows = j_presample(jax.random.PRNGKey(12), jpool, T)
    p_rows = B.pool_from_states(export(j_rows))
    pooled = jitted("NoDeath", "presampled",
                    lambda w: w.step_autoreset_presampled)
    plain = jitted("NoDeath", "step", lambda w: jax.vmap(w.step))
    acts = np.where(np.random.default_rng(6).random((T, NB)) < 0.7, 2,
                    action_stream("uniform", T, NB, seed=6)).astype(np.int32)
    lava_walks = 0
    for t in range(T):
        jk, pk = keys_of(70 + t)
        ja = jnp.asarray(acts[t])
        j = pooled(jk, jst, ja, jax.tree.map(lambda x: x[t], j_rows))
        jp = plain(jk, jst, ja)
        p = pw.step_autoreset_presampled(pk, pst, torch.from_numpy(acts[t]),
                                         p_rows.rows(t))
        assert_outputs(p, j, f"pooled step {t}")
        # the penalty was added (and the episode did not truncate)
        walked = (np.asarray(jp[2]) < 0) & ~np.asarray(jp[4])
        lava_walks += int(walked.sum())
        assert not np.asarray(jp[3])[walked].any()
        w = torch.from_numpy(walked)
        assert not (p[3] | p[4])[w].any()       # not reset
        np.testing.assert_array_equal(p[2][w].numpy(),
                                      np.asarray(jp[2])[walked])
        assert (p[2][w] == np.float32(-0.2)).all()
        for k in ("grid", "agent_pos", "agent_dir", "step_count"):
            np.testing.assert_array_equal(
                getattr(p[1], k)[w].numpy(),
                np.asarray(getattr(jp[1], k))[walked], err_msg=k)
        jst, pst = j[1], p[1]
    assert lava_walks >= 10


# --- StochasticActionWrapper ------------------------------------------------

def test_stochastic_action_distribution():
    """Keep rate ``prob``, replacements uniform over 0-5, in the port and
    in JAX, and the two distributions alike (chi-square); two stacked
    layers draw apart; the composed fast path draws what the nested step
    draws."""
    from scipy import stats as sps

    n, prob = 20000, 0.75
    _, penv = envs(DOORKEY, True)
    jenv, _ = envs(DOORKEY, True)
    pw = PW.StochasticActionWrapper(penv, prob=prob)
    jw = JW.StochasticActionWrapper(jenv, prob=prob)
    jk, pk = keys_of(80, n)
    done = torch.full((n,), 6, dtype=torch.int32)
    pa = pw.transform_action(pk, None, done).numpy()
    ja = np.asarray(jax.vmap(lambda k, a: jw.transform_action(
        jax.random.fold_in(k, JW._TA_SALT), None, a))(
            jk, jnp.full((n,), 6, jnp.int32)))
    for a in (pa, ja):
        assert abs((a == 6).mean() - prob) < 4 * np.sqrt(prob * (1 - prob)
                                                         / n)
        counts = np.bincount(a[a != 6], minlength=6)
        assert len(counts) == 6 and sps.chisquare(counts).pvalue > 1e-3
    table = np.stack([np.bincount(pa, minlength=7),
                      np.bincount(ja, minlength=7)])
    assert sps.chi2_contingency(table)[1] > 1e-3
    # two stacked layers with prob 0 always replace, from their own draws
    inner = PW.StochasticActionWrapper(penv, prob=0.0)
    outer = PW.StochasticActionWrapper(inner, prob=0.0)
    assert (inner._t_depth, outer._t_depth) == (0, 1)
    a0 = inner.transform_action(pk, None, done)
    a1 = outer.transform_action(pk, None, done)
    assert 0.7 < (a0 != a1).float().mean() < 0.97
    # the composed path (hooked_step) and the nested step draw alike
    st = export(base_layouts(DOORKEY, True)[2])
    _, pk = keys_of(81)
    a = torch.from_numpy(action_stream("uniform", 1, NB, seed=7)[0])
    env, _ = outer._fast_base()
    composed = B.hooked_step(env, pk, st, a)
    nested = outer.step(pk, st, a)
    for f in ("agent_pos", "agent_dir", "grid"):
        assert torch.equal(getattr(composed[0], f), getattr(nested[1], f))


# --- ReseedWrapper ------------------------------------------------------------

def test_reseed_layouts_and_cycle_order():
    """The same seed gives the same layout, each layout is a valid
    DoorKey-8x8 one, resets take the seeds in JAX's cycle order (episodes
    ending by truncation alone, the agent only turning), and each reset
    env takes the layout of its index."""
    jenv, penv = envs(DOORKEY, True)
    seeds = (5, 5, 9, 11)
    pw = PW.ReseedWrapper(penv, seeds=seeds, seed_idx=1)
    jw = JW.ReseedWrapper(jenv, seeds=seeds, seed_idx=1)
    lay = pw.layouts
    assert torch.equal(lay.grid[0], lay.grid[1])
    assert not torch.equal(lay.grid[1], lay.grid[2])
    doorkey_features(lay.grid.numpy(), lay.agent_pos.numpy(),
                     lay.agent_dir.numpy())
    pos = lay.agent_pos.long()
    assert (lay.grid[torch.arange(4), pos[:, 0], pos[:, 1], 0] == 1).all()
    again = PW.ReseedWrapper(penv, seeds=(9,))
    assert torch.equal(again.layouts.grid[0], lay.grid[2])

    jobs, jst = jax.jit(jax.vmap(jw.reset))(base_layouts(DOORKEY, True)[0])
    pobs, pst = pw.reset(None, NB)
    np.testing.assert_array_equal(pst.wrapper.numpy(), np.asarray(jst.wrapper))
    assert (pst.inner.grid == lay.grid[1]).all()
    ms = jenv.params.max_steps
    step = jax.jit(jax.vmap(jw.step_autoreset))
    g = penv.generator(0)
    left = np.zeros(NB, np.int32)
    for t in range(9):
        # a third of the envs truncate at each step
        sc = np.where((np.arange(NB) + t) % 3 == 0, ms - 1, 0).astype(
            np.int32)
        jst = jst.replace(inner=jst.inner.replace(step_count=jnp.asarray(
            sc)))
        pst = pst.replace(inner=pst.inner.replace(
            step_count=torch.from_numpy(sc)))
        jk, pk = keys_of(90 + t)
        jo, jst, _, jte, jtr, _ = step(jk, jst, jnp.asarray(left))
        idx = pst.wrapper.long()
        po, pst, _, pte, ptr, _ = pw.step_autoreset(
            pk, pst, torch.from_numpy(left), g)
        done = pte | ptr
        np.testing.assert_array_equal(done.numpy(), np.asarray(jte | jtr))
        np.testing.assert_array_equal(pst.wrapper.numpy(),
                                      np.asarray(jst.wrapper))
        assert torch.equal(pst.inner.grid[done], lay.grid[idx[done]])


# --- other single-wrapper checks ---------------------------------------------

def test_flat_obs_long_missions_match_jax():
    """FlatObs on random token rows long enough to run past the character
    buffer (the JAX package's clamped ``dynamic_update_slice``), on short
    ones and on empty ones."""
    from minigrid_tpu_torch.core.mission import WORDS

    jenv, penv = envs(DOORKEY, False)
    jw, pw = JW.FlatObsWrapper(jenv), PW.FlatObsWrapper(penv)
    _, jobs, st = base_layouts(DOORKEY, False)
    L = st.mission.shape[1]
    lengths = np.array([0, 1, 3, 12, 20, 40, 60, L] * (NB // 8))
    tok = np.random.default_rng(8).integers(
        1, len(WORDS) + 1, (NB, L)).astype(np.int32)
    tok[np.arange(L)[None, :] >= lengths[:, None]] = 0
    jobs = dict(jobs, mission=jnp.asarray(tok))
    want = jax.jit(jax.vmap(jw.observation))(jobs, st)
    got = pw.observation({k: torch.from_numpy(np.array(v))
                          for k, v in jobs.items()}, export(st))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_view_size_beyond_the_kernel_raises():
    """The kernel observes odd view sizes 3-63, so ViewSizeWrapper refuses
    a larger one on every device (the JAX package takes any odd size; the
    gap is in ROADMAP Queue 3)."""
    jenv, penv = envs(DOORKEY, False)
    JW.ViewSizeWrapper(jenv, 65)
    PW.ViewSizeWrapper(penv, 63)
    for v in (65, 4):
        with pytest.raises(ValueError, match="odd view sizes 3..63"):
            PW.ViewSizeWrapper(penv, v)


def reference_sweep(transparent):
    """The reference's two-pass visibility sweep (minigrid/core/grid.py:
    291-328) on one (V, V) transparency window [x, y], agent at (V//2,
    V-1), in numpy: any width (the JAX package's int32 row packing stops
    at 31)."""
    V = transparent.shape[0]
    mask = np.zeros((V, V), bool)
    mask[V // 2, V - 1] = True
    for j in reversed(range(V)):
        for i in range(V - 1):
            if mask[i, j] and transparent[i, j]:
                mask[i + 1, j] = True
                if j > 0:
                    mask[i + 1, j - 1] = mask[i, j - 1] = True
        for i in reversed(range(1, V)):
            if mask[i, j] and transparent[i, j]:
                mask[i - 1, j] = True
                if j > 0:
                    mask[i - 1, j - 1] = mask[i, j - 1] = True
    return mask


@pytest.mark.parametrize("view", [33, 49])
def test_view_size_wide_matches_jax(view):
    """Views of 33-63 take 64-bit rows. On a see-through env (Fetch) the
    port's ViewSizeWrapper equals JAX's, bit for bit, at reset and over
    the interaction stream's steps. With walls (DoorKey) JAX's own wrapper
    overflows its int32 rows (``OverflowError``), so the port is held to
    JAX's see-through window at that size masked by the reference's sweep:
    each cell's transparency is JAX's (the agent's own cell is always
    transparent: the agent stands only on cells it can overlap)."""
    import dataclasses

    from minigrid_tpu.core import constants as JC
    from minigrid_tpu.core.obs import gen_obs as j_gen_obs

    for env_id in ("MiniGrid-Fetch-8x8-N3-v0", DOORKEY):
        jenv, penv = envs(env_id, False)
        pw = PW.ViewSizeWrapper(penv, view)
        _, jobs, jst = base_layouts(env_id, False)
        pobs, pst = pw.reset_from(export(jst))
        step = jax.jit(jax.vmap(jenv.step))
        wide = dataclasses.replace(jenv.params, view_size=view,
                                   see_through_walls=True)
        window = jax.jit(jax.vmap(lambda s: j_gen_obs(wide, s)["image"]))
        observe = jax.jit(jax.vmap(JW.ViewSizeWrapper(jenv,
                                                      view).observation))
        acts = action_stream("interact", 4, NB)
        for t in range(5):
            msg = f"{env_id} V={view} step {t}"
            if jenv.params.see_through_walls:
                img = np.asarray(observe(jobs, jst)["image"])
            else:
                img = np.asarray(window(jst))
                typ, state = img[..., 0], img[..., 2]
                transparent = ~((typ == JC.WALL) | (
                    (typ == JC.DOOR) & (state != JC.OPEN)))
                transparent[:, view // 2, view - 1] = True
                vis = np.stack([reference_sweep(tr) for tr in transparent])
                img = np.where(vis[..., None], img, 0).astype(np.uint8)
            assert_obs_equal(pobs["image"], img, msg)
            if t == 4:
                break
            jk, pk = keys_of(30 + t)
            jobs, jst, *_ = step(jk, jst, jnp.asarray(acts[t]))
            pobs, pst, *_ = pw.step(pk, pst, torch.from_numpy(acts[t]))
    with pytest.raises(OverflowError):
        jax.jit(JW.ViewSizeWrapper(envs(DOORKEY, False)[0], view).reset)(
            jax.random.PRNGKey(0))


def test_module_exports_match_jax():
    assert PW.__all__ == JW.__all__
    assert all(hasattr(PW, n) for n in PW.__all__)
    from minigrid_tpu import render as JR
    from minigrid_tpu_torch import render as PR
    assert PR.__all__ == JR.__all__


def test_wrapped_state_convert_round_trip():
    """A nested JAX WrappedState (visit tables over visit tables) and a
    goal cache cross to the port and back unchanged."""
    for name in ("ActionBonus(PositionBonus)", "DirectionObs"):
        (_, jst), (_, pst) = reset_both(name)
        got = export_state(jst)
        assert_wrapped_equal(got, jst, name)
        back = to_jax_state(got)
        assert jax.tree.structure(back) == jax.tree.structure(jst)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jst)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        moved = got.map(lambda x: x + 0)
        assert set(moved.tensors()) == set(got.tensors())
