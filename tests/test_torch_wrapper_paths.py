"""The batched paths of the port's wrapper stacks against the JAX
package's, on exported JAX states, reset rows, buffers and layouts and the
same actions (one wrapper at a time: tests/test_torch_wrappers.py):

- ``step_autoreset_presampled`` (pooled rows) of stateless, transition,
  stateful and stacked wrappers, ``step_autoreset_fresh`` and the exact
  ``step_autoreset``, bit-exact but for the reward (rtol 1e-6,
  ``tests/torch_wrapper_utils.py::assert_outputs``);
- counts carried across auto-resets, an inner stacked bonus's counts
  restarting at each reset (the JAX behaviour kept, ROADMAP Queue 3);
- the stacks the fast paths refuse, and the pooled draw;
- training through wrappers: the ActionBonus train step (JAX
  tests/test_learning.py:309) and an array observation's train steps."""

from __future__ import annotations

import pytest

import jax
import jax.numpy as jnp
import torch

from minigrid_tpu.envs.base import presample_reset_states as j_presample

import minigrid_tpu_torch
from minigrid_tpu_torch import wrappers as PW
from minigrid_tpu_torch.envs import base as B
from minigrid_tpu_torch.models.actor_critic import ActorCritic, encode_packed
from minigrid_tpu_torch.models.ppo import (PPOConfig, make_optimizer,
                                           make_train_step, rollout,
                                           sample_rollout_noise)

from tests.torch_port_utils import share_cpu  # noqa: F401
from tests.torch_port_utils import CPU, export
from tests.torch_wrapper_utils import (CASES, DOORKEY, NB, T_STEPS, _CACHE,
                                       actions_for, assert_outputs, envs,
                                       jitted, keys_of, stacks, staggered)

pytestmark = pytest.mark.usefixtures("share_cpu")


def pool_rows(name):
    """(JAX rows, port rows): T_STEPS broadcast reset rows of a 16-entry
    JAX pool of the stack's base env, shared per base env."""
    env_id, packed, _ = CASES[name]
    key = ("rows", env_id, packed)
    if key not in _CACHE:
        jenv, _ = envs(env_id, packed)
        jpool = jenv.make_pool(jax.random.PRNGKey(8), 16)
        j_rows = j_presample(jax.random.PRNGKey(9), jpool, T_STEPS)
        _CACHE[key] = j_rows, B.pool_from_states(export(j_rows))
    return _CACHE[key]


@pytest.mark.parametrize("name", ["ImgObs", "NoDeath(Mirror)",
                                  "ImgObs(NoDeath)", "ActionBonus",
                                  "DirectionObs"])
def test_presampled_autoreset_matches_jax(name):
    _, pw = stacks(name)
    jst, pst = staggered(name)
    j_rows, p_rows = pool_rows(name)
    step = jitted(name, "presampled", lambda w: w.step_autoreset_presampled)
    acts = actions_for(name, T_STEPS, seed=3)
    n_done = 0
    for t in range(T_STEPS):
        jk, pk = keys_of(30 + t)
        j = step(jk, jst, jnp.asarray(acts[t]),
                 jax.tree.map(lambda x: x[t], j_rows))
        p = pw.step_autoreset_presampled(pk, pst, torch.from_numpy(acts[t]),
                                         p_rows.rows(t))
        assert_outputs(p, j, f"{name} presampled step {t}")
        jst, pst = j[1], p[1]
        n_done += int((p[3] | p[4]).sum())
    assert n_done >= NB


@pytest.mark.parametrize("name", ["NoDeath(Mirror)", "ActionBonus"])
def test_fresh_autoreset_matches_jax(name):
    window = 4
    jw, pw = stacks(name)
    jst, pst = staggered(name)
    jbuf = jax.jit(lambda k: jw.presample_fresh(k, 40))(
        jax.random.PRNGKey(10))
    pbuf = export(jbuf)
    step = jax.jit(lambda k, s, a, c: jw.step_autoreset_fresh(
        k, s, a, jbuf, c, window))
    jc, pc = jnp.asarray(0, jnp.int32), torch.tensor(0, dtype=torch.int32)
    acts = actions_for(name, T_STEPS, seed=4)
    overflow = 0
    for t in range(T_STEPS):
        jk, pk = keys_of(40 + t)
        j = step(jk, jst, jnp.asarray(acts[t]), jc)
        p = pw.step_autoreset_fresh(pk, pst, torch.from_numpy(acts[t]), pbuf,
                                    pc, window)
        assert_outputs(p, j, f"{name} fresh step {t}")
        assert int(p[6]) == int(j[6])
        assert int(p[5]["reset_overflow"]) == int(j[5]["reset_overflow"])
        overflow += int(p[5]["reset_overflow"])
        jst, pst, jc, pc = j[1], p[1], j[6], p[6]
    assert int(pc) >= NB and overflow > 0


def exact_run(name, seed=5):
    """JAX ``vmap(step_autoreset)`` against the port's exact path, the
    port's base env generating JAX's own reset layouts (those of the reset
    half of each step key). Yields (t, port outputs, JAX outputs)."""
    jw, pw = stacks(name, fresh_port_env=True)
    jst, pst = staggered(name)
    step = jitted(name, "exact", lambda w: jax.vmap(w.step_autoreset))
    base = jw.unwrapped()
    cands = jax.jit(jax.vmap(lambda k: base._gen_grid(
        jax.random.split(k)[1])))
    acts = actions_for(name, T_STEPS, seed=seed)
    g = torch.Generator().manual_seed(0)
    for t in range(T_STEPS):
        jk, pk = keys_of(50 + t)
        layouts = export(cands(jk))
        pw.unwrapped()._gen_grid = lambda gen, n: layouts
        j = step(jk, jst, jnp.asarray(acts[t]))
        p = pw.step_autoreset(pk, pst, torch.from_numpy(acts[t]), g)
        yield t, p, j
        jst, pst = j[1], p[1]


def test_exact_autoreset_matches_jax():
    """An array observation over a transition wrapper, on the exact path
    (the generic auto-reset: the nested steps, the stack's reset, the
    select of the arrays and the states)."""
    n_done = 0
    for t, p, j in exact_run("ImgObs(NoDeath)"):
        assert_outputs(p, j, f"exact step {t}")
        n_done += int((p[3] | p[4]).sum())
    assert n_done >= NB


def test_stacked_bonus_counts_across_autoresets():
    """ActionBonus(PositionBonus(env)) on the exact path, bit-exact against
    JAX: the outer counts persist across auto-resets (one visit per env
    per step), the inner counts of an env restart at each of its resets
    (the JAX behaviour the port keeps, ROADMAP Queue 3)."""
    n_reset = 0
    since = torch.zeros(NB, dtype=torch.int64)  # steps since the last reset
    for t, p, j in exact_run("ActionBonus(PositionBonus)"):
        assert_outputs(p, j, f"stacked bonus step {t}")
        outer, inner = p[1].wrapper, p[1].inner.wrapper
        assert int(outer.sum()) == NB * (t + 1)
        done = p[3] | p[4]
        since = torch.where(done, 0, since + 1)
        assert torch.equal(inner.sum((1, 2)), since)
        n_reset += int(done.sum())
    assert n_reset >= NB


def test_fast_paths_refuse_stacked_stateful_and_reseed():
    _, pw = stacks("ActionBonus(PositionBonus)")
    with pytest.raises(NotImplementedError, match="ONE stateful"):
        pw._fast_plan()
    _, penv = envs(DOORKEY, True)
    with pytest.raises(NotImplementedError, match="ReseedWrapper"):
        PW.ImgObsWrapper(PW.ReseedWrapper(penv, seeds=(1,)))._fast_plan()
    model = ActorCritic(hidden=16, device=CPU)
    cfg = PPOConfig(num_envs=8, rollout_len=4, num_minibatches=2)
    with pytest.raises(NotImplementedError, match="ONE stateful"):
        make_train_step(pw, model, cfg, make_optimizer(model, cfg),
                        resets="fresh")


def test_fast_plan_is_built_once_per_stack():
    """The composed env and the observation chain are made on a stack's
    first fast step and reused; a packed copy of the stack plans anew."""
    env = minigrid_tpu_torch.make("MiniGrid-LavaGapS5-v0", device=CPU)
    w = PW.ImgObsWrapper(PW.NoDeath(env, no_death_types=("lava",),
                                    death_cost=-1.0))
    base, chain = w._fast_base()
    assert w._fast_base()[0] is base and chain == (w,)
    assert base.transitions == (w.env,) and base is not env
    pk = w.packed()
    pbase, pchain = pk._fast_base()
    assert pbase is not base and pchain == (pk,)
    assert pbase.transitions == (pk.env,)
    assert "packed" in pbase.reset(pbase.generator(0), 2)[0]
    w.env.check_fast_paths()  # a lone transition wrapper plans too


def test_pooled_draws_the_row_presampled_takes():
    """The pooled step equals the presampled one given the row it draws
    (port only: the JAX package draws the row from the step keys)."""
    _, pw = stacks("ActionBonus")
    _, pst = staggered("ActionBonus")
    _, penv = envs(DOORKEY, True)
    pool = pw.make_pool(penv.generator(3), 16)
    g = penv.generator(4)
    row = B.draw_pool_row(torch.Generator().set_state(g.get_state()), pool)
    _, pk = keys_of(60)
    a = torch.from_numpy(actions_for("ActionBonus", 1)[0])
    got = pw.step_autoreset_pooled(pk, pst, a, pool, g)
    want = pw.step_autoreset_presampled(pk, pst, a, row)
    for x, y in zip(got[:5], want[:5]):
        x, y = (x.tensors(), y.tensors()) if hasattr(x, "tensors") else (x, y)
        if isinstance(x, dict):
            assert set(x) == set(y) and all(torch.equal(x[k], y[k])
                                            for k in y)
        else:
            assert torch.equal(x, y)
    with pytest.raises(NotImplementedError, match="broadcast-row"):
        pw.step_autoreset_pooled(pk, pst, a, pool, g, independent=True)


# --- training through a wrapper -----------------------------------------------

def test_action_bonus_train_step_counts_grow():
    """The ActionBonus WrappedState batch threads through the pooled PPO
    train step (16 envs x 16 steps, JAX tests/test_learning.py:309): one
    visit per env per rollout step, persisting across resets, and the
    bonus flows into the rewards."""
    env = PW.ActionBonus(minigrid_tpu_torch.make("MiniGrid-Empty-5x5-v0",
                                                 device=CPU).packed())
    cfg = PPOConfig(num_envs=16, rollout_len=16, num_epochs=1,
                    num_minibatches=2)
    g = env.generator(0)
    model = ActorCritic(hidden=32, device=CPU)
    step = make_train_step(env, model, cfg, make_optimizer(model, cfg),
                           pooled=True)
    obs, wst = env.reset_staggered(g, cfg.num_envs)
    pool = env.make_pool(g, 16)
    totals = []
    for _ in range(3):
        wst, obs, m = step(wst, obs, g, pool)
        totals.append(int(wst.wrapper.sum()))
    expect = cfg.num_envs * cfg.rollout_len
    assert totals == [expect, 2 * expect, 3 * expect]
    assert float(m["mean_reward"]) > 0


class ArrayPolicy(torch.nn.Module):
    """A policy over ImgObsWrapper's packed array (JAX
    tests/test_learning.py:105)."""

    num_actions = 7

    def __init__(self, view_size=7, hidden=32):
        super().__init__()
        self.l1 = torch.nn.Linear(view_size ** 2 * 24, hidden)
        self.l2 = torch.nn.Linear(hidden, hidden)
        self.pi = torch.nn.Linear(hidden, 7)
        self.v = torch.nn.Linear(hidden, 1)

    def forward(self, arr):
        x = torch.relu(self.l1(encode_packed(arr, torch.float32)))
        x = torch.relu(self.l2(x))
        return self.pi(x), self.v(x).squeeze(-1)


def test_array_observation_train_steps():
    """An ImgObsWrapper stack trains with fresh resets and with pooled
    ones: the rollout stores the packed arrays as they come (no mission
    count carry), the update feeds them to the model."""
    env = PW.ImgObsWrapper(minigrid_tpu_torch.make(
        "MiniGrid-Empty-5x5-v0", device=CPU).packed())
    cfg = PPOConfig(num_envs=16, rollout_len=8, num_epochs=1,
                    num_minibatches=2)
    g = env.generator(1)
    model = ArrayPolicy()
    obs, st = env.reset_staggered(g, cfg.num_envs)
    assert obs.shape == (16, 7, 7) and obs.dtype == torch.int32
    pool = env.make_pool(g, 8)
    noise = sample_rollout_noise(g, pool, 16, 8, 7)
    _, _, traj, _ = rollout(model, env, st, obs, noise)
    assert traj.obs.shape == (8, 16, 7, 7)
    for resets in ("pooled", "fresh"):
        step = make_train_step(env, model, cfg, make_optimizer(model, cfg),
                               resets=resets)
        for _ in range(2):
            st, obs, m = step(st, obs, g, pool)
        assert all(torch.isfinite(v).all() for v in m.values())
