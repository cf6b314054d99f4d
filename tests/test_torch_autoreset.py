"""The port's observe entry and the auto-resets that select a different
state into each finished env (minigrid_tpu_torch/envs/base.py) against the
JAX package: the fresh-buffer select, cursor and overflow bit-exact on
exported states and buffers with the same done masks; the independent pool
draw exact given the same row indices, its indices uniform; the regen reset
by layout invariants and a chi-square against JAX layouts; the observe
entry's plain version equal to JAX ``vmap(gen_obs)``."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
from scipy import stats as sps

import jax
import jax.numpy as jnp
import torch

import minigrid_tpu
from minigrid_tpu.core.obs import gen_obs as j_gen_obs
from minigrid_tpu.envs.base import _fresh_select as j_fresh_select
from minigrid_tpu.envs.base import autoreset_step_fresh as j_autoreset_fresh
from minigrid_tpu.envs.base import autoreset_step_pooled as j_autoreset_pooled

import minigrid_tpu_torch
from minigrid_tpu_torch.convert import layout_pool_from_entries
from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.envs import base as B
from minigrid_tpu_torch.ops import native
from minigrid_tpu_torch.ops.fused_step import fused_observe

from tests.torch_port_utils import (share_cpu,  # noqa: F401
                                    CPU, action_stream, assert_state_equal,
                                    chi2_same_distribution, doorkey_features,
                                    export, fresh_case, jax_keys, jax_states)

ALL_FIELDS = ("grid", "agent_pos", "agent_dir", "carrying", "step_count",
              "terminated", "truncated", "mission", "rng")
DK8 = "MiniGrid-DoorKey-8x8-v0"

pytestmark = pytest.mark.usefixtures("share_cpu")


def _stepped(env_id, B, steps=12, seed=0, view=None):
    """JAX env and states after a few interaction steps (doors open, keys
    carried), at ``view`` size."""
    env, st = jax_states(env_id, B, seed)
    if view is not None:
        env = env.replace_params(view_size=view)
    step = jax.jit(jax.vmap(env.step_state))
    keys, _ = jax_keys(seed + 1, B)
    for a in action_stream("interact", steps, B, seed):
        st, *_ = step(keys, st, jnp.asarray(a))
    return env, st


@pytest.mark.parametrize("env_id,view", [
    ("MiniGrid-Empty-8x8-v0", 7), ("MiniGrid-DoorKey-5x5-v0", 7), (DK8, 9)])
def test_fused_observe_plain_matches_jax_gen_obs(env_id, view):
    """See-through walls, a small grid, another view size; DoorKey-8x8 at
    V=7 is checked in every reset test below."""
    env, st = _stepped(env_id, 96, view=view)
    want = jax.jit(jax.vmap(lambda s: j_gen_obs(env.params, s)))(st)[
        "packed"]
    launches = native.COUNTERS.observe_launches
    got = fused_observe(env.params, export(st))
    assert native.COUNTERS.observe_launches == launches  # CPU: plain
    assert got.shape == (96, view, view) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if "DoorKey" in env_id:  # the carried overlay is exercised
        assert (np.asarray(st.carrying)[:, 0] != C.EMPTY).any()


@pytest.mark.parametrize("n_buf,window,cursor0", [
    pytest.param(200, 40, 0, id="untouched"),
    pytest.param(200, 8, 0, id="window-overflow"),
    pytest.param(60, 32, 20, id="buffer-exhausted"),
])
def test_fresh_autoreset_matches_jax(n_buf, window, cursor0):
    """Five fresh auto-reset steps: obs, every state field (rng included),
    reward, flags, cursor and reset_overflow bit-exact."""
    Bsz, T = 96, 5
    env, jst, jbuf, penv, pst, pbuf = fresh_case(Bsz, n_buf, seed=1)
    step = jax.jit(lambda k, s, a, c: j_autoreset_fresh(env, k, s, a, jbuf,
                                                        c, window))
    actions = action_stream("uniform", T, Bsz)
    jc = jnp.asarray(cursor0, jnp.int32)
    pc = torch.tensor(cursor0, dtype=torch.int32)
    overflow = 0
    for t in range(T):
        jk, pk = jax_keys(10 + t, Bsz)
        jo, jst, jr, jte, jtr, jinfo, jc = step(jk, jst,
                                               jnp.asarray(actions[t]), jc)
        po, pst, pr, pte, ptr, pinfo, pc = penv.step_autoreset_fresh(
            pk, pst, torch.from_numpy(actions[t]), pbuf, pc, window)
        msg = f"step {t}"
        np.testing.assert_array_equal(po["packed"].numpy(),
                                      np.asarray(jo["packed"]), err_msg=msg)
        assert_state_equal(pst, jst, ALL_FIELDS, msg=msg)
        np.testing.assert_array_equal(pr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal((pte | ptr).numpy(),
                                      np.asarray(jte | jtr))
        assert pc.dtype == torch.int32 and pc.ndim == 0
        assert int(pc) == int(jc), msg
        assert int(pinfo["reset_overflow"]) == int(jinfo["reset_overflow"])
        overflow += int(pinfo["reset_overflow"])
    assert int(pc) > cursor0 + Bsz // 2  # resets really happened
    assert (overflow > 0) == (window < 40 or cursor0 > 0)


def test_fresh_select_alone_matches_jax():
    """The select tail on its own, with a done mask that is not the
    state's flags (the JAX function takes it as given)."""
    Bsz = 64
    env, jst, jbuf, penv, pst, pbuf = fresh_case(Bsz, 80, seed=2)
    done = np.random.default_rng(3).random(Bsz) < 0.5
    jk, pk = jax_keys(4, Bsz)
    jo, js, jinfo, jc = jax.jit(
        lambda k, s, d: j_fresh_select(env, k, s, d, jbuf,
                                       jnp.asarray(60, jnp.int32), 32))(
        jk, jst, jnp.asarray(done))
    po, ps, pinfo, pc = B._fresh_select(
        penv, pk, pst, torch.from_numpy(done), pbuf,
        torch.tensor(60, dtype=torch.int32), 32)
    np.testing.assert_array_equal(po["packed"].numpy(),
                                  np.asarray(jo["packed"]))
    assert_state_equal(ps, js, ALL_FIELDS)
    assert int(pc) == int(jc) == 60 + done.sum()
    assert int(pinfo["reset_overflow"]) == int(jinfo["reset_overflow"]) > 0
    with pytest.raises(ValueError, match="window"):
        B.fresh_candidates(pk, torch.from_numpy(done), pbuf,
                           torch.tensor(0, dtype=torch.int32), 81)


def test_independent_pool_reset_matches_jax_given_indices():
    """JAX's independent draw (indices from the salted keys) replayed
    through the port's select with the same indices and pool rows."""
    Bsz, P = 96, 24
    env, jst, _, penv, pst, _ = fresh_case(Bsz, 8, seed=5)
    jpool = env.make_pool(jax.random.PRNGKey(6), P)
    ppool = layout_pool_from_entries(
        [jax.tree.map(np.asarray, jpool.entry(i)) for i in range(P)], CPU)
    actions = action_stream("uniform", 3, Bsz)
    step = jax.jit(lambda k, s, a: j_autoreset_pooled(env, k, s, a, jpool,
                                                      independent=True))
    n_done = 0
    for t in range(3):
        jk, pk = jax_keys(20 + t, Bsz)
        jo, jst, jr, jte, jtr, _ = step(jk, jst, jnp.asarray(actions[t]))
        salt = jnp.asarray([0x5DEECE66, 0xB5297A4D], jk.dtype)
        salt2 = jnp.asarray([0x68E31DA4, 0x1B56C4E9], jk.dtype)
        idx = jax.vmap(lambda k: jax.random.randint(k, (), 0, P))(
            jk ^ salt ^ salt2)
        cand = B.independent_candidates(pk, ppool,
                                        torch.from_numpy(np.array(idx)))
        po, pst, pr, pte, ptr, _ = B.autoreset_step_select(
            penv, pst, torch.from_numpy(actions[t]), cand)
        np.testing.assert_array_equal(po["packed"].numpy(),
                                      np.asarray(jo["packed"]))
        assert_state_equal(pst, jst, ALL_FIELDS, msg=f"step {t}")
        np.testing.assert_array_equal(pr.numpy(), np.asarray(jr))
        n_done += int((pte | ptr).sum())
    assert n_done >= Bsz // 2


def test_independent_pool_draw_is_uniform_per_env():
    """Each finishing env takes its own uniform pool row: the missions of a
    pool labelled by row index come back uniform, and the rows of one
    step's finishers differ."""
    env = minigrid_tpu_torch.make(DK8, device=CPU).packed()
    g = env.generator(7)
    pool = env.make_pool(g, 16)
    pool = dataclasses.replace(
        pool, mission=torch.arange(16, dtype=torch.int32)[:, None].expand(
            16, 96).contiguous())
    _, st = env.reset(g, 4000)
    st = st.replace(step_count=torch.full((4000,), 639, dtype=torch.int32))
    keys = B.random_keys(g, (4000, 2), CPU)
    _, new, *_ = env.step_autoreset_pooled(
        keys, st, torch.zeros(4000, dtype=torch.int32), pool, g,
        independent=True)
    drawn = new.mission[:, 0].numpy()          # every env truncated
    assert sps.chisquare(np.bincount(drawn, minlength=16)).pvalue > 1e-3
    assert (new.step_count == pool.scal[drawn, 4]).all()
    salt = torch.from_numpy(B.RESET_RNG_SALT)
    assert torch.equal(new.rng, keys ^ salt)


def test_regen_autoreset_layouts_and_distribution():
    """Every env truncated on one regen step restarts from a valid fresh
    DoorKey layout whose features match JAX ``_gen_grid`` draws, and the
    observation is that of the selected state."""
    n = 2000
    env = minigrid_tpu_torch.make(DK8, device=CPU).packed()
    g = env.generator(8)
    _, st = env.reset(g, n)
    ms = env.params.max_steps
    trunc_at = torch.arange(n) % 2 == 0       # half of them finish
    st = st.replace(step_count=torch.where(trunc_at, ms - 1, 0).to(
        torch.int32))
    keys = B.random_keys(g, (n, 2), CPU)
    obs, new, r, te, tr, _ = env.step_autoreset(
        keys, st, torch.full((n,), 6, dtype=torch.int32), g)  # "done"
    assert torch.equal(tr, trunc_at) and not te.any()
    reset = new.map(lambda x: x[trunc_at])
    kept = new.map(lambda x: x[~trunc_at])
    assert (reset.step_count == 0).all() and (kept.step_count == 1).all()
    assert (reset.carrying.numpy() == C.EMPTY_CELL).all()
    assert torch.equal(obs["packed"],
                       fused_observe(env.params, new))
    jenv = minigrid_tpu.make(DK8)
    jst = jax.jit(jax.vmap(jenv._gen_grid))(
        jax.random.split(jax.random.PRNGKey(9), n // 2))
    jf = doorkey_features(jst.grid, jst.agent_pos, jst.agent_dir)
    pf = doorkey_features(reset.grid.numpy(), reset.agent_pos,
                          reset.agent_dir)
    for k in jf:
        p = chi2_same_distribution(jf[k], pf[k])
        assert p > 1e-3, (k, p)


def test_generic_autoreset_step_equals_regen_method():
    """``autoreset_step`` (through env.step and env.reset) and the regen
    method (one observation on the selected state) give the same result
    from the same generator state."""
    env = minigrid_tpu_torch.make("MiniGrid-DoorKey-5x5-v0", device=CPU)
    g = env.generator(10)
    _, st = env.reset_staggered(g, 256)
    st = st.replace(step_count=(249 - torch.arange(256) % 4).to(torch.int32))
    keys = B.random_keys(g, (256, 2), CPU)
    a = torch.from_numpy(action_stream("interact", 1, 256)[0])
    out1 = B.autoreset_step(env, keys, st, a, env.generator(11))
    out2 = env.step_autoreset(keys, st, a, env.generator(11))
    assert int((out1[3] | out1[4]).sum()) > 0
    for k in out1[0]:
        assert torch.equal(out1[0][k], out2[0][k]), k
    for k, v in out1[1].tensors().items():
        assert torch.equal(v, getattr(out2[1], k)), k
    assert out1[0]["image"].shape == (256, 7, 7, 3)


def test_refresh_pool_and_bare_env_guard():
    env = minigrid_tpu_torch.make(DK8, device=CPU)
    g = env.generator(12)
    pool = env.make_pool(g, 32)
    new = B.refresh_layout_pool(env, g, pool)
    assert new.size == 32 and not torch.equal(new.grid, pool.grid)
    B.require_bare_env(env, "autoreset_step_fresh")
    with pytest.raises(NotImplementedError, match="bare envs"):
        B.require_bare_env(object(), "autoreset_step_fresh")
