"""The port's policy and rollout (minigrid_tpu_torch/models) against the JAX
package: ActorCritic on converted Flax parameters, and the pooled rollout
against a JAX reference composed from ``ActorCritic.apply``,
``_selected_log_prob`` and ``autoreset_step_presampled`` with the same
states, Gumbel noise, step keys and reset rows."""

from __future__ import annotations

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from minigrid_tpu.core.mission import VOCAB_SIZE
from minigrid_tpu.core.obs import gen_obs as j_gen_obs
from minigrid_tpu.envs.base import (autoreset_step_presampled as
                                    j_autoreset_presampled,
                                    presample_reset_states as j_presample)
from minigrid_tpu.models.actor_critic import ActorCritic as JActorCritic
from minigrid_tpu.models.actor_critic import encode_obs as j_encode_obs
from minigrid_tpu.models.actor_critic import init_params as j_init_params
from minigrid_tpu.models.ppo import _selected_log_prob as j_selected_log_prob

import minigrid_tpu_torch
from minigrid_tpu_torch.convert import actor_critic_from_flax
from minigrid_tpu_torch.envs.base import pool_from_states
from minigrid_tpu_torch.models.actor_critic import (ActorCritic, encode_obs,
                                                    init_params)
from minigrid_tpu_torch.models.ppo import RolloutNoise, rollout

from tests.torch_port_utils import share_cpu  # noqa: F401
from tests.torch_port_utils import CPU, action_stream, export, jax_states

pytestmark = pytest.mark.usefixtures("share_cpu")

ENV_ID = "MiniGrid-DoorKey-8x8-v0"


@functools.lru_cache(maxsize=None)
def _flax_params(dtype_j, seed):
    """(Flax model, its params by the jitted init), once per module."""
    jm = JActorCritic(dtype=dtype_j)
    init = jax.jit(lambda k: j_init_params(k, model=jm, packed=True))
    return jm, init(jax.random.PRNGKey(seed))


def _models(dtype_j, dtype_p, seed=0):
    jm, params = _flax_params(dtype_j, seed)
    pm = ActorCritic(dtype=dtype_p, device=CPU)
    pm.load_state_dict(actor_critic_from_flax(
        jax.tree.map(np.asarray, params)))
    return jm, params, pm


@functools.lru_cache(maxsize=None)
def _jax_obs(B, packed):
    env, st = jax_states(ENV_ID, B, seed=3, packed=packed)
    step = jax.jit(jax.vmap(env.step))
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    for a in action_stream("interact", 6, B):
        obs, st, *_ = step(keys, st, jnp.asarray(a))
    return obs


def _obs(B=64, packed=True):
    """Observations of exported states after a few interaction steps (the
    JAX side computed once per module)."""
    obs = _jax_obs(B, packed)
    return obs, {k: torch.from_numpy(np.array(v)) for k, v in obs.items()}


@pytest.mark.parametrize("packed", [True, False])
def test_encode_obs_matches_jax(packed):
    jo, po = _obs(packed=packed)
    je = j_encode_obs(jo)
    pe = encode_obs(po)
    for k in je:
        np.testing.assert_array_equal(pe[k].numpy(), np.asarray(je[k]),
                                      err_msg=k)


@pytest.mark.parametrize("packed", [True, False])
def test_actor_critic_f32_matches_flax(packed):
    jm, params, pm = _models(jnp.float32, torch.float32)
    jo, po = _obs(packed=packed)
    jl, jv = jm.apply(params, jo)
    with torch.no_grad():
        pl, pv = pm(po)
        pl2, pv2 = pm(encode_obs(po))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=0, atol=1e-5)
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=0, atol=1e-5)
    assert torch.equal(pl, pl2) and torch.equal(pv, pv2)


def test_actor_critic_bf16_matches_flax():
    """bf16 trunk: within 4e-3 absolute on logits and values, one bf16
    step (2^-8) at their magnitude (below 1 at initialization). The two
    frameworks round at different points — XLA's CPU dot and torch's addmm
    accumulate in different orders and add the bias before or after the
    final rounding to bf16 — so an element may land one bf16 step apart
    after the three bf16 layers."""
    jm, params, pm = _models(jnp.bfloat16, torch.bfloat16)
    jo, po = _obs()
    jl, jv = jm.apply(params, jo)
    with torch.no_grad():
        pl, pv = pm(po)
    assert pl.dtype == torch.float32 and pv.dtype == torch.float32
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=0, atol=4e-3)
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=0, atol=4e-3)
    assert float(np.abs(np.asarray(jl)).max()) < 1.0


def test_init_params_follows_flax_initializers():
    m = init_params(ActorCritic(hidden=256, dtype=torch.float32, device=CPU),
                    torch.Generator().manual_seed(0))
    fan_in = m.img_in.in_features
    w = m.img_in.weight.detach()
    assert w.shape == (256, 7 * 7 * 24)
    assert float(w.abs().max()) <= 2 / np.sqrt(fan_in) / .8796 + 1e-6
    assert abs(float(w.std()) * np.sqrt(fan_in) - 1.0) < 0.05
    assert float(m.img_in.bias.detach().abs().max()) == 0.0
    assert abs(float(m.mission_embed.detach().std()) - 1.0) < 0.05


def test_rollout_matches_jax_composition():
    """8 pooled-rollout steps at B=64 with the f32 policy: actions, rewards,
    dones and stored observations exact; log-probs and values within 1e-5
    (the frameworks' f32 matmuls sum in different orders)."""
    B, T = 64, 8
    jm, params, pm = _models(jnp.float32, torch.float32, seed=1)
    env, jst = jax_states(ENV_ID, B, seed=5)
    ms = env.params.max_steps
    jst = jst.replace(step_count=jnp.asarray(ms - 1 - np.arange(B) % 12,
                                             jnp.int32))
    jobs = jax.vmap(lambda s: j_gen_obs(env.params, s))(jst)
    pool = env.make_pool(jax.random.PRNGKey(6), 16)
    j_rows = j_presample(jax.random.PRNGKey(7), pool, T)
    keys = np.array(jax.random.split(jax.random.PRNGKey(8), T * B))
    keys = keys.reshape(T, B, 2)
    gumbel = np.random.default_rng(9).gumbel(size=(T, B, 7)).astype(
        np.float32)

    # the port
    penv = minigrid_tpu_torch.make(ENV_ID, device=CPU).packed()
    noise = RolloutNoise(torch.from_numpy(keys.view(np.int32)),
                         torch.from_numpy(gumbel),
                         pool_from_states(export(j_rows)))
    pobs0 = {k: torch.from_numpy(np.array(v)) for k, v in jobs.items()}
    p_st, p_obs, traj, _ = rollout(pm, penv, export(jst), pobs0, noise)

    # the JAX reference, composed step by step
    def counts_of(tokens):
        return (tokens[..., None] == jnp.arange(VOCAB_SIZE)).sum(-2).astype(
            jnp.uint8)

    @jax.jit
    def jstep(st, obs, counts, k, gum, row):
        enc = {"img_feat": j_encode_obs({"packed": obs["packed"],
                                         "direction": obs["direction"],
                                         "mission_counts": counts})[
                                             "img_feat"],
               "mission_counts": counts, "direction": obs["direction"]}
        logits, value = jm.apply(params, enc)
        action = jnp.argmax(logits + gum, axis=-1)
        log_prob = j_selected_log_prob(jax.nn.log_softmax(logits), action)
        obs, st, reward, term, trunc, _ = j_autoreset_presampled(
            env, k, st, action, row)
        done = term | trunc
        counts = jnp.where(done[:, None], counts_of(row.mission)[None],
                           counts)
        return st, obs, counts, (enc, action, log_prob, value, reward, done)

    counts = counts_of(jobs["mission"])
    st, obs = jst, jobs
    n_done = 0
    for t in range(T):
        row = jax.tree.map(lambda x: x[t], j_rows)
        st, obs, counts, (enc, action, log_prob, value, reward, done) = \
            jstep(st, obs, counts, jnp.asarray(keys[t]),
                  jnp.asarray(gumbel[t]), row)
        for k in enc:
            np.testing.assert_array_equal(traj.obs[k][t].numpy(),
                                          np.asarray(enc[k]),
                                          err_msg=f"step {t} obs {k}")
        np.testing.assert_array_equal(traj.action[t].numpy(),
                                      np.asarray(action))
        np.testing.assert_array_equal(traj.reward[t].numpy(),
                                      np.asarray(reward))
        np.testing.assert_array_equal(traj.done[t].numpy(), np.asarray(done))
        np.testing.assert_allclose(traj.log_prob[t].numpy(),
                                   np.asarray(log_prob), rtol=0, atol=1e-5)
        np.testing.assert_allclose(traj.value[t].numpy(), np.asarray(value),
                                   rtol=0, atol=1e-5)
        n_done += int(np.asarray(done).sum())
    assert n_done >= B // 2  # resets really happened
    np.testing.assert_array_equal(p_obs["packed"].numpy(),
                                  np.asarray(obs["packed"]))
    np.testing.assert_array_equal(p_st.rng.numpy(),
                                  np.asarray(st.rng).view(np.int32))
    np.testing.assert_array_equal(p_st.mission.numpy(),
                                  np.asarray(st.mission))
