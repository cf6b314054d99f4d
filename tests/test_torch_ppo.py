"""The port's PPO update (minigrid_tpu_torch/models/ppo.py) against the JAX
package, whose ``gae`` and ``loss_fn`` are reached through the closures of
``make_train_step`` (tests/torch_port_utils.py). Batches come from a port
rollout on converted Flax parameters; the same numbers go to both sides.

Tolerances: GAE within 1e-5 (XLA:CPU contracts ``a*b+c`` into fused
multiply-adds, PyTorch does not: up to ~1e-6 apart); the f32 loss and its
gradients within 1e-5 (the matmuls sum in different orders); the bf16 loss
within 4e-3 (one bf16 step at its magnitude, as for the policy's outputs);
parameters after whole rotate epochs within 1e-5 against optax."""

from __future__ import annotations

import dataclasses

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

import minigrid_tpu
from minigrid_tpu.models.actor_critic import ActorCritic as JActorCritic
from minigrid_tpu.models.actor_critic import init_params as j_init_params
from minigrid_tpu.models.ppo import PPOConfig as JPPOConfig
from minigrid_tpu.models.ppo import Transition as JTransition
from minigrid_tpu.models.ppo import make_optimizer as j_make_optimizer
from minigrid_tpu.models.ppo import make_train_step as j_make_train_step

import minigrid_tpu_torch
from minigrid_tpu_torch.convert import (actor_critic_from_flax,
                                        actor_critic_to_flax,
                                        adam_state_from_optax)
from minigrid_tpu_torch.models.actor_critic import (ActorCritic,
                                                    ActorCriticRNN,
                                                    encode_obs, init_params,
                                                    mission_counts)
from minigrid_tpu_torch.models import ppo as P
from minigrid_tpu_torch.models.policy_step import POLICY

from tests.torch_port_utils import (share_cpu,  # noqa: F401
                                    CPU, jax_train_step_closures)

DK8 = "MiniGrid-DoorKey-8x8-v0"
# PPOConfig's default learning rate: Adam turns a gradient element near its
# eps (1e-8) into an update of order lr whatever its rounding, so the
# parameter drift between the frameworks scales with lr (7e-6 here; 3e-5 at
# lr=1e-3)
CFG = dict(num_minibatches=4)

pytestmark = pytest.mark.usefixtures("share_cpu")


def _jax_pieces(cfg_kw=CFG, resets="pooled", env_id=DK8, dtype=jnp.float32,
                num_envs=64, rollout_len=8):
    jcfg = JPPOConfig(num_envs=num_envs, rollout_len=rollout_len, **cfg_kw)
    jm = JActorCritic(dtype=dtype)
    env = minigrid_tpu.make(env_id).packed()
    ts = j_make_train_step(env, jm, jcfg, j_make_optimizer(jcfg),
                           resets=resets)
    return jcfg, jm, jax_train_step_closures(ts)


def _batch(dtype=torch.float32, T=8, B=64, seed=0):
    """Converted models and a stored batch from a pooled port rollout, with
    its GAE: (Flax params, port model, data dict)."""
    jm = JActorCritic(dtype=jnp.bfloat16 if dtype == torch.bfloat16
                      else jnp.float32)
    params = jax.jit(lambda k: j_init_params(k, model=jm, packed=True))(
        jax.random.PRNGKey(seed))
    pm = ActorCritic(dtype=dtype, device=CPU)
    pm.load_state_dict(actor_critic_from_flax(jax.tree.map(np.asarray,
                                                           params)))
    env = minigrid_tpu_torch.make(DK8, device=CPU).packed()
    g = env.generator(seed)
    pool = env.make_pool(g, 16)
    obs, st = env.reset_staggered(g, B)
    noise = P.sample_rollout_noise(g, pool, B, T, pm.num_actions)
    st, obs, traj, _ = P.rollout(pm, env, st, obs, noise)
    with torch.no_grad():
        _, last_value = pm(obs)
    adv, ret = P.gae(traj.reward, traj.value, traj.done, last_value, 0.99,
                     0.95)
    data = dict(traj.obs, action=traj.action, log_prob=traj.log_prob,
                adv=adv, ret=ret)
    return params, pm, data


def _jax_args(mb):
    """A port minibatch dict -> JAX loss_fn's (batch, adv, ret)."""
    j = {k: jnp.asarray(v.numpy()) for k, v in mb.items()}
    obs = {k: j[k] for k in P.OBS_KEYS}
    batch = JTransition(obs, j["action"], j["log_prob"], None, None, None)
    return batch, j["adv"], j["ret"]


def test_gae_matches_jax():
    _, _, fns = _jax_pieces()
    T, B = 32, 64
    rng = np.random.default_rng(0)
    reward = (rng.random((T, B)) < 0.05) * rng.random((T, B))
    value = rng.normal(size=(T, B))
    done = rng.random((T, B)) < 0.1
    last = rng.normal(size=B)
    f32 = lambda x: np.asarray(x, np.float32)
    traj = JTransition(jnp.zeros((T, 1)), jnp.zeros((T, B)),
                       jnp.zeros((T, B)), jnp.asarray(f32(value)),
                       jnp.asarray(f32(reward)), jnp.asarray(done))
    j_adv, j_ret = fns["gae"](traj, jnp.asarray(f32(last)))
    t = lambda x: torch.from_numpy(np.asarray(x))
    p_adv, p_ret = P.gae(t(f32(reward)), t(f32(value)), t(done), t(f32(last)),
                         0.99, 0.95)
    np.testing.assert_allclose(p_adv.numpy(), np.asarray(j_adv), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(p_ret.numpy(), np.asarray(j_ret), rtol=0,
                               atol=1e-5)


def _grads_flax(pm):
    return actor_critic_to_flax({k: p.grad for k, p in
                                 pm.named_parameters()})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_loss_and_gradients_match_jax(dtype):
    """One rotate slab (mbt=2, B=64): the loss terms, and in f32 the
    gradient of every parameter."""
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    _, _, fns = _jax_pieces(dtype=jdt)
    params, pm, data = _batch(dtype)
    mb = {k: v[2:4] for k, v in data.items()}
    batch, adv, ret = _jax_args(mb)
    (j_total, j_metrics), j_grads = jax.jit(jax.value_and_grad(
        fns["loss_fn"], has_aux=True))(params, batch, adv, ret)
    cfg = P.PPOConfig(num_envs=64, rollout_len=8, **CFG)
    total, metrics = P.ppo_loss(pm, cfg, mb)
    total.backward()
    atol = 1e-5 if dtype == torch.float32 else 4e-3
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), float(j_metrics[k]), rtol=0,
                                   atol=atol, err_msg=k)
    assert abs(float(j_metrics["entropy"])) > 1.0  # a real batch
    if dtype == torch.float32:
        want = jax.tree.map(np.asarray, j_grads)
        got = _grads_flax(pm)
        jax.tree.map(lambda a, b: np.testing.assert_allclose(
            a, b, rtol=0, atol=1e-5), got, want)


def test_rotate_epochs_match_optax():
    """A whole rotate epoch at offset 1 from a fresh optimizer, then one at
    offset 3 continued from optax's state carried across
    (``adam_state_from_optax``): the parameters within 1e-5 of optax's."""
    jcfg, _, fns = _jax_pieces()
    params, pm, data = _batch()
    cfg = P.PPOConfig(num_envs=64, rollout_len=8, **CFG)
    opt = j_make_optimizer(jcfg)
    opt_state = opt.init(params)
    grad = jax.jit(jax.grad(lambda p, b, a, r: fns["loss_fn"](p, b, a,
                                                              r)[0]))
    optimizer = P.make_optimizer(pm, cfg)
    for offset in (1, 3):
        if offset == 3:  # continue from the JAX side's state
            pm.load_state_dict(actor_critic_from_flax(
                jax.tree.map(np.asarray, params)))
            adam = opt_state[1][0]
            adam_state_from_optax(optimizer, pm,
                                  jax.tree.map(np.asarray, adam.mu),
                                  jax.tree.map(np.asarray, adam.nu),
                                  np.asarray(adam.count))
        mbs = list(P.epoch_minibatches(data, cfg, None, offset=offset))
        for mb in mbs:
            g = grad(params, *_jax_args(mb))
            updates, opt_state = opt.update(g, opt_state, params)
            params = optax.apply_updates(params, updates)
            P.update_minibatch(pm, optimizer, cfg, mb)
        got = actor_critic_to_flax(pm.state_dict())
        jax.tree.map(lambda a, b: np.testing.assert_allclose(
            a, np.asarray(b), rtol=0, atol=1e-5), got, params)
    assert int(opt_state[1][0].count) == 8
    assert float(optimizer.state_dict()["state"][0]["step"]) == 8


def test_clip_by_global_norm_matches_optax():
    rng = np.random.default_rng(1)
    shapes = [(5, 3), (7,), (2, 2, 2)]
    for scale in (0.01, 10.0):  # below and above max_norm
        gs = [rng.normal(size=s).astype(np.float32) * scale for s in shapes]
        want, _ = optax.clip_by_global_norm(0.5).update(
            [jnp.asarray(g) for g in gs], optax.EmptyState())
        ps = [torch.nn.Parameter(torch.zeros(s)) for s in shapes]
        for p, g in zip(ps, gs):
            p.grad = torch.from_numpy(g.copy())
        norm = P.clip_by_global_norm_(ps, 0.5)
        assert (float(norm) < 0.5) == (scale < 1)
        for p, w in zip(ps, want):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(w),
                                       rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("shuffle", P.SHUFFLES)
def test_minibatches_use_every_sample_once(shuffle):
    T, B = 8, 6
    cfg = P.PPOConfig(num_envs=B, rollout_len=T, num_minibatches=4,
                      shuffle=shuffle)
    ids = torch.arange(T * B).reshape(T, B)
    data = {"adv": ids.float(), "id": ids}
    g = torch.Generator().manual_seed(0)
    mbs = list(P.epoch_minibatches(data, cfg, g, offset=None))
    assert len(mbs) == 4
    seen = torch.cat([mb["id"].reshape(-1) for mb in mbs])
    assert sorted(seen.tolist()) == list(range(T * B))
    for mb in mbs:
        assert torch.equal(mb["adv"], mb["id"].float())
        assert mb["id"].numel() == T * B // 4
    if shuffle == "rotate":
        off = int(mbs[0]["id"][0, 0]) // (2 * B)
        starts = [int(mb["id"][0, 0]) // (2 * B) for mb in mbs]
        assert starts == [(i + off) % 4 for i in range(4)]
        assert mbs[0]["id"].shape == (2, B)


@pytest.mark.parametrize("env_id,num_envs,rollout_len", [
    (DK8, 4096, 128), ("MiniGrid-Empty-5x5-v0", 128, 64),
    ("MiniGrid-DoorKey-5x5-v0", 256, 64), (DK8, 16, 8)])
def test_fresh_sizes_match_jax(env_id, num_envs, rollout_len):
    jcfg, _, fns = _jax_pieces({}, "fresh", env_id, num_envs=num_envs,
                               rollout_len=rollout_len)
    env = minigrid_tpu_torch.make(env_id, device=CPU)
    cfg = P.PPOConfig(num_envs=num_envs, rollout_len=rollout_len)
    assert P.fresh_sizes(env, cfg) == (fns["fresh_buffer"],
                                       fns["fresh_window"])
    if (env_id, num_envs) == (DK8, 4096):
        assert P.fresh_sizes(env, cfg) == (1271, 39)


@pytest.mark.parametrize("resets", ["pooled", "fresh", "regen"])
def test_train_step_and_loop_every_reset_mode(resets):
    """A tiny train step in each mode: finite device-scalar metrics, the
    parameters moved, the env batch carried; the loop stacks (K,)."""
    env = minigrid_tpu_torch.make("MiniGrid-Empty-5x5-v0", device=CPU)
    env = env.packed()
    cfg = P.PPOConfig(num_envs=16, rollout_len=8, num_minibatches=2,
                      shuffle="timestep" if resets == "regen" else "rotate")
    g = env.generator(0)
    model = init_params(ActorCritic(hidden=32, device=CPU), g)
    opt = P.make_optimizer(model, cfg)
    pool = env.make_pool(g, 8) if resets == "pooled" else None
    obs, st = env.reset_staggered(g, 16)
    before = model.trunk1.weight.detach().clone()
    step = P.make_train_step(env, model, cfg, opt, resets=resets)
    st, obs, m = step(st, obs, g, pool)
    want = {"loss", "pg_loss", "v_loss", "entropy", "mean_reward"}
    assert set(m) == want | ({"reset_overflow"} if resets == "fresh"
                             else set())
    assert all(v.ndim == 0 and torch.isfinite(v.float()) for v in m.values())
    assert not torch.equal(before, model.trunk1.weight)
    assert obs["packed"].shape == (16, 7, 7) and st.batch_size == 16
    loop = P.make_train_loop(env, model, cfg, opt, steps_per_call=2,
                             resets=resets)
    st, obs, m = loop(st, obs, g, pool)
    assert all(v.shape == (2,) for v in m.values())


def test_train_step_refusals():
    env = minigrid_tpu_torch.make("MiniGrid-Empty-5x5-v0", device=CPU)
    model = ActorCritic(hidden=32, device=CPU)
    cfg = P.PPOConfig(num_envs=8, rollout_len=8)
    opt = P.make_optimizer(model, cfg)
    with pytest.raises(ValueError, match="divisible"):
        P.make_train_step(env, model, dataclasses.replace(
            cfg, num_minibatches=3), opt)
    with pytest.raises(ValueError, match="shuffle"):
        P.make_train_step(env, model, dataclasses.replace(
            cfg, shuffle="none"), opt)
    with pytest.raises(ValueError, match="resets"):
        P.make_train_step(env, model, cfg, opt, resets="exact")
    step = P.make_train_step(env, model, cfg, opt, pooled=True)
    obs, st = env.reset(env.generator(0), 8)
    with pytest.raises(ValueError, match="LayoutPool"):
        step(st, obs, env.generator(0))
    rnn = ActorCriticRNN(hidden=16, device=CPU)
    with pytest.raises(ValueError, match="rotate"):
        P.make_train_step(env, rnn, dataclasses.replace(
            cfg, shuffle="timestep"), P.make_optimizer(rnn, cfg))


def _eager_rollout(model, env, st, obs, noise, resets, g, n_buf):
    """The rollout as a plain loop of the eager policy step (encode, forward,
    Gumbel argmax, log-probability) and the reset mode's env step, the
    trajectory stacked at the end: (env_state, obs, traj)."""
    if resets == "fresh":
        buffer = env.presample_fresh(g, n_buf)
        cursor = torch.zeros((), dtype=torch.int32)
    counts = mission_counts(obs["mission"])
    fields = {k: [] for k in P.Transition._fields[:-1]}
    for t in range(noise.gumbel.shape[0]):
        enc = encode_obs({"packed": obs["packed"], "direction":
                          obs["direction"], "mission_counts": counts}
                         if resets == "pooled" else obs)
        logits, value = model(enc)
        action = torch.argmax(logits + noise.gumbel[t], dim=-1)
        log_prob = torch.log_softmax(logits, -1).gather(
            -1, action[:, None]).squeeze(-1)
        keys = noise.step_keys[t]
        if resets == "pooled":
            obs, st, reward, term, trunc, _ = env.step_autoreset_presampled(
                keys, st, action, noise.reset_rows.rows(t))
        elif resets == "fresh":
            obs, st, reward, term, trunc, _, cursor = \
                env.step_autoreset_fresh(keys, st, action, buffer, cursor)
        else:
            obs, st, reward, term, trunc, _ = env.step_autoreset(
                keys, st, action, g)
        done = term | trunc
        if resets == "pooled":
            counts = torch.where(done[:, None], mission_counts(
                noise.reset_rows.mission[t])[None], counts)
        for k, v in zip(fields, (enc, action.to(torch.int32), log_prob,
                                 value, reward, done)):
            fields[k].append(v)
    fields["obs"] = {k: torch.stack([e[k] for e in fields["obs"]])
                     for k in fields["obs"][0]}
    return st, obs, P.Transition(**{
        k: v if k == "obs" else torch.stack(v) for k, v in fields.items()})


def _rollout_pieces(resets, seed=0, B=64, T=16):
    env = minigrid_tpu_torch.make(DK8, device=CPU).packed()
    g = env.generator(seed)
    model = init_params(ActorCritic(hidden=32, device=CPU), g)
    pool = env.make_pool(g, 16) if resets == "pooled" else None
    obs, st = env.reset_staggered(g, B)
    noise = P.sample_rollout_noise(g, pool, B, T, model.num_actions,
                                   device=CPU)
    n_buf = P.fresh_sizes(env, P.PPOConfig(num_envs=B, rollout_len=T))[0]
    return env, g, model, st, obs, noise, n_buf


@pytest.mark.parametrize("resets", ["pooled", "fresh", "regen"])
def test_rollout_equals_plain_loop_of_eager_policy_steps(resets):
    """The rollout's trajectory at B=64, T=16, field for field, against a
    plain loop of the eager policy step with the same noise; on the CPU
    every step is eager (``policy.eager_steps`` == T, no graph)."""
    env, g, model, st, obs, noise, n_buf = _rollout_pieces(resets)
    seed = g.get_state()
    before = dataclasses.asdict(POLICY)
    st1, obs1, traj, _ = P.rollout(model, env, st, obs, noise, resets, g,
                                   n_buf)
    ran = {k: getattr(POLICY, k) - v for k, v in before.items()}
    assert ran == {"graph_captures": 0, "graph_replays": 0,
                   "eager_steps": 16}
    g.set_state(seed)
    st2, obs2, want = _eager_rollout(model, env, st, obs, noise, resets, g,
                                     n_buf)
    assert traj.hidden is None
    assert set(traj.obs) == set(want.obs) == set(P.OBS_KEYS)
    for k in P.OBS_KEYS:
        assert torch.equal(traj.obs[k], want.obs[k]), k
    for k in P.Transition._fields[1:-1]:
        assert torch.equal(getattr(traj, k), getattr(want, k)), k
    assert all(torch.equal(obs1[k], obs2[k]) for k in obs1)
    assert torch.equal(st1.agent_pos, st2.agent_pos)


def test_successive_rollouts_share_no_storage():
    """Each rollout's trajectory owns its memory: writing into the second
    leaves the first as it was."""
    env, g, model, st, obs, noise, _ = _rollout_pieces("pooled", B=8, T=4)
    st, obs, first, _ = P.rollout(model, env, st, obs, noise)
    kept = jax.tree.map(torch.clone, first)
    _, _, second, _ = P.rollout(model, env, st, obs, noise)
    for x in jax.tree.leaves(second):
        x.fill_(1)
    for a, b in zip(jax.tree.leaves(first), jax.tree.leaves(kept)):
        assert torch.equal(a, b)
