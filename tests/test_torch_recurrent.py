"""The port's recurrent policy and its truncated-BPTT PPO
(minigrid_tpu_torch/models: ``ActorCriticRNN``, the recurrent rollout,
loss, update, eval and train driver) against the JAX package, whose
``loss_fn`` is reached through the closures of ``make_train_step``
(tests/torch_port_utils.py). Inputs come from numpy seeds and exported JAX
states; the same numbers go to both sides.

Tolerances, as tests/test_torch_models.py and tests/test_torch_ppo.py state
them for the MLP policy: float32 forward, loss, gradients, rollout values
and a whole rotate epoch within 1e-5 (the matmuls sum in different orders);
bf16 within 4e-3 on one step only (one bf16 step at the outputs'
magnitude; over a BPTT loop the roundings compound)."""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

import minigrid_tpu
from minigrid_tpu.core.mission import VOCAB_SIZE
from minigrid_tpu.core.obs import gen_obs as j_gen_obs
from minigrid_tpu.envs.base import (autoreset_step_presampled as
                                    j_autoreset_presampled,
                                    presample_reset_states as j_presample)
from minigrid_tpu.models.actor_critic import ActorCriticRNN as JRNN
from minigrid_tpu.models.actor_critic import encode_obs as j_encode_obs
from minigrid_tpu.models.actor_critic import init_params_rnn as j_init_rnn
from minigrid_tpu.models.eval import evaluate_success as j_evaluate_success
from minigrid_tpu.models.ppo import PPOConfig as JPPOConfig
from minigrid_tpu.models.ppo import Transition as JTransition
from minigrid_tpu.models.ppo import _selected_log_prob as j_selected_log_prob
from minigrid_tpu.models.ppo import make_optimizer as j_make_optimizer
from minigrid_tpu.models.ppo import make_train_step as j_make_train_step

import minigrid_tpu_torch
from minigrid_tpu_torch.convert import (actor_critic_rnn_from_flax,
                                        actor_critic_rnn_to_flax,
                                        adam_state_from_optax)
from minigrid_tpu_torch.envs.base import pool_from_states
from minigrid_tpu_torch.models import ppo as P
from minigrid_tpu_torch.models.actor_critic import (ActorCriticRNN,
                                                    encode_obs,
                                                    init_params_rnn)
from minigrid_tpu_torch.models.eval import evaluate_success_from
from minigrid_tpu_torch.models.train import TrainConfig, train
from minigrid_tpu_torch.utils.checkpoint import restore_pytree

from tests.torch_port_utils import (share_cpu,  # noqa: F401
                                    CPU, action_stream, export, jax_states,
                                    jax_train_step_closures)

DK8 = "MiniGrid-DoorKey-8x8-v0"
HIDDEN = 32
T, B, NMB = 8, 64, 4
_CACHE: dict = {}

pytestmark = pytest.mark.usefixtures("share_cpu")


@functools.lru_cache(maxsize=None)
def _flax_params(jdt, seed, hidden):
    """(Flax model, its params by the jitted init), once per module."""
    jm = JRNN(hidden=hidden, dtype=jdt)
    init = jax.jit(lambda k: j_init_rnn(k, model=jm, packed=True))
    return jm, init(jax.random.PRNGKey(seed))


def _models(dtype=torch.float32, seed=0, hidden=HIDDEN):
    """(Flax model, its params, the port model on the converted params)."""
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jm, params = _flax_params(jdt, seed, hidden)
    pm = ActorCriticRNN(hidden=hidden, dtype=dtype, device=CPU)
    pm.load_state_dict(actor_critic_rnn_from_flax(
        jax.tree.map(np.asarray, params)))
    return jm, params, pm


@functools.lru_cache(maxsize=None)
def _jax_obs(n):
    env, st = jax_states(DK8, n, seed=3)
    step = jax.jit(jax.vmap(env.step))
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    for a in action_stream("interact", 6, n):
        obs, st, *_ = step(keys, st, jnp.asarray(a))
    return obs


def _obs(n=64):
    """JAX observations of exported DoorKey states after a few interaction
    steps, and the same as tensors (the JAX side once per module)."""
    obs = _jax_obs(n)
    return obs, {k: torch.from_numpy(np.array(v)) for k, v in obs.items()}


def _closures():
    """JAX's ``loss_fn`` of a recurrent f32 train step (and its config)."""
    if "fns" not in _CACHE:
        jcfg = JPPOConfig(num_envs=B, rollout_len=T, num_minibatches=NMB)
        env = minigrid_tpu.make(DK8).packed()
        ts = j_make_train_step(env, JRNN(hidden=HIDDEN, dtype=jnp.float32),
                               jcfg, j_make_optimizer(jcfg), resets="pooled")
        _CACHE["fns"] = jcfg, jax_train_step_closures(ts)
    return _CACHE["fns"]


def _batch():
    """A recurrent pooled port rollout of T steps at B envs on converted f32
    parameters, with step counts staggered so that a quarter of the envs
    truncate inside each 2-step slab; its GAE from the carried hidden.
    Returns (Flax params, port model, data dict of the update), shared."""
    if "batch" not in _CACHE:
        _, params, pm = _models(seed=1)
        env = minigrid_tpu_torch.make(DK8, device=CPU).packed()
        g = env.generator(0)
        pool = env.make_pool(g, 16)
        obs, st = env.reset(g, B)
        ms = env.params.max_steps
        st = st.replace(step_count=torch.tensor(ms - 1 - np.arange(B) % T,
                                                dtype=torch.int32))
        noise = P.sample_rollout_noise(g, pool, B, T, pm.num_actions)
        h0 = torch.from_numpy(np.random.default_rng(2).normal(
            size=(B, HIDDEN)).astype(np.float32) * 0.5)
        st, obs, traj, _, h = P.rollout(pm, env, st, obs, noise, h=h0)
        with torch.no_grad():
            (_, last_value), _ = pm(obs, h)
        adv, ret = P.gae(traj.reward, traj.value, traj.done, last_value,
                         0.99, 0.95)
        data = dict(traj.obs, action=traj.action, log_prob=traj.log_prob,
                    adv=adv, ret=ret, done=traj.done, hidden=traj.hidden)
        _CACHE["batch"] = params, pm, data
    params, pm, data = _CACHE["batch"]
    pm = ActorCriticRNN(hidden=HIDDEN, dtype=torch.float32, device=CPU)
    pm.load_state_dict(actor_critic_rnn_from_flax(
        jax.tree.map(np.asarray, params)))
    return params, pm, data


def _jax_args(mb):
    """A port slab -> JAX loss_fn's (batch, adv, ret, h0)."""
    j = {k: jnp.asarray(v.numpy()) for k, v in mb.items()}
    obs = {k: j[k] for k in P.OBS_KEYS}
    batch = JTransition(obs, j["action"], j["log_prob"], None, None,
                        j["done"])
    return batch, j["adv"], j["ret"], j["hidden"][0]


def _close(got, want, atol, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=0,
                               atol=atol, err_msg=msg)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rnn_forward_matches_flax(dtype):
    """``forward`` and its three methods on converted parameters, from a
    nonzero hidden state: f32 within 1e-5, bf16 (one step) within 4e-3."""
    jm, params, pm = _models(dtype)
    jo, po = _obs()
    h = np.random.default_rng(0).normal(size=(64, HIDDEN)).astype(
        np.float32) * 0.5
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jh = jnp.asarray(h, jdt)
    ph = torch.from_numpy(np.array(jh.astype(jnp.float32))).to(dtype)
    (jl, jv), jh1 = jm.apply(params, jo, jh)
    jxz = jm.apply(params, jo, method="encode_inputs")
    jg = jm.apply(params, jxz, jh, method="gru_step")
    jhl, jhv = jm.apply(params, jg, method="heads")
    with torch.no_grad():
        (pl, pv), ph1 = pm(po, ph)
        (pl2, _), ph2 = pm(encode_obs(po), ph)
        pxz = pm.encode_inputs(po)
        pg = pm.gru_step(pxz, ph)
        phl, phv = pm.heads(pg)
    atol = 1e-5 if dtype == torch.float32 else 4e-3
    assert ph1.dtype == dtype and pl.dtype == torch.float32
    assert torch.equal(pl, pl2) and torch.equal(ph1, ph2)
    for got, want, name in ((pl, jl, "logits"), (pv, jv, "value"),
                            (ph1, jh1, "h"), (pxz.float(), jxz, "xz"),
                            (pg.float(), jg, "gru_step"),
                            (phl, jhl, "heads logits"),
                            (phv, jhv, "heads value")):
        _close(got.float(), want.astype(jnp.float32), atol, name)
    assert float(np.abs(np.asarray(jl)).max()) < 2.0
    init = pm.initial_state(5)
    assert init.dtype == dtype and init.shape == (5, HIDDEN)
    assert not init.any()
    back = actor_critic_rnn_to_flax(pm.state_dict())
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        a, np.asarray(b, np.float32)), back, params)


def test_init_params_rnn_follows_flax_initializers():
    m = init_params_rnn(ActorCriticRNN(hidden=256, dtype=torch.float32,
                                       device=CPU),
                        torch.Generator().manual_seed(0))
    jshapes = jax.tree.map(lambda x: x.shape, jax.eval_shape(
        lambda k: j_init_rnn(k, model=JRNN(hidden=256)),
        jax.random.PRNGKey(0)))
    got = jax.tree.map(lambda x: x.shape,
                       actor_critic_rnn_to_flax(m.state_dict()))
    assert got == jshapes
    for layer in (m.gru_x, m.gru_h):
        w = layer.weight.detach()
        fan_in = layer.in_features
        assert float(w.abs().max()) <= 2 / np.sqrt(fan_in) / .8796 + 1e-6
        assert abs(float(w.std()) * np.sqrt(fan_in) - 1.0) < 0.05
    assert m.gru_h.bias is None
    assert float(m.bhn.detach().abs().max()) == 0.0
    assert float(m.gru_x.bias.detach().abs().max()) == 0.0
    assert abs(float(m.mission_table.detach().std()) - 1.0) < 0.05


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rnn_factored_matches_stepwise(dtype):
    """The update's slab replay (``replay_slab``: the inputs encoded over
    the whole slab, the GRU loop, the heads on the stacked outputs) gives
    what stepwise ``forward`` gives, re-zeroed at each done (the analogue
    of JAX's test_rnn_factored_cell_consistency, at its tolerance)."""
    torch.manual_seed(0)
    pm = init_params_rnn(ActorCriticRNN(hidden=HIDDEN, dtype=dtype,
                                        device=CPU),
                         torch.Generator().manual_seed(1))
    n, steps, V = 4, 5, 7
    rng = np.random.default_rng(1)
    obs = {"packed": torch.from_numpy(rng.integers(0, 11, (steps, n, V, V))
                                      .astype(np.int32)),
           "direction": torch.from_numpy(rng.integers(0, 4, (steps, n))
                                         .astype(np.int32)),
           "mission": torch.from_numpy(rng.integers(0, 5, (steps, n, 64))
                                       .astype(np.int32))}
    done = torch.from_numpy(rng.random((steps, n)) < 0.3)
    h = pm.initial_state(n)
    logits, values = [], []
    with torch.no_grad():
        for t in range(steps):
            (lg, vl), h = pm({k: v[t] for k, v in obs.items()}, h)
            h = h * (1.0 - done[t][:, None].to(h.dtype))
            logits.append(lg)
            values.append(vl)
        fl, fv = P.replay_slab(pm, dict(obs, done=done,
                                        hidden=pm.initial_state(n)[None]))
    np.testing.assert_allclose(fl.numpy(), torch.stack(logits).numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(fv.numpy(), torch.stack(values).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_recurrent_loss_and_gradients_match_jax():
    """One rotate slab (mbt=2, B=64) replayed from its stored start hidden,
    with episodes ending inside it: the loss terms and every parameter's
    gradient within 1e-5 of JAX's loss closure, f32."""
    _, fns = _closures()
    params, pm, data = _batch()
    mb = {k: v[2:4] for k, v in data.items()}
    assert mb["done"][0].any()  # the replay re-zeroes inside the slab
    (j_total, j_metrics), j_grads = jax.jit(jax.value_and_grad(
        fns["loss_fn"], has_aux=True))(params, *_jax_args(mb))
    cfg = P.PPOConfig(num_envs=B, rollout_len=T, num_minibatches=NMB)
    total, metrics = P.ppo_loss(pm, cfg, mb)
    total.backward()
    for k, v in metrics.items():
        _close(float(v), float(j_metrics[k]), 1e-5, k)
    assert abs(float(j_metrics["entropy"])) > 1.0
    got = actor_critic_rnn_to_flax({k: p.grad for k, p in
                                    pm.named_parameters()})
    jax.tree.map(lambda a, b: _close(a, b, 1e-5), got,
                 jax.tree.map(np.asarray, j_grads))
    assert float(np.abs(np.asarray(j_grads["params"]["bhn"])).max()) > 0


def test_recurrent_rotate_epoch_matches_optax():
    """A whole f32 rotate epoch at offset 1 from a fresh optimizer, each
    slab replayed from its stored start hidden ``hidden[j * mbt]``, then
    one at offset 3 continued from optax's state carried across
    (``adam_state_from_optax`` on the RNN's trees): the parameters within
    1e-5 of optax's."""
    jcfg, fns = _closures()
    params, pm, data = _batch()
    cfg = P.PPOConfig(num_envs=B, rollout_len=T, num_minibatches=NMB)
    opt = j_make_optimizer(jcfg)
    opt_state = opt.init(params)
    grad = jax.jit(jax.grad(lambda *a: fns["loss_fn"](*a)[0]))
    optimizer = P.make_optimizer(pm, cfg)
    for offset in (1, 3):
        if offset == 3:
            pm.load_state_dict(actor_critic_rnn_from_flax(
                jax.tree.map(np.asarray, params)))
            adam = opt_state[1][0]
            adam_state_from_optax(optimizer, pm,
                                  jax.tree.map(np.asarray, adam.mu),
                                  jax.tree.map(np.asarray, adam.nu),
                                  np.asarray(adam.count))
        for i, mb in enumerate(P.epoch_minibatches(data, cfg, None,
                                                   offset=offset)):
            j = (i + offset) % NMB
            assert torch.equal(mb["hidden"][0],
                               data["hidden"][j * (T // NMB)])
            g = grad(params, *_jax_args(mb))
            updates, opt_state = opt.update(g, opt_state, params)
            params = optax.apply_updates(params, updates)
            P.update_minibatch(pm, optimizer, cfg, mb)
        got = actor_critic_rnn_to_flax(pm.state_dict())
        jax.tree.map(lambda a, b: _close(a, b, 1e-5), got, params)
    assert int(opt_state[1][0].count) == 2 * NMB


def test_recurrent_rollout_matches_jax_composition():
    """8 pooled-rollout steps at B=64 with the f32 recurrent policy from a
    nonzero hidden state, against JAX's recurrent rollout body composed
    step by step: actions, rewards, dones and stored observations exact;
    the stored input hiddens, carried hidden, log-probs and values within
    1e-5; finished envs' hidden zeroed after their step."""
    jm, params, pm = _models(seed=1)
    env, jst = jax_states(DK8, B, seed=5)
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
    h0 = np.random.default_rng(10).normal(size=(B, HIDDEN)).astype(
        np.float32) * 0.5

    penv = minigrid_tpu_torch.make(DK8, device=CPU).packed()
    noise = P.RolloutNoise(torch.from_numpy(keys.view(np.int32)),
                           torch.from_numpy(gumbel),
                           pool_from_states(export(j_rows)))
    pobs0 = {k: torch.from_numpy(np.array(v)) for k, v in jobs.items()}
    p_st, p_obs, traj, _, p_h = P.rollout(pm, penv, export(jst), pobs0,
                                          noise, h=torch.from_numpy(h0))

    def counts_of(tokens):
        return (tokens[..., None] == jnp.arange(VOCAB_SIZE)).sum(-2).astype(
            jnp.uint8)

    @jax.jit
    def jstep(st, obs, counts, h, k, gum, row):
        enc = {"img_feat": j_encode_obs({"packed": obs["packed"],
                                         "direction": obs["direction"],
                                         "mission_counts": counts})[
                                             "img_feat"],
               "mission_counts": counts, "direction": obs["direction"]}
        h_in = h
        (logits, value), h = jm.apply(params, enc, h)
        action = jnp.argmax(logits + gum, axis=-1)
        log_prob = j_selected_log_prob(jax.nn.log_softmax(logits), action)
        obs, st, reward, term, trunc, _ = j_autoreset_presampled(
            env, k, st, action, row)
        done = term | trunc
        h = h * (1.0 - done[:, None].astype(h.dtype))
        counts = jnp.where(done[:, None], counts_of(row.mission)[None],
                           counts)
        return st, obs, counts, h, (h_in, action, log_prob, value, reward,
                                    done)

    counts, st, obs, h = counts_of(jobs["mission"]), jst, jobs, jnp.asarray(
        h0)
    n_done = 0
    for t in range(T):
        row = jax.tree.map(lambda x: x[t], j_rows)
        st, obs, counts, h, (h_in, action, log_prob, value, reward, done) = \
            jstep(st, obs, counts, h, jnp.asarray(keys[t]),
                  jnp.asarray(gumbel[t]), row)
        msg = f"step {t}"
        np.testing.assert_array_equal(traj.action[t].numpy(),
                                      np.asarray(action), err_msg=msg)
        np.testing.assert_array_equal(traj.reward[t].numpy(),
                                      np.asarray(reward), err_msg=msg)
        np.testing.assert_array_equal(traj.done[t].numpy(), np.asarray(done),
                                      err_msg=msg)
        _close(traj.hidden[t], h_in, 1e-5, msg)
        _close(traj.log_prob[t], log_prob, 1e-5, msg)
        _close(traj.value[t], value, 1e-5, msg)
        n_done += int(np.asarray(done).sum())
    assert n_done >= B // 2
    _close(p_h, h, 1e-5)
    done_last = traj.done[-1]
    assert done_last.any() and not p_h[done_last].any()
    np.testing.assert_array_equal(p_obs["packed"].numpy(),
                                  np.asarray(obs["packed"]))


def test_recurrent_needs_rotate_shuffle():
    """A recurrent model with another shuffle than "rotate" is refused, as
    JAX asserts; the MLP keeps every shuffle."""
    env = minigrid_tpu_torch.make("MiniGrid-Empty-5x5-v0", device=CPU)
    model = ActorCriticRNN(hidden=16, device=CPU)
    cfg = P.PPOConfig(num_envs=8, rollout_len=8)
    opt = P.make_optimizer(model, cfg)
    jenv = minigrid_tpu.make("MiniGrid-Empty-5x5-v0")
    for shuffle in ("timestep", "sample"):
        bad = dataclasses.replace(cfg, shuffle=shuffle)
        with pytest.raises(ValueError, match="rotate"):
            P.make_train_step(env, model, bad, opt, resets="fresh")
        with pytest.raises(AssertionError, match="rotate"):
            jbad = JPPOConfig(num_envs=8, rollout_len=8, shuffle=shuffle)
            j_make_train_step(jenv, JRNN(hidden=16), jbad,
                              j_make_optimizer(jbad), resets="fresh")
        P.check_config(bad)  # fine for a policy without a hidden state
    with pytest.raises(ValueError, match="hidden state"):
        obs, st = env.reset(env.generator(0), 8)
        P.rollout(model, env, st, obs, P.sample_rollout_noise(
            env.generator(0), None, 8, 2, 7, CPU), "regen", env.generator(0))


def test_recurrent_train_step_loop_and_driver(tmp_path):
    """The recurrent train step (fresh resets) carries h and zeroes it in
    finished envs; ``make_train_loop`` threads it and stacks the metrics;
    ``train(recurrent=True)`` runs with checkpoints of the model and the
    optimizer, as JAX saves params and opt state only."""
    env = minigrid_tpu_torch.make("MiniGrid-Empty-5x5-v0", device=CPU)
    env = env.packed()
    cfg = P.PPOConfig(num_envs=16, rollout_len=8, num_minibatches=2)
    g = env.generator(0)
    model = init_params_rnn(ActorCriticRNN(hidden=16, device=CPU), g)
    opt = P.make_optimizer(model, cfg)
    obs, st = env.reset_staggered(g, 16)
    h = model.initial_state(16)
    before = model.gru_h.weight.detach().clone()
    step = P.make_train_step(env, model, cfg, opt, resets="fresh")
    st, obs, h, m = step(st, obs, h, g)
    assert set(m) == {"loss", "pg_loss", "v_loss", "entropy", "mean_reward",
                      "reset_overflow"}
    assert h.shape == (16, 16) and h.dtype == torch.bfloat16
    assert h.any() and not torch.equal(before, model.gru_h.weight)
    loop = P.make_train_loop(env, model, cfg, opt, steps_per_call=2,
                             resets="fresh")
    st, obs, h, m = loop(st, obs, h, g)
    assert all(v.shape == (2,) for v in m.values())

    tcfg = TrainConfig(total_env_steps=16 * 8 * 4,
                       ppo=P.PPOConfig(num_envs=16, rollout_len=8,
                                       num_minibatches=2),
                       hidden=16, recurrent=True, resets="fresh",
                       steps_per_call=2, log_every=1,
                       checkpoint_dir=str(tmp_path), checkpoint_every=1)
    trained, hist = train("MiniGrid-Empty-5x5-v0", tcfg, device=CPU)
    assert isinstance(trained, ActorCriticRNN) and len(hist) == 2
    assert hist[-1]["env_steps"] == 16 * 8 * 4
    opt = P.make_optimizer(trained, tcfg.ppo)
    like = {"model": trained.state_dict(), "optimizer": opt.state_dict()}
    for p in trained.parameters():  # an optimizer state of that layout
        p.grad = torch.zeros_like(p)
    opt.step()
    like["optimizer"] = opt.state_dict()
    saved = restore_pytree(str(tmp_path / "step_2"), like)
    assert set(saved) == {"model", "optimizer"}
    assert "gru_h.weight" in saved["model"]
    opt.load_state_dict(saved["optimizer"])
    assert float(opt.state_dict()["state"][0]["step"]) == 4 * 2


def test_recurrent_evaluate_matches_jax():
    """The recurrent branch of the eval: greedy on the same 128 exported
    DoorKey-5x5 reset layouts, h carried from ``initial_state`` without
    zeroing, f32 on both sides: the same success rate as JAX's."""
    jm, params, pm = _models(seed=3)
    env_id, n = "MiniGrid-DoorKey-5x5-v0", 128
    jenv = minigrid_tpu.make(env_id).packed()
    key = jax.random.PRNGKey(4)
    want = j_evaluate_success(jenv, jm, params, n_episodes=n, key=key,
                              max_steps=12, require_all_done=False)
    k_reset, _ = jax.random.split(key)
    obs0, st0 = jax.jit(jax.vmap(jenv.reset))(jax.random.split(k_reset, n))
    penv = minigrid_tpu_torch.make(env_id, device=CPU).packed()
    got = evaluate_success_from(
        penv, pm, {k: torch.from_numpy(np.array(v)) for k, v in obs0.items()},
        export(st0), max_steps=12, require_all_done=False)
    assert got == want


def test_ppo_learns_recurrent():
    """JAX's test_ppo_learns_recurrent on the port: Empty-5x5 packed, fresh
    resets, ActorCriticRNN(hidden=64) bf16, PPOConfig(num_envs=128,
    rollout_len=64, lr=1e-3), 30 train steps: last5 > 0.10 and > 5 x
    first5."""
    env = minigrid_tpu_torch.make("MiniGrid-Empty-5x5-v0",
                                  device=CPU).packed()
    cfg = P.PPOConfig(num_envs=128, rollout_len=64, lr=1e-3)
    g = env.generator(0)
    model = init_params_rnn(ActorCriticRNN(hidden=64, device=CPU), g)
    opt = P.make_optimizer(model, cfg)
    obs, st = env.reset_staggered(g, cfg.num_envs)
    h = model.initial_state(cfg.num_envs)
    step = P.make_train_step(env, model, cfg, opt, resets="fresh")
    rewards = []
    for _ in range(30):
        st, obs, h, m = step(st, obs, h, g)
        rewards.append(float(m["mean_reward"]))
    first, last = sum(rewards[:5]) / 5, sum(rewards[-5:]) / 5
    assert last > 0.10, f"final reward {last:.4f} too low: {rewards}"
    assert last > 5 * max(first, 1e-4), (
        f"no learning with the recurrent policy: first5={first:.4f} "
        f"last5={last:.4f}")
