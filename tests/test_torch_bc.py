"""The port's imitation pipeline (minigrid_tpu_torch/utils/demos.py,
minigrid_tpu_torch/models/bc.py) and the eval's dynamic-budget cap against
the JAX package: ``flatten_demos`` bit-exact on one DemoBatch; a BC epoch
fed JAX's permutation against JAX's ``behavior_clone``, float32, per-epoch
loss and accuracy and the parameters within 1e-5 (the matmuls sum in
different orders, as tests/test_torch_ppo.py states); the cap that
``evaluate_success`` derives on a BabyAI level equal to JAX's on the same
exported states; ``generate_demos`` batched equal to one seed at a time;
and JAX's BC learning guard on the CPU."""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import minigrid_tpu
from minigrid_tpu.models import eval as JE
from minigrid_tpu.models.actor_critic import ActorCritic as JActorCritic
from minigrid_tpu.models.actor_critic import init_params as j_init_params
from minigrid_tpu.models.bc import behavior_clone as j_behavior_clone
from minigrid_tpu.models.bc import flatten_demos as j_flatten_demos

import minigrid_tpu_torch
from minigrid_tpu_torch.convert import (actor_critic_from_flax,
                                        actor_critic_to_flax)
from minigrid_tpu_torch.models.actor_critic import (ActorCritic,
                                                    ActorCriticRNN,
                                                    init_params)
from minigrid_tpu_torch.models.bc import (bc_epoch, bc_minibatches,
                                          behavior_clone, flatten_demos)
from minigrid_tpu_torch.models.eval import (episode_budget,
                                            evaluate_success_from)
from minigrid_tpu_torch.utils.demos import generate_demos, run_bot_episodes

from tests.torch_port_utils import share_cpu, CPU, export  # noqa: F401

LEVEL = "BabyAI-GoToRedBallGrey-v0"
_CACHE: dict = {}

pytestmark = pytest.mark.usefixtures("share_cpu")


def port_env():
    if "env" not in _CACHE:
        _CACHE["env"] = minigrid_tpu_torch.make(LEVEL, device=CPU)
    return _CACHE["env"]


def demos(n):
    """The port's bot demos of the level on the CPU, n episodes, shared."""
    if ("demos", n) not in _CACHE:
        _CACHE[("demos", n)] = generate_demos(port_env(), n)
    return _CACHE[("demos", n)]


def test_flatten_demos_matches_jax():
    d = demos(12)
    want = j_flatten_demos(d)
    got = flatten_demos(d)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    assert len(got["action"]) == int(d.length.sum())


def test_bc_epoch_matches_jax():
    """Two f32 epochs at batch 32 on JAX's permutation of the samples: the
    per-epoch loss and accuracy, and the parameters after them, within
    1e-5 of JAX's ``behavior_clone`` from the same initial parameters; the
    value head is left as it was."""
    d = demos(12)
    jm = JActorCritic(hidden=32, dtype=jnp.float32)
    params0 = jax.jit(lambda k: j_init_params(k, model=jm))(
        jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(3)
    j_params, j_hist = j_behavior_clone(jm, params0, d, epochs=2,
                                        batch_size=32, lr=1e-3, key=key)
    pm = ActorCritic(hidden=32, dtype=torch.float32, device=CPU)
    pm.load_state_dict(actor_critic_from_flax(jax.tree.map(np.asarray,
                                                           params0)))
    flat = flatten_demos(d)
    perm = np.asarray(jax.random.permutation(key, len(flat["action"])))
    batches = bc_minibatches(flat, perm, 32, CPU)
    assert batches["action"].shape[0] == len(perm) // 32 >= 2
    opt = torch.optim.Adam(pm.parameters(), lr=1e-3, betas=(0.9, 0.999),
                           eps=1e-8)
    value_before = pm.value.weight.detach().clone()
    for epoch in range(2):
        ce, acc = bc_epoch(pm, opt, batches)
        np.testing.assert_allclose(float(ce), j_hist[epoch]["loss"], rtol=0,
                                   atol=1e-5, err_msg=f"epoch {epoch} loss")
        np.testing.assert_allclose(float(acc), j_hist[epoch]["accuracy"],
                                   rtol=0, atol=1e-5,
                                   err_msg=f"epoch {epoch} accuracy")
    got = actor_critic_to_flax(pm.state_dict())
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, np.asarray(b), rtol=0, atol=1e-5), got, j_params)
    assert torch.equal(pm.value.weight, value_before)


def test_generate_demos_batched_and_replayable():
    """The seeds' episodes run as one batch give the episodes of the
    one-seed-at-a-time loop (each seed a batch of its own through
    ``run_bot_episodes``); each demo's seed regenerates its layout, whose
    actions replayed solve it at the last step; an exhausted seed budget
    raises."""
    env = port_env()
    one = generate_demos(env, 5, start_seed=3)
    alone = [(s, run_bot_episodes(env, [s])[0]) for s in range(3, 3 + 12)]
    alone = [(s, ep) for s, ep in alone if ep[4]][:5]
    assert len(alone) == 5
    assert one.seed.tolist() == [s for s, _ in alone]
    for i, (s, (images, dirs, actions, mission, _)) in enumerate(alone):
        L = len(actions)
        assert int(one.length[i]) == L, f"seed {s}"
        np.testing.assert_array_equal(one.image[i, :L], np.stack(images))
        np.testing.assert_array_equal(one.direction[i, :L], dirs)
        np.testing.assert_array_equal(one.action[i, :L], actions)
        np.testing.assert_array_equal(one.mission[i], mission)
        assert not one.image[i, L:].any() and not one.action[i, L:].any()
    assert one.mask.sum(1).tolist() == one.length.tolist()
    assert (np.diff(one.seed) > 0).all() and one.seed[0] >= 3
    for i in (0, 4):
        obs, st = env.reset(env.generator(int(one.seed[i])), 1)
        np.testing.assert_array_equal(obs["image"][0].numpy(), one.image[i, 0])
        for t in range(int(one.length[i])):
            keys = torch.tensor([[0, t]], dtype=torch.int32)
            obs, st, r, te, tr, _ = env.step(
                keys, st, torch.tensor([int(one.action[i, t])]))
        assert bool(te[0]) and float(r[0]) > 0
    with pytest.raises(RuntimeError, match="exhausted"):
        generate_demos(env, 2, max_steps=1, max_seed_tries=3)


def test_eval_cap_matches_jax_on_a_babyai_level():
    """A BabyAI level keeps a 2^30 sentinel in ``params.max_steps``: without
    ``max_steps`` the eval runs the batch's largest episode budget. On the
    same exported reset states the port's cap equals the one JAX's
    ``evaluate_success`` derives (the T of its compiled runner), and the
    greedy f32 policy's success rate equals JAX's; an explicit
    ``max_steps`` still overrides it."""
    n = 64
    jenv = minigrid_tpu.make(LEVEL)
    jm = JActorCritic(hidden=32, dtype=jnp.float32)
    params = jax.jit(lambda k: j_init_params(k, model=jm))(
        jax.random.PRNGKey(1))
    key = jax.random.PRNGKey(2)
    JE._RUN_CACHE.clear()
    want = JE.evaluate_success(jenv, jm, params, n_episodes=n, key=key)
    (j_cap,) = [k[2] for k in JE._RUN_CACHE if len(k) == 4
                and k[0] == id(jenv) and k[1] == id(jm)]
    k_reset, _ = jax.random.split(key)
    obs0, st0 = jax.jit(jax.vmap(jenv.reset))(jax.random.split(k_reset, n))
    penv = minigrid_tpu_torch.make(LEVEL, device=CPU)
    pst = export(st0)
    assert penv.params.max_steps > 1 << 16
    assert episode_budget(penv, pst) == j_cap < 1 << 16
    assert episode_budget(penv, pst, max_steps=7) == 7
    pm = ActorCritic(hidden=32, dtype=torch.float32, device=CPU)
    pm.load_state_dict(actor_critic_from_flax(jax.tree.map(np.asarray,
                                                           params)))
    got = evaluate_success_from(
        penv, pm, {k: torch.from_numpy(np.array(v)) for k, v in obs0.items()},
        pst)
    assert got == want


def test_behavior_cloning_smoke():
    """JAX's test_behavior_cloning_smoke on the port: 40 bot demos of
    GoToRedBallGrey, ActorCritic(hidden=64), 40 epochs at batch 128: the
    loss falls below 0.6 x its first epoch's and the accuracy rises above
    0.55. A recurrent model is refused."""
    d = demos(40)
    g = torch.Generator().manual_seed(0)
    model = init_params(ActorCritic(hidden=64, device=CPU), g)
    hist = behavior_clone(model, d, epochs=40, batch_size=128, generator=g)
    assert len(hist) == 40
    assert hist[-1]["loss"] < 0.6 * hist[0]["loss"], hist
    assert hist[-1]["accuracy"] > 0.55, hist[-1]
    with pytest.raises(ValueError, match="hidden state"):
        behavior_clone(ActorCriticRNN(hidden=16, device=CPU), d, epochs=1)
