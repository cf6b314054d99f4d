"""The port's learning stack end to end on the CPU: the JAX package's
learning guards (tests/test_learning.py) on Empty-5x5 in the regen,
pooled+packed and fresh reset modes with the same configurations and
thresholds; ``evaluate_success`` against the JAX package's on exported
states; ``train`` with checkpoints; checkpoint round trips and
key-path checks. The DoorKey-5x5 guard (120 updates at B=256) runs on the
card only (chip_smoke.py)."""

from __future__ import annotations

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import minigrid_tpu
from minigrid_tpu.models.actor_critic import ActorCritic as JActorCritic
from minigrid_tpu.models.eval import evaluate_success as j_evaluate_success
from minigrid_tpu.utils.checkpoint import (state_fingerprint as
                                           j_state_fingerprint)

import minigrid_tpu_torch
from minigrid_tpu_torch.convert import (actor_critic_from_flax,
                                        actor_critic_to_flax)
from minigrid_tpu_torch.models.actor_critic import ActorCritic, init_params
from minigrid_tpu_torch.models.eval import (evaluate_success,
                                            evaluate_success_from)
from minigrid_tpu_torch.models.ppo import (PPOConfig, make_optimizer,
                                           make_train_step)
from minigrid_tpu_torch.models.train import TrainConfig, train
from minigrid_tpu_torch.utils.checkpoint import (restore_pytree, save_pytree,
                                                 state_fingerprint)

from tests.torch_port_utils import (share_cpu,  # noqa: F401
                                    CPU, export, jax_states)

pytestmark = pytest.mark.usefixtures("share_cpu")


def run_ppo(env_id: str, updates: int, resets: str, packed: bool,
            num_epochs: int = 2, num_envs: int = 128,
            ent_coef: float = 0.01):
    """tests/test_learning.py::run_ppo on the port: the bf16 ActorCritic
    with hidden=64, B=128, T=64, 4 minibatches, lr 1e-3; staggered starts
    and a 256-row pool refreshed every 8 updates when pooled. Returns
    (mean rewards per update, model)."""
    env = minigrid_tpu_torch.make(env_id, device=CPU)
    if packed:
        env = env.packed()
    cfg = PPOConfig(num_envs=num_envs, rollout_len=64, num_epochs=num_epochs,
                    num_minibatches=4, lr=1e-3, ent_coef=ent_coef)
    g = env.generator(0)
    model = init_params(ActorCritic(hidden=64, device=CPU), g)
    opt = make_optimizer(model, cfg)
    reset = env.reset if resets == "regen" else env.reset_staggered
    obs, st = reset(g, num_envs)
    pool = env.make_pool(g, 256) if resets == "pooled" else None
    step = make_train_step(env, model, cfg, opt, resets=resets)
    rewards = []
    for u in range(updates):
        st, obs, m = step(st, obs, g, pool)
        rewards.append(float(m["mean_reward"]))
        if pool is not None and u % 8 == 7:  # refresh off the hot path
            pool = env.make_pool(g, 256)
    return rewards, model


def assert_learns(r):
    first, last = sum(r[:5]) / 5, sum(r[-5:]) / 5
    assert last > 0.10, f"final reward {last:.4f} too low: {r}"
    assert last > 5 * max(first, 1e-4), (
        f"no learning: first5={first:.4f} last5={last:.4f}")


@pytest.fixture(scope="module")
def regen_run(share_cpu):
    return run_ppo("MiniGrid-Empty-5x5-v0", 30, "regen", packed=False)


def test_ppo_learns_empty_regen(regen_run):
    assert_learns(regen_run[0])


def test_ppo_learns_empty_pooled_packed():
    assert_learns(run_ppo("MiniGrid-Empty-5x5-v0", 30, "pooled",
                          packed=True)[0])


def test_ppo_learns_fresh_resets():
    """The JAX guard's PPOConfig(num_envs=128, rollout_len=64, lr=1e-3):
    one epoch."""
    assert_learns(run_ppo("MiniGrid-Empty-5x5-v0", 30, "fresh", packed=True,
                          num_epochs=1)[0])


def test_evaluate_success_matches_jax(regen_run):
    """The regen-trained policy in f32 on both sides (its weights carried to
    Flax by ``actor_critic_to_flax``), greedy on the same 256 reset
    layouts of Empty-Random-6x6 within 5 steps (the starts far from the
    goal fail): the same success rate."""
    model = regen_run[1]
    params = actor_critic_to_flax(model.state_dict())
    jm = JActorCritic(hidden=64, dtype=jnp.float32)
    pm = ActorCritic(hidden=64, dtype=torch.float32, device=CPU)
    pm.load_state_dict(actor_critic_from_flax(params))
    env_id, n = "MiniGrid-Empty-Random-6x6-v0", 256
    jenv = minigrid_tpu.make(env_id)
    key = jax.random.PRNGKey(5)
    want = j_evaluate_success(jenv, jm, params, n_episodes=n, key=key,
                              max_steps=5, require_all_done=False)
    k_reset, _ = jax.random.split(key)
    obs0, st0 = jax.jit(jax.vmap(jenv.reset))(jax.random.split(k_reset, n))
    penv = minigrid_tpu_torch.make(env_id, device=CPU)
    got = evaluate_success_from(
        penv, pm, {k: torch.from_numpy(np.array(v)) for k, v in obs0.items()},
        export(st0), max_steps=5, require_all_done=False)
    assert got == want
    assert 0.2 < want < 1.0, want
    rate = evaluate_success(penv, pm, 64, penv.generator(1))
    assert 0.0 <= rate <= 1.0
    with pytest.raises(ValueError, match="still running"):
        evaluate_success(penv, ActorCritic(device=CPU), 8, max_steps=3)


@pytest.mark.parametrize("resets,steps_per_call", [
    ("pooled", 1), ("fresh", 2), ("regen", 1)])
def test_train_smoke_with_checkpoints(tmp_path, resets, steps_per_call):
    """``train``: reset modes, pool refreshes, K steps per call,
    the metrics history and checkpoints that restore into the model and
    the optimizer."""
    cfg = TrainConfig(
        total_env_steps=16 * 8 * 6,  # 6 train steps
        ppo=PPOConfig(num_envs=16, rollout_len=8, num_epochs=1,
                      num_minibatches=2),
        hidden=32, resets=resets, steps_per_call=steps_per_call,
        pool_size=8, pool_refresh_every=2, log_every=2,
        checkpoint_dir=str(tmp_path), checkpoint_every=3 // steps_per_call)
    model, history = train("MiniGrid-Empty-5x5-v0", cfg, device=CPU)
    assert history and all(abs(m["loss"]) < 1e6 and m["env_steps"] > 0
                           for m in history)
    assert history[-1]["env_steps"] == 16 * 8 * 6
    assert ("reset_overflow" in history[-1]) == (resets == "fresh")
    last = 6 // steps_per_call
    assert os.path.exists(tmp_path / f"step_{last}.npz")
    fresh = ActorCritic(hidden=32, device=CPU)
    opt = make_optimizer(fresh, cfg.ppo)
    for p in fresh.parameters():  # an optimizer state of the same layout
        p.grad = torch.zeros_like(p)
    opt.step()
    like = {"model": fresh.state_dict(), "optimizer": opt.state_dict()}
    back = restore_pytree(str(tmp_path / f"step_{last}"), like)
    for k, v in model.state_dict().items():
        assert torch.equal(back["model"][k], v), k
    opt.load_state_dict(back["optimizer"])
    assert float(opt.state_dict()["state"][0]["step"]) == 6 * 2


def test_train_refuses_what_is_not_ported():
    # a batch that does not split over the ranks, as JAX's sharding refuses
    with pytest.raises(ValueError, match="does not split"):
        train("MiniGrid-Empty-5x5-v0", TrainConfig(
            devices=2, ppo=PPOConfig(num_envs=5)), device=CPU)
    with pytest.raises(ValueError, match="pool_size"):
        train("MiniGrid-Empty-5x5-v0", TrainConfig(resets="pooled",
                                                   pool_size=0), device=CPU)


def test_checkpoint_round_trip_and_key_path_checks(tmp_path):
    """Model, optimizer and env batch restore exactly; a renamed key or a
    changed shape raises instead of mis-assigning; the env state's
    fingerprint equals the JAX package's on the same batch."""
    _, jst = jax_states("MiniGrid-DoorKey-8x8-v0", 8)
    st = export(jst)
    penv = minigrid_tpu_torch.make("MiniGrid-DoorKey-8x8-v0",
                                   device=CPU).packed()
    model = ActorCritic(hidden=32, device=CPU)
    opt = make_optimizer(model, PPOConfig())
    model(penv.reset(penv.generator(0), 4)[0])[1].sum().backward()
    opt.step()
    tree = {"model": model.state_dict(), "optimizer": opt.state_dict(),
            "env": st, "seen": [3, 0.5, True]}
    path = str(tmp_path / "ckpt")
    save_pytree(path, tree)

    def zeros(x):
        if isinstance(x, torch.Tensor):
            return torch.zeros_like(x)
        if isinstance(x, dict):
            return {k: zeros(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(zeros(v) for v in x)
        return x

    like = {k: zeros(v) for k, v in tree.items() if k != "env"}
    like["env"] = st.map(torch.zeros_like)
    like["seen"] = [0, 0.0, False]
    back = restore_pytree(path, like)
    for k, v in tree["model"].items():
        assert torch.equal(back["model"][k], v), k
    for k, v in st.tensors().items():
        assert torch.equal(getattr(back["env"], k), v), k
    assert back["seen"] == [3, 0.5, True]
    exp = tree["optimizer"]["state"][1]["exp_avg"]
    assert torch.equal(back["optimizer"]["state"][1]["exp_avg"], exp)
    assert state_fingerprint(back["env"]) == state_fingerprint(st) == \
        j_state_fingerprint(jst)

    renamed = dict(like, model={("x" + k if k == "value.bias" else k): v
                                for k, v in like["model"].items()})
    with pytest.raises(ValueError, match="key paths"):
        restore_pytree(path, renamed)
    small = dict(like, model=ActorCritic(hidden=16, device=CPU).state_dict())
    with pytest.raises(ValueError, match="shape"):
        restore_pytree(path, small)
