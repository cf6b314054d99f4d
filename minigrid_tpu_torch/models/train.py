"""End-to-end PPO training: the `train` entry point.

Counterpart of ``minigrid_tpu/models/train.py`` on one device: packed
observations, a staggered batch, pooled, fresh or regen auto-resets with
pool refreshes between train steps, ``steps_per_call`` train steps per call
(``make_train_loop``), periodic checkpoints (``utils/checkpoint.py``) and a
metrics history. Metrics are read on the host only at the logging points.
With ``recurrent`` the policy is an ``ActorCriticRNN`` whose hidden state
threads across train steps (``shuffle="rotate"``, the default, required).

    from minigrid_tpu_torch.models.train import TrainConfig, train
    model, history = train("MiniGrid-DoorKey-8x8-v0",
                           TrainConfig(total_env_steps=50_000_000))
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import minigrid_tpu_torch
from minigrid_tpu_torch.core.types import resolve_device
from minigrid_tpu_torch.envs.base import (make_layout_pool,
                                          refresh_layout_pool)
from minigrid_tpu_torch.models.actor_critic import (ActorCritic,
                                                    ActorCriticRNN,
                                                    init_params,
                                                    init_params_rnn)
from minigrid_tpu_torch.models.ppo import (PPOConfig, make_optimizer,
                                           make_train_loop, make_train_step)
from minigrid_tpu_torch.utils.checkpoint import save_pytree


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The JAX package's training settings, with the same defaults."""

    total_env_steps: int = 10_000_000
    ppo: PPOConfig = dataclasses.field(default_factory=PPOConfig)
    hidden: int = 256
    seed: int = 0
    packed_obs: bool = True
    recurrent: bool = False          # ActorCriticRNN, hidden state threaded
    # None -> "pooled" if pool_size > 0 else "regen"
    resets: str | None = None
    fresh_buffer: int | None = None  # override for dynamic-budget envs
    steps_per_call: int = 1          # train steps per make_train_loop call
    pool_size: int = 1024            # 0 disables pooling
    pool_refresh_every: int = 8      # train steps between pool refreshes
    checkpoint_dir: str | None = None
    checkpoint_every: int = 100      # train steps between checkpoints
    log_every: int = 10
    devices: int = 1                 # >1 not ported (ROADMAP item 15)


def train(env_id: str, cfg: TrainConfig = TrainConfig(),
          log_fn: Callable[[dict], None] | None = None, device=None):
    """Run PPO to ``total_env_steps`` on ``device`` (the card by default).
    Returns (model, history): the trained :class:`ActorCritic` (or
    :class:`ActorCriticRNN` with ``cfg.recurrent``) and the logged metrics
    (floats, with ``update``, ``env_steps`` and ``env_steps_per_s``)."""
    if cfg.devices > 1:
        raise NotImplementedError(
            "multi-GPU training is not ported yet (ROADMAP Queue 1 item 15)")
    dev = resolve_device(device)
    env = minigrid_tpu_torch.make(env_id, device=dev)
    if cfg.packed_obs:
        env = env.packed()
    pcfg = cfg.ppo
    g = env.generator(cfg.seed)
    cls, init = ((ActorCriticRNN, init_params_rnn) if cfg.recurrent
                 else (ActorCritic, init_params))
    model = init(cls(view_size=env.params.view_size, hidden=cfg.hidden,
                     device=dev), g)
    optimizer = make_optimizer(model, pcfg)

    resets = cfg.resets or ("pooled" if cfg.pool_size > 0 else "regen")
    pooled = resets == "pooled"
    if pooled and cfg.pool_size <= 0:
        raise ValueError(f"resets='pooled' needs pool_size > 0 (got "
                         f"{cfg.pool_size}); raise it or pick "
                         "resets='fresh'/'regen'")
    pool = make_layout_pool(env, g, cfg.pool_size) if pooled else None
    K = max(1, cfg.steps_per_call)
    kw = dict(resets=resets, fresh_buffer=cfg.fresh_buffer)
    train_step = (make_train_loop(env, model, pcfg, optimizer,
                                  steps_per_call=K, **kw) if K > 1 else
                  make_train_step(env, model, pcfg, optimizer, **kw))

    obs, st = env.reset_staggered(g, pcfg.num_envs)
    h = model.initial_state(pcfg.num_envs) if cfg.recurrent else None
    steps_per_update = pcfg.num_envs * pcfg.rollout_len * K
    num_updates = max(1, cfg.total_env_steps // steps_per_update)
    history = []
    t0 = time.perf_counter()
    for u in range(num_updates):
        if cfg.recurrent:
            st, obs, h, m = train_step(st, obs, h, g, pool)
        else:
            st, obs, m = train_step(st, obs, g, pool)
        if K > 1:  # metrics stacked (K,): report the last step's
            m = {k: v[-1] for k, v in m.items()}
        if pooled and (u + 1) % cfg.pool_refresh_every == 0:
            pool = refresh_layout_pool(env, g, pool)
        if (u + 1) % cfg.log_every == 0 or u == num_updates - 1:
            metrics = {k: float(v) for k, v in m.items()}
            metrics["update"] = u + 1
            metrics["env_steps"] = (u + 1) * steps_per_update
            metrics["env_steps_per_s"] = metrics["env_steps"] / (
                time.perf_counter() - t0)
            history.append(metrics)
            if log_fn is not None:
                log_fn(metrics)
        if cfg.checkpoint_dir and (u + 1) % cfg.checkpoint_every == 0:
            save_pytree(f"{cfg.checkpoint_dir}/step_{u + 1}",
                        {"model": model.state_dict(),
                         "optimizer": optimizer.state_dict()})
    return model, history


def main():  # pragma: no cover - CLI convenience
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--env", default="MiniGrid-Empty-8x8-v0")
    ap.add_argument("--total-env-steps", type=int, default=10_000_000)
    ap.add_argument("--num-envs", type=int, default=4096)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resets", choices=("pooled", "fresh", "regen"))
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    cfg = TrainConfig(
        total_env_steps=args.total_env_steps,
        ppo=PPOConfig(num_envs=args.num_envs), hidden=args.hidden,
        seed=args.seed, resets=args.resets,
        checkpoint_dir=args.checkpoint_dir)
    _, history = train(args.env, cfg, log_fn=lambda m: print(json.dumps(m)),
                       device=args.device)
    print(json.dumps({"final": history[-1] if history else {}}))


if __name__ == "__main__":
    main()
