"""End-to-end PPO training: the `train` entry point.

Counterpart of ``minigrid_tpu/models/train.py``: packed observations, a
staggered batch, pooled, fresh or regen auto-resets with pool refreshes
between train steps, ``steps_per_call`` train steps per call
(``make_train_loop``), periodic checkpoints (``utils/checkpoint.py``) and a
metrics history. Metrics are read on the host only at the logging points.
With ``recurrent`` the policy is an ``ActorCriticRNN`` whose hidden state
threads across train steps (``shuffle="rotate"``, the default, required).
With ``devices`` > 1 the batch is split over that many data-parallel
ranks (``parallel/``), spawned by ``train`` or brought by ``torchrun``.

    from minigrid_tpu_torch.models.train import TrainConfig, train
    model, history = train("MiniGrid-DoorKey-8x8-v0",
                           TrainConfig(total_env_steps=50_000_000))
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable

import torch
import torch.distributed as dist

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
from minigrid_tpu_torch.parallel import mesh as M
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
    devices: int = 1                 # data-parallel ranks (1 = no mesh)


def train(env_id: str, cfg: TrainConfig = TrainConfig(),
          log_fn: Callable[[dict], None] | None = None, device=None,
          backend: str | None = None):
    """Run PPO to ``total_env_steps`` on ``device`` (the card by default).
    Returns (model, history): the trained :class:`ActorCritic` (or
    :class:`ActorCriticRNN` with ``cfg.recurrent``) and the logged metrics
    (floats, with ``update``, ``env_steps`` and ``env_steps_per_s``).

    ``cfg.devices = n > 1`` trains data-parallel over n ranks
    (``parallel/``), each stepping ``num_envs / n`` envs; the metrics are
    global, and only rank 0 logs and checkpoints. Inside an initialised
    process group of n ranks (e.g. under ``torchrun --nproc-per-node=n``)
    this process is one rank, on ``device`` or else ``cuda:LOCAL_RANK``.
    Otherwise ``train`` spawns the n ranks itself (``backend``: "nccl", a
    card a rank, by default on cards; "gloo" on the CPU or for ranks
    sharing one card), calls ``log_fn`` here as rank 0 logs, and returns
    rank 0's model, on ``device``, and history."""
    if cfg.devices > 1:
        if cfg.ppo.num_envs % cfg.devices:
            raise ValueError(f"num_envs ({cfg.ppo.num_envs}) does not split "
                             f"over devices={cfg.devices}")
        if dist.is_available() and dist.is_initialized():
            if dist.get_world_size() != cfg.devices:
                raise ValueError(f"devices={cfg.devices} in a process group "
                                 f"of {dist.get_world_size()} ranks")
            dev = (torch.device(device) if device is not None else
                   resolve_device(f"cuda:{os.environ.get('LOCAL_RANK', 0)}"))
            return _train(env_id, cfg, log_fn, dev,
                          M.make_mesh(cfg.devices, model_parallel=1))
        return _train_spawned(env_id, cfg, log_fn, device, backend)
    return _train(env_id, cfg, log_fn, resolve_device(device))


def _make_env(env_id, cfg: TrainConfig, dev):
    env = minigrid_tpu_torch.make(env_id, device=dev)
    return env.packed() if cfg.packed_obs else env


def _train(env_id, cfg: TrainConfig, log_fn, dev, mesh=None):
    env = _make_env(env_id, cfg, dev)
    pcfg = cfg.ppo
    # every draw comes from g, seeded alike on every rank, as one process
    # draws it (each rank keeps its rows of the global batch)
    g = env.generator(cfg.seed)
    cls, init = ((ActorCriticRNN, init_params_rnn) if cfg.recurrent
                 else (ActorCritic, init_params))
    model = init(cls(view_size=env.params.view_size, hidden=cfg.hidden,
                     device=dev), g)
    if mesh is not None:
        M.shard_params(mesh, model)
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
    if mesh is not None:
        kw["mesh"] = mesh
    train_step = (make_train_loop(env, model, pcfg, optimizer,
                                  steps_per_call=K, **kw) if K > 1 else
                  make_train_step(env, model, pcfg, optimizer, **kw))

    obs, st = env.reset_staggered(g, pcfg.num_envs)
    num_envs = pcfg.num_envs
    if mesh is not None:
        obs, st = M.shard_batch(mesh, (obs, st))
        num_envs //= mesh.data_size
    h = model.initial_state(num_envs) if cfg.recurrent else None
    lead = mesh is None or mesh.rank == 0
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
            if log_fn is not None and lead:
                log_fn(metrics)
        if cfg.checkpoint_dir and lead and (u + 1) % cfg.checkpoint_every == 0:
            save_pytree(f"{cfg.checkpoint_dir}/step_{u + 1}",
                        {"model": model.state_dict(),
                         "optimizer": optimizer.state_dict()})
    return model, history


def _train_rank(env_id, cfg: TrainConfig, out_dir):
    """One spawned rank of :func:`train`: rank 0 writes its model's state
    dict to ``out_dir`` and returns its history."""
    model, history = _train(env_id, cfg, M.report, M.joined_device(),
                            M.make_mesh(cfg.devices, model_parallel=1))
    if dist.get_rank() != 0:
        return None
    torch.save({k: v.cpu() for k, v in model.state_dict().items()},
               os.path.join(out_dir, "model.pt"))
    return history


def _train_spawned(env_id, cfg: TrainConfig, log_fn, device, backend):
    dev = resolve_device(device)
    if dev.type == "cuda":  # once, before the ranks could race to build them
        from minigrid_tpu_torch.ops import native

        for source in sorted(native.CSRC.glob("*.cu")):
            native.build((source,))
    with tempfile.TemporaryDirectory() as out_dir:
        history = M.spawn(_train_rank, cfg.devices, backend, device,
                          args=(env_id, cfg, out_dir),
                          on_message=log_fn)[0]
        state = torch.load(os.path.join(out_dir, "model.pt"),
                           map_location=dev)
    cls = ActorCriticRNN if cfg.recurrent else ActorCritic
    view_size = _make_env(env_id, cfg, dev).params.view_size
    model = cls(view_size=view_size, hidden=cfg.hidden, device=dev)
    model.load_state_dict(state)
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
