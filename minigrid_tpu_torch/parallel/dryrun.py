"""The multi-rank dry run: one full PPO train step of each flagship
variant over a mesh of ranks, at tiny shapes.

Counterpart of ``__graft_entry__.py::dryrun_multichip``: pooled resets with
the MLP (the throughput path; the layout pool replicated, the batch split
over ``data``), fresh resets with the MLP (the buffer generated by each
rank for its envs), and fresh resets with the recurrent policy (the hidden
state split over ``data``), on a mesh that exercises the ``model`` axis
too (``model_parallel=2`` from 4 ranks, as JAX picks it).

    from minigrid_tpu_torch.parallel.dryrun import dryrun_multichip
    dryrun_multichip(2, device="cpu")            # spawns 2 gloo ranks
    dryrun_multichip(4, backend="gloo")          # 4 ranks on the card(s)
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from minigrid_tpu_torch.parallel import mesh as M


def dryrun_multichip(n_devices: int, model_parallel: int | None = None,
                     backend: str | None = None, device=None) -> list:
    """Run the three train steps on ``n_devices`` ranks. Inside an
    initialised process group of that size this process is one rank (on
    ``device``, the current card by default); otherwise the ranks are
    spawned (``parallel.mesh.spawn``; ``backend`` and ``device`` as
    there). Returns each rank's metrics of the three steps (floats) and
    prints rank 0's."""
    if model_parallel is None:
        model_parallel = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    if dist.is_initialized():
        dev = (torch.device(device) if device is not None
               else torch.device("cuda", torch.cuda.current_device()))
        return [_dryrun(n_devices, model_parallel, dev)]
    return M.spawn(_dryrun_rank, n_devices, backend, device,
                   args=(n_devices, model_parallel))


def _dryrun_rank(n, model_parallel):
    return _dryrun(n, model_parallel, M.joined_device())


def _dryrun(n, model_parallel, dev) -> dict:
    import minigrid_tpu_torch
    from minigrid_tpu_torch.models.actor_critic import (ActorCritic,
                                                        ActorCriticRNN,
                                                        init_params,
                                                        init_params_rnn)
    from minigrid_tpu_torch.models.ppo import (PPOConfig, make_optimizer,
                                               make_train_step)

    mesh = M.make_mesh(n, model_parallel=model_parallel)
    env = minigrid_tpu_torch.make("MiniGrid-DoorKey-5x5-v0",
                                  device=dev).packed()
    cfg = PPOConfig(num_envs=8 * n, rollout_len=4, num_epochs=1,
                    num_minibatches=2)
    g = env.generator(0)                          # alike on every rank
    local = env.generator(M.rank_seed(0, mesh))   # this data rank's layouts
    out = {}

    def mlp():
        model = M.shard_params(mesh, init_params(
            ActorCritic(view_size=env.params.view_size, hidden=128,
                        device=dev), env.generator(0)))
        return model, make_optimizer(model, cfg)

    # 1. pooled resets + MLP
    model, opt = mlp()
    pool = env.make_pool(g, 16)
    obs, st = M.shard_batch(mesh, env.reset_staggered(g, cfg.num_envs))
    step = make_train_step(env, model, cfg, opt, resets="pooled", mesh=mesh)
    st, obs, m = step(st, obs, g, pool, local)
    out["pooled+MLP"] = {k: float(v) for k, v in m.items()}

    # 2. fresh resets + MLP (each rank's buffer, its share of 16 rows)
    model, opt = mlp()
    step = make_train_step(env, model, cfg, opt, resets="fresh",
                           fresh_buffer=16, mesh=mesh)
    st, obs, m = step(st, obs, g, None, local)
    out["fresh+MLP"] = {k: float(v) for k, v in m.items()}

    # 3. fresh resets + the recurrent policy, its hidden state split
    rmodel = M.shard_params(mesh, init_params_rnn(
        ActorCriticRNN(view_size=env.params.view_size, hidden=128,
                       device=dev), env.generator(0)))
    h = rmodel.initial_state(cfg.num_envs // mesh.data_size)
    step = make_train_step(env, rmodel, cfg, make_optimizer(rmodel, cfg),
                           resets="fresh", fresh_buffer=16, mesh=mesh)
    st, obs, h, m = step(st, obs, h, g, None, local)
    out["fresh+RNN"] = {k: float(v) for k, v in m.items()}
    if mesh.rank == 0:
        for name, metrics in out.items():
            print(f"dryrun_multichip({n}, mesh {mesh.shape}) {name} OK - "
                  f"metrics: {metrics}")
    return out
