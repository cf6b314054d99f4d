"""Device-resident rollout driver, sharded over the data ranks.

Counterpart of ``minigrid_tpu/parallel/rollout.py``: batched envs live on
the device and every step runs through the fused kernel; under a mesh each
rank steps its block of the batch, and its chunk is its rows of the
one-process rollout in every reset mode. Only the fresh reset
communicates: one all-reduce of the ranks' finisher counts a step, which
routes the one global buffer as JAX's batch-wide cumsum does under GSPMD.
The rollout is ``models/ppo.py::rollout`` with the policy's logits (or
none: uniform actions) and the observations kept as they come.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from minigrid_tpu_torch.core.actions import NUM_ACTIONS
from minigrid_tpu_torch.models import ppo as P
from minigrid_tpu_torch.wrappers import Wrapper


class RolloutChunk(NamedTuple):
    obs: Any
    action: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor


class _Actor:
    """``models/ppo.py::rollout``'s model: the logits of ``policy(model,
    obs)`` on the raw observations, or zeros (Gumbel-argmax of zeros is
    uniform over the actions); no value."""

    takes_raw_obs = True
    is_recurrent = False
    num_actions = NUM_ACTIONS

    def __init__(self, policy, model):
        self.policy, self.model = policy, model

    def __call__(self, obs):
        batch = (obs["direction"] if isinstance(obs, dict) else obs).shape[0]
        dev = (obs["direction"] if isinstance(obs, dict) else obs).device
        zeros = torch.zeros((batch,), device=dev)
        if self.policy is None:
            return zeros[:, None].expand(batch, NUM_ACTIONS), zeros
        return self.policy(self.model, obs), zeros


def make_rollout(env, policy: Callable | None = None, length: int = 128,
                 pooled: bool = False, resets: str | None = None,
                 fresh_buffer: int | None = None, mesh=None):
    """Build ``rollout(model, env_state, obs, generator, pool=None) ->
    (env_state, obs, RolloutChunk)``: ``length`` steps of every env, the
    actions drawn from ``policy(model, obs) -> logits`` (Gumbel-argmax),
    uniformly over the 7 actions when ``policy`` is None. Reset modes as in ``models/ppo.py::make_train_step``:
    ``"regen"`` (default), ``"pooled"`` (a ``LayoutPool`` as ``pool``) or
    ``"fresh"`` (a buffer of fresh layouts a rollout; ``fresh_buffer``
    sizes it, required for dynamic-budget envs, else it is sized from the
    global batch). The chunk holds the observations each step started from,
    the actions, rewards and dones, (T, B, ...).

    With a ``mesh`` the call is one data rank's: ``env_state`` and ``obs``
    hold its block of the global batch, and ``generator`` (seeded alike on
    every rank) draws what one process draws: the global batch's keys and
    noise, its regen layouts (the rank keeps its rows of each) and the
    whole fresh buffer, so the chunk is exactly the rank's rows of the
    one-process rollout (``models/ppo.py::rollout``)."""
    if resets is None:
        resets = "pooled" if pooled else "regen"
    if resets not in P.RESET_MODES:
        raise ValueError(f"resets must be one of {P.RESET_MODES}, got "
                         f"{resets!r}")
    if resets in ("pooled", "fresh") and isinstance(env, Wrapper):
        env.check_fast_paths()
    if resets == "fresh" and fresh_buffer is None:
        ms = int(env.params.max_steps)
        if ms > 1 << 16:
            raise ValueError("resets='fresh' on a dynamic-budget env: pass "
                             "fresh_buffer")
    ranks = 1 if mesh is None else mesh.data_size

    def rollout(model, env_state, obs, generator: torch.Generator,
                pool=None):
        num_envs = env_state.batch_size * ranks
        cfg = P.PPOConfig(num_envs=num_envs, rollout_len=length)
        noise = P.sample_rollout_noise(
            generator, pool if resets == "pooled" else None, num_envs,
            length, NUM_ACTIONS, device=env_state.device)
        if mesh is not None:
            noise = noise.shard(mesh.batch_slice(num_envs))
        n_buf, window = (P.fresh_sizes(env, cfg, fresh_buffer)
                         if resets == "fresh" else (None, 32))
        env_state, obs, traj, _ = P.rollout(
            _Actor(policy, model), env, env_state, obs, noise, resets,
            generator, n_buf, window, mesh=mesh)
        return env_state, obs, RolloutChunk(traj.obs, traj.action,
                                            traj.reward, traj.done)

    return rollout
