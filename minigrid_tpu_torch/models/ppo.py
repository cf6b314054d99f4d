"""The PPO rollout over batched envs with pooled auto-reset.

Counterpart of the rollout in ``minigrid_tpu/models/ppo.py``
(``make_train_step``'s ``rollout``, pooled mode, MLP policy): each step
encodes the observation once (stored in the trajectory and fed to the
policy), samples the action by Gumbel-argmax with presampled noise, and steps
every env with this step's presampled broadcast reset row. The mission is
carried as vocabulary counts, refreshed from the reset row in finished envs.
On the card every env step is one launch of the fused CUDA kernel.

The update phase (GAE, loss, optimizer) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from minigrid_tpu_torch.envs.base import (LayoutPool, presample_reset_states,
                                          random_keys)
from minigrid_tpu_torch.models.actor_critic import (encode_obs,
                                                    mission_counts)


class Transition(NamedTuple):
    obs: Any
    action: torch.Tensor
    log_prob: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor


def _selected_log_prob(log_probs, action):
    """log_probs[..., action]."""
    return torch.gather(log_probs, -1,
                        action[..., None].to(torch.int64)).squeeze(-1)


@dataclasses.dataclass(frozen=True)
class RolloutNoise:
    """All per-step randomness of a rollout of T steps over B envs."""

    step_keys: torch.Tensor   # (T, B, 2) int32 env step keys
    gumbel: torch.Tensor      # (T, B, A) float32 action noise
    reset_rows: LayoutPool    # T broadcast reset rows


def sample_rollout_noise(generator: torch.Generator, pool: LayoutPool,
                         num_envs: int, length: int,
                         num_actions: int) -> RolloutNoise:
    """Draw a rollout's keys, Gumbel noise and reset rows up front."""
    dev = pool.grid.device
    keys = random_keys(generator, (length, num_envs, 2), dev)
    u = torch.rand((length, num_envs, num_actions), generator=generator,
                   device=dev)
    u = u.clamp(min=torch.finfo(torch.float32).tiny)
    gumbel = -torch.log(-torch.log(u))
    return RolloutNoise(keys, gumbel,
                        presample_reset_states(generator, pool, length))


@torch.no_grad()
def rollout(model, env, env_state, obs: dict, noise: RolloutNoise):
    """T = noise.gumbel.shape[0] policy steps of every env.

    Returns ``(env_state, obs, traj)`` where ``traj`` is a
    :class:`Transition` of (T, B, ...) tensors; ``traj.obs`` holds the
    encoded observations the policy saw."""
    T = noise.gumbel.shape[0]
    view_key = "packed" if "packed" in obs else "image"
    counts = mission_counts(obs["mission"])
    reset_counts = mission_counts(noise.reset_rows.mission)       # (T, VOCAB)
    steps = []
    for t in range(T):
        enc = encode_obs({view_key: obs[view_key], "mission_counts": counts,
                          "direction": obs["direction"]})
        logits, value = model(enc)
        action = torch.argmax(logits + noise.gumbel[t], dim=-1)
        log_prob = _selected_log_prob(torch.log_softmax(logits, -1), action)
        obs, env_state, reward, term, trunc, _ = \
            env.step_autoreset_presampled(noise.step_keys[t], env_state,
                                          action, noise.reset_rows.rows(t))
        done = term | trunc
        counts = torch.where(done[:, None], reset_counts[t][None], counts)
        steps.append(Transition(enc, action.to(torch.int32), log_prob, value,
                                reward, done))
    traj = Transition(
        {k: torch.stack([s.obs[k] for s in steps]) for k in steps[0].obs},
        *(torch.stack(f) for f in list(zip(*steps))[1:]))
    return env_state, obs, traj
