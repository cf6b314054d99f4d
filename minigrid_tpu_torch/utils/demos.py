"""Expert demonstrations from the BabyAI bot.

Counterpart of ``minigrid_tpu/utils/demos.py``: episodes driven by
:class:`~minigrid_tpu_torch.utils.baby_ai_bot.BabyAIBot` (it plans from what
the agent has seen) and returned as padded numpy arrays for behavioural
cloning. Seed ``i``'s layout comes from ``env.generator(i)`` alone, so
``DemoBatch.seed`` regenerates its episode. The env steps on its device
(on the card: the hook path, the fused kernel's step entry and its observe
entry); several seeds' episodes may run as one batch, one host copy of the
batch's state a step, with the same result as one seed at a time.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from minigrid_tpu_torch.core.obs import packed_to_image
from minigrid_tpu_torch.utils.baby_ai_bot import BabyAIBot, host_state

# seeds whose episodes run as one batch in generate_demos
DEMO_BATCH = 64


class DemoBatch(NamedTuple):
    """Padded demonstration set. N episodes, T = longest episode."""

    image: np.ndarray      # (N, T, V, V, 3) uint8
    direction: np.ndarray  # (N, T) int32
    mission: np.ndarray    # (N, L) int32 token ids (constant per episode)
    action: np.ndarray     # (N, T) int32
    mask: np.ndarray       # (N, T) bool: valid timesteps
    length: np.ndarray     # (N,) int32
    seed: np.ndarray       # (N,) int32: the solved layouts' seeds


def reset_seeds(env, seeds):
    """(obs, state): one batch of the layouts of ``seeds``, seed ``i``'s
    from ``env.generator(i)`` alone."""
    resets = [env.reset(env.generator(int(s)), 1) for s in seeds]
    obs = {k: torch.cat([o[k] for o, _ in resets]) for k in resets[0][0]}
    tensors = [st.tensors() for _, st in resets]
    state = resets[0][1].with_tensors({
        k: torch.cat([t[k] for t in tensors]) for k in tensors[0]})
    return obs, state


def bot_episodes(env, obs, state, max_steps: int = 240, trace=None):
    """The bot's episodes from the batch (``obs``, ``state``), one bot an
    env, stepped together: step ``t`` takes the key ``(0, t)`` in every
    env, JAX's ``PRNGKey(t)``, and envs whose episode ended step on with
    action 0, unrecorded. An episode ends at termination (solved when its
    reward is positive), truncation or ``max_steps``. With a list
    ``trace``, each step appends (the actions, the state after the step).
    Returns one ``(images, directions, actions, mission, solved)`` per env,
    numpy."""
    K = state.batch_size
    dev = state.device
    bots = [BabyAIBot(env) for _ in range(K)]
    running = np.ones(K, bool)
    solved = np.zeros(K, bool)
    images, dirs, actions = ([[] for _ in range(K)] for _ in range(3))
    mission = state.mission.cpu().numpy()
    keys = torch.zeros((K, 2), dtype=torch.int32, device=dev)
    for t in range(max_steps):
        host = host_state(state)
        act = np.array([bots[b].replan(host, b) if running[b] else 0
                        for b in range(K)], np.int32)
        img = (obs["image"] if "image" in obs
               else packed_to_image(obs["packed"])).cpu().numpy()
        direction = obs["direction"].cpu().numpy()
        for b in np.flatnonzero(running):
            images[b].append(img[b])
            dirs[b].append(int(direction[b]))
            actions[b].append(int(act[b]))
        keys[:, 1] = t
        obs, state, reward, term, trunc, _ = env.step(
            keys, state, torch.from_numpy(act).to(dev))
        if trace is not None:
            trace.append((act, state))
        term, trunc = term.cpu().numpy(), trunc.cpu().numpy()
        reward = reward.cpu().numpy()
        solved |= running & term & (reward > 0)
        running &= ~(term | trunc)
        if not running.any():
            break
    return [(images[b], dirs[b], actions[b], mission[b], bool(solved[b]))
            for b in range(K)]


def run_bot_episodes(env, seeds, max_steps: int = 240):
    """:func:`bot_episodes` from the layouts of ``seeds``
    (:func:`reset_seeds`)."""
    return bot_episodes(env, *reset_seeds(env, seeds), max_steps)


def generate_demos(env, num_episodes: int, start_seed: int = 0,
                   max_steps: int = 240, max_seed_tries: int = 50
                   ) -> DemoBatch:
    """Collect ``num_episodes`` solved bot episodes.

    Seeds count up from ``start_seed``; an unsolved seed is skipped, and
    :class:`RuntimeError` is raised when ``max_seed_tries + num_episodes``
    seeds run out first (JAX's contract). Up to :data:`DEMO_BATCH` seeds'
    episodes run as one batch (:func:`run_bot_episodes`), with the result
    of the one-seed-at-a-time loop."""
    episodes = []
    seed, tries = start_seed, 0
    budget = max_seed_tries + num_episodes
    while len(episodes) < num_episodes:
        if tries >= budget:
            raise RuntimeError(
                f"exhausted {tries} seeds for {len(episodes)}/{num_episodes}"
                " demos")
        # no more seeds a batch than twice the demos still missing: each
        # seed costs a reset of its own
        k = min(DEMO_BATCH, budget - tries, 2 * (num_episodes - len(episodes)))
        seeds = list(range(seed, seed + k))
        for s, (images, dirs, actions, mission, solved) in zip(
                seeds, run_bot_episodes(env, seeds, max_steps)):
            if len(episodes) == num_episodes:
                break
            tries += 1
            if solved:
                episodes.append((images, dirs, actions, mission, s))
        seed += k

    T = max(len(e[0]) for e in episodes)
    N = num_episodes
    V = env.params.view_size
    out = DemoBatch(
        image=np.zeros((N, T, V, V, 3), np.uint8),
        direction=np.zeros((N, T), np.int32),
        mission=np.stack([e[3] for e in episodes]).astype(np.int32),
        action=np.zeros((N, T), np.int32),
        mask=np.zeros((N, T), bool),
        length=np.asarray([len(e[0]) for e in episodes], np.int32),
        seed=np.asarray([e[4] for e in episodes], np.int32),
    )
    for i, (images, dirs, actions, _, _) in enumerate(episodes):
        L = len(images)
        out.image[i, :L] = np.stack(images)
        out.direction[i, :L] = dirs
        out.action[i, :L] = actions
        out.mask[i, :L] = True
    return out
