"""Policy evaluation: the measured episode success rate.

Counterpart of ``minigrid_tpu/models/eval.py``. N fresh episodes run to
completion under the greedy (argmax) policy, batched; an episode succeeds
when it terminates with a positive reward (timeouts and lava deaths fail).
Finished episodes freeze, so each is counted once. A recurrent policy
(``model.is_recurrent``) carries its hidden state from
``model.initial_state(n)`` through every step.

    from minigrid_tpu_torch.models.eval import evaluate_success
    rate = evaluate_success(env, model, n_episodes=1024)
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.envs.base import random_keys


def evaluate_success(env, model, n_episodes: int = 1024,
                     generator: torch.Generator | None = None,
                     max_steps: int | None = None,
                     require_all_done: bool = True) -> float:
    """Fraction of ``n_episodes`` fresh episodes (``env.reset`` from
    ``generator``, seed 0 by default) that the greedy policy solves within
    ``max_steps`` (the env's budget by default; on a dynamic-budget level,
    whose ``params.max_steps`` is a sentinel, the largest budget of the
    batch). With ``require_all_done``
    it raises when an episode is still running at the end of the budget,
    which would otherwise count as a failure."""
    if generator is None:
        generator = env.generator(0)
    obs, state = env.reset(generator, n_episodes)
    return evaluate_success_from(env, model, obs, state, max_steps,
                                 require_all_done, generator)


def episode_budget(env, state, max_steps: int | None = None) -> int:
    """The steps an evaluation of ``state`` runs: ``max_steps``, else the
    env's budget; above 2^16 (the 2^30 sentinel of a dynamic-budget level,
    e.g. BabyAI, which keeps each episode's budget in
    ``extra["max_steps"]``), the batch's largest budget."""
    T = max_steps or int(env.params.max_steps)
    if T > 1 << 16:
        T = int(state.extra["max_steps"].max())
    return T


@torch.no_grad()
def evaluate_success_from(env, model, obs: dict, state,
                          max_steps: int | None = None,
                          require_all_done: bool = True,
                          generator: torch.Generator | None = None) -> float:
    """:func:`evaluate_success` on a given reset batch (``obs``, ``state``),
    e.g. states exported from the JAX package. The step keys, which only
    an env with in-step randomness reads (Dynamic-Obstacles), are drawn
    from ``generator`` every step, or zero without one."""
    T = episode_budget(env, state, max_steps)
    B = state.batch_size
    dev = state.device
    recurrent = getattr(model, "is_recurrent", False)
    h = model.initial_state(B) if recurrent else None
    keys = torch.zeros((B, 2), dtype=torch.int32, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    success = torch.zeros((B,), dtype=torch.bool, device=dev)

    def frozen(x):
        return done.reshape((-1,) + (1,) * (x.ndim - 1))

    for _ in range(T):
        if recurrent:
            (logits, _), h = model(obs, h)
        else:
            logits, _ = model(obs)
        action = torch.argmax(logits, dim=-1)
        if generator is not None:
            keys = random_keys(generator, (B, 2), dev)
        obs2, st2, r, te, tr, _ = env.step(keys, state, action)
        success = success | (~done & te & (r > 0))
        new = st2.tensors()
        state = state.with_tensors({
            k: torch.where(frozen(v), v, new[k])
            for k, v in state.tensors().items()})
        obs = {k: torch.where(frozen(v), v, obs2[k]) for k, v in obs.items()}
        done = done | te | tr
    done_rate = float(done.float().mean())
    if require_all_done and done_rate < 1.0:
        raise ValueError(
            f"{(1 - done_rate) * 100:.1f}% of episodes still running after "
            f"the {T}-step budget; raise max_steps (they would otherwise "
            "count as failures; pass require_all_done=False to accept the "
            "conservative bound)")
    return float(success.float().mean())
