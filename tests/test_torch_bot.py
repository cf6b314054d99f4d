"""The port's BabyAI bot (minigrid_tpu_torch/utils/baby_ai_bot.py) against
the JAX package's: ``world_vis_mask`` on exported states; the two bots in
lockstep from the same exported JAX layouts (JAX steps with the JAX bot's
action, the port steps on the CPU with the port bot's), the action and
every state tensor equal, ``extra`` included, each step until the episode
ends; and the port bot solving the port's own layouts of the same levels
within the reference's 240-step budget in 8 seeds (JAX tests/test_bot.py's
contract)."""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import minigrid_tpu
from minigrid_tpu.utils.baby_ai_bot import BabyAIBot as JBot
from minigrid_tpu.utils.baby_ai_bot import world_vis_mask as j_world_vis_mask

import minigrid_tpu_torch
from minigrid_tpu_torch.utils.baby_ai_bot import BabyAIBot, world_vis_mask
from minigrid_tpu_torch.utils.demos import run_bot_episodes

from tests.torch_port_utils import (share_cpu,  # noqa: F401
                                    ALL_FIELDS, CPU, action_stream,
                                    assert_state_equal, export)

LEVELS = ["BabyAI-GoToRedBallGrey-v0", "BabyAI-PutNextLocal-v0",
          "BabyAI-UnlockLocal-v0", "BabyAI-KeyCorridorS3R3-v0",
          "BabyAI-MoveTwoAcrossS8N9-v0"]
SEEDS = 2
STEP_BUDGET = 240  # the reference's (tests/test_bot.py)
MAX_SEED_TRIES = 8

pytestmark = pytest.mark.usefixtures("share_cpu")


def test_world_vis_mask_matches_jax():
    """The view cone in world cells on 32 DoorKey-16x16 states (doors
    opened and closed by the interaction stream), at views 7 and 9: JAX's
    function on JAX's arrays, the port's on the exported state's."""
    env = minigrid_tpu.make("MiniGrid-DoorKey-16x16-v0")
    _, st = jax.jit(jax.vmap(env.reset))(
        jax.random.split(jax.random.PRNGKey(0), 32))
    step = jax.jit(jax.vmap(env.step))
    keys = jax.random.split(jax.random.PRNGKey(1), 32)
    for a in action_stream("interact", 12, 32):
        _, st, *_ = step(keys, st, jnp.asarray(a))
    g = np.asarray(st.grid)
    pst = export(st)
    pg = pst.grid.numpy()
    n_hidden = 0
    for b in range(32):
        for view in (7, 9):
            want = j_world_vis_mask(g[b, ..., 0].astype(int),
                                    g[b, ..., 2].astype(int),
                                    np.asarray(st.agent_pos[b]),
                                    int(st.agent_dir[b]), view)
            got = world_vis_mask(pg[b, ..., 0].astype(int),
                                 pg[b, ..., 2].astype(int),
                                 pst.agent_pos[b].numpy(),
                                 int(pst.agent_dir[b]), view)
            np.testing.assert_array_equal(got, want, err_msg=f"{b} {view}")
            n_hidden += int(want.sum() < view * view)
    assert n_hidden > 0


@pytest.mark.parametrize("level", LEVELS)
def test_bot_lockstep_matches_jax(level):
    """From JAX's layouts of two seeds: each step the two bots' actions are
    equal, and after JAX steps with its action and the port with its own,
    every state tensor is equal, until the episode ends."""
    jenv = minigrid_tpu.make(level)
    penv = minigrid_tpu_torch.make(level, device=CPU)
    _, jst = jax.jit(jax.vmap(jenv.reset))(
        jax.random.split(jax.random.PRNGKey(0), SEEDS))
    step = jax.jit(jax.vmap(jenv.step))
    solved = 0
    for b in range(SEEDS):
        js = jax.tree.map(lambda x: x[b:b + 1], jst)
        ps = export(js)
        jbot, pbot = JBot(jenv), BabyAIBot(penv)
        for t in range(STEP_BUDGET):
            msg = f"{level} seed {b} step {t}"
            # the JAX bot reads the state through numpy: hand it host
            # arrays (no eager JAX op a step)
            ja = jbot.replan(jax.tree.map(lambda x: np.asarray(x)[0], js))
            pa = pbot.replan(ps)
            assert pa == ja, msg
            k = jax.random.PRNGKey(t)[None]
            _, js, r, te, tr, _ = step(k, js, jnp.asarray([ja]))
            _, ps, pr, pte, ptr, _ = penv.step(
                torch.from_numpy(np.array(k).view(np.int32)), ps,
                torch.tensor([pa]))
            assert_state_equal(ps, js, ALL_FIELDS, msg=msg)
            np.testing.assert_array_equal(pr.numpy(), np.asarray(r))
            if bool(te[0]) or bool(tr[0]):
                solved += bool(te[0]) and float(r[0]) > 0
                break
        np.testing.assert_array_equal(pbot.seen, jbot.seen)
    assert solved >= 1


@pytest.mark.parametrize("level", LEVELS)
def test_bot_solves_port_layouts(level):
    """The port's own layouts (seed i from ``env.generator(i)``), the 8
    seeds as one batch: the bot solves at least one within 240 steps."""
    env = minigrid_tpu_torch.make(level, device=CPU)
    episodes = run_bot_episodes(env, range(MAX_SEED_TRIES), STEP_BUDGET)
    assert any(e[4] for e in episodes), level
