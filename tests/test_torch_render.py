"""The port's rendering (minigrid_tpu_torch/render) against the JAX
package's on exported JAX states, bit for bit:

- the tile atlas at tile sizes 8 and 32;
- full frames with the view cone highlighted and without, and POV frames,
  on states after interaction steps (keys carried, doors opened), on a
  see-through family, a 16x8 grid and a 16x16 one, at tile 8 and 32;
- ``core/obs.py::gen_obs_grid`` against JAX's;
- the claim the renderer relies on: a visible cell of the 9-bit
  observation is never unseen (type 0), so the observe entry's packed
  view is the visibility mask, on states of eleven families."""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from minigrid_tpu.core.obs import gen_obs_grid as j_gen_obs_grid
from minigrid_tpu.render import compose_frame as j_compose_frame
from minigrid_tpu.render import get_atlas as j_get_atlas
from minigrid_tpu.render import get_frame as j_get_frame

import minigrid_tpu_torch
from minigrid_tpu_torch.core.obs import gen_obs_grid
from minigrid_tpu_torch.envs.base import random_keys
from minigrid_tpu_torch.ops.fused_step import fused_observe
from minigrid_tpu_torch.render import compose_frame, get_atlas, get_frame

from tests.torch_port_utils import (share_cpu,  # noqa: F401
                                    action_stream, export, jax_states)

pytestmark = pytest.mark.usefixtures("share_cpu")

NB = 16
ENVS = ["MiniGrid-DoorKey-8x8-v0", "MiniGrid-Fetch-8x8-N3-v0",
        "MiniGrid-RedBlueDoors-8x8-v0", "MiniGrid-DoorKey-16x16-v0"]
VARIANTS = {"full": {}, "no highlight": {"highlight": False},
            "pov": {"agent_pov": True}}
_CACHE: dict = {}


def stepped(env_id):
    """(JAX env, JAX states after 12 interaction steps with every third
    agent given a yellow key to carry, the port's copy), shared."""
    if env_id not in _CACHE:
        jenv, st = jax_states(env_id, NB, seed=3, packed=False)
        step = jax.jit(jax.vmap(jenv.step))
        acts = action_stream("interact", 12, NB, seed=4)
        for t in range(12):
            keys = jax.random.split(jax.random.PRNGKey(t), NB)
            st = step(keys, st, jnp.asarray(acts[t]))[1]
        key = jnp.asarray([5, 4, 0, 0, 0], jnp.uint8)
        carry = (jnp.arange(NB) % 3 == 0)[:, None]
        st = st.replace(carrying=jnp.where(carry, key, st.carrying))
        _CACHE[env_id] = jenv, st, export(st)
    return _CACHE[env_id]


@pytest.mark.parametrize("tile", [8, 32])
def test_atlas_matches_jax(tile):
    got = get_atlas(tile)
    want = j_get_atlas(tile)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("env_id", ENVS)
def test_frames_match_jax(env_id, variant):
    jenv, jst, pst = stepped(env_id)
    kw = VARIANTS[variant]
    want = jax.jit(jax.vmap(lambda s: j_get_frame(
        jenv.params, s, tile_size=8, **kw)))(jst)
    got = get_frame(jenv.params, pst, tile_size=8, **kw)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_frames_at_tile_32_match_jax():
    jenv, jst, pst = stepped(ENVS[0])
    for kw in VARIANTS.values():
        want = jax.jit(jax.vmap(lambda s: j_get_frame(
            jenv.params, s, tile_size=32, **kw)))(jst)
        got = get_frame(jenv.params, pst, tile_size=32, **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_compose_frame_without_agent_matches_jax():
    """An agent position of (-1, -1) renders no agent (the reference's
    agent_dir=None, grid.py:229-234)."""
    jenv, jst, pst = stepped(ENVS[2])
    none = jnp.asarray([-1, -1])
    hl = np.random.default_rng(5).random((NB, 16, 8)) < 0.5
    want = jax.vmap(lambda c, h: j_compose_frame(c, none, 0, h, 8))(
        jst.grid[..., :3], jnp.asarray(hl))
    got = compose_frame(pst.grid[..., :3], torch.tensor([[-1, -1]]),
                        torch.tensor([0]), torch.from_numpy(hl), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("env_id", ENVS)
def test_gen_obs_grid_matches_jax(env_id):
    jenv, jst, pst = stepped(env_id)
    want_cells, want_vis = jax.jit(jax.vmap(
        lambda s: j_gen_obs_grid(jenv.params, s)))(jst)
    cells, vis = gen_obs_grid(jenv.params, pst)
    np.testing.assert_array_equal(cells.numpy(), np.asarray(want_cells))
    np.testing.assert_array_equal(vis.numpy(), np.asarray(want_vis))


@pytest.mark.parametrize("env_id", [
    "MiniGrid-FourRooms-v0", "MiniGrid-MultiRoom-N6-v0",
    "MiniGrid-LavaCrossingS9N2-v0", "MiniGrid-LockedRoom-v0",
    "MiniGrid-Playground-v0", "MiniGrid-MemoryS13Random-v0",
    "MiniGrid-Dynamic-Obstacles-8x8-v0", "MiniGrid-KeyCorridorS3R3-v0",
    "MiniGrid-ObstructedMaze-1Dlhb-v0", "BabyAI-GoToObj-v0",
    "MiniGrid-DistShift1-v0"])
def test_visible_cells_are_never_unseen(env_id):
    """On every family's states, before and after interaction steps, the
    observation's visible cells are exactly its cells of type != 0."""
    env = minigrid_tpu_torch.make(env_id, device="cpu").packed()
    g = env.generator(0)
    _, st = env.reset(g, NB)
    choice = torch.tensor([0, 1, 2, 2, 3, 4, 5, 5])
    for t in range(9):
        _, vis = gen_obs_grid(env.params, st)
        packed = fused_observe(env.params, st)
        assert torch.equal(vis, (packed & 15) != 0), (env_id, t)
        a = choice[torch.randint(0, 8, (NB,), generator=g)]
        st = env.step(random_keys(g, (NB, 2), "cpu"), st, a)[1]
