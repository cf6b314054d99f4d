"""The port's core modules (minigrid_tpu_torch/core) against the JAX
package on the same inputs: constants, cell packing, mission tokens, the
batched transition, the observation and visibility — all bit-exact, the
reward within rtol 1e-6."""

from __future__ import annotations

import functools
import dataclasses
import itertools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from minigrid_tpu.core import constants as JC
from minigrid_tpu.core import grid as JG
from minigrid_tpu.core import mission as JM
from minigrid_tpu.core.actions import Actions as JActions
from minigrid_tpu.core.obs import gen_obs as j_gen_obs
from minigrid_tpu.core.step import step_core as j_step_core
from minigrid_tpu.core.types import MISSION_LEN as J_MISSION_LEN
from minigrid_tpu.core.visibility import process_vis as j_process_vis

from minigrid_tpu_torch.core import constants as PC
from minigrid_tpu_torch.core import grid as PG
from minigrid_tpu_torch.core import mission as PM
from minigrid_tpu_torch.core.actions import Actions as PActions
from minigrid_tpu_torch.core.obs import gen_obs as p_gen_obs
from minigrid_tpu_torch.core.step import step_core as p_step_core
from minigrid_tpu_torch.core.types import MISSION_LEN as P_MISSION_LEN
from minigrid_tpu_torch.core.visibility import process_vis as p_process_vis

from tests.torch_port_utils import share_cpu  # noqa: F401
from tests.torch_port_utils import (action_stream, assert_state_equal,
                                    export, jax_states)

pytestmark = pytest.mark.usefixtures("share_cpu")


def test_constants_equal():
    names = [n for n in dir(JC) if n.isupper()]
    assert names == [n for n in dir(PC) if n.isupper()]
    for n in names:
        a, b = getattr(JC, n), getattr(PC, n)
        if isinstance(a, dict):
            assert a.keys() == b.keys(), n
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=n)
        else:
            np.testing.assert_array_equal(a, b, err_msg=n)
    assert {a.name: int(a) for a in JActions} == \
        {a.name: int(a) for a in PActions}
    assert (PG.WALL_PACKED, PG.EMPTY_PACKED) == \
        (JG.WALL_PACKED, JG.EMPTY_PACKED)
    assert P_MISSION_LEN == J_MISSION_LEN


@functools.lru_cache(maxsize=None)
def _jax_step_core(params):
    """JAX's ``vmap(step_core)``, jitted once per env params."""
    return jax.jit(jax.vmap(lambda s, a: j_step_core(params, s, a)))


@pytest.mark.parametrize("env_id", ["MiniGrid-DoorKey-8x8-v0",
                                    "MiniGrid-DoorKey-5x5-v0"])
def test_pack_unpack_roundtrip_on_jax_grids(env_id):
    env, st = jax_states(env_id, 64)
    # interact so doors open and keys get carried (richer cell values)
    step = _jax_step_core(env.params)
    for a in action_stream("interact", 12, 64):
        st = step(st, jnp.asarray(a))[0]
    grids = np.array(st.grid)
    packed = PG.pack_cells(torch.from_numpy(grids))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(JG.pack_cells(st.grid)))
    np.testing.assert_array_equal(PG.unpack_cells(packed).numpy(), grids)
    carry = torch.from_numpy(np.array(st.carrying))
    np.testing.assert_array_equal(PG.unpack_cells(PG.pack_cells(carry)),
                                  carry)


def test_grid_builders_match_jax():
    W, H = 7, 6
    j = JG.wall_rect(JG.empty_grid(W, H), 0, 0, W, H)
    j = JG.vert_wall(j, 3, 0)
    j = JG.horz_wall(j, 0, 2, 4)
    j = JG.set_cell(j, 5, 4, JC.WALL_CELL)
    j = JG.fill_rect(j, 1, 3, 2, 2, np.array([JC.LAVA, 0, 0, 0, 0], np.uint8))
    p = PG.wall_rect(PG.empty_grid(2, W, H), 0, 0, W, H)
    p = PG.vert_wall(p, 3, 0)
    p = PG.horz_wall(p, 0, 2, 4)
    p = PG.set_cell(p, torch.tensor([5, 5]), torch.tensor([4, 4]),
                    PC.WALL_CELL)
    p = PG.fill_rect(p, 1, 3, 2, 2, [PC.LAVA, 0, 0, 0, 0])
    for b in range(2):
        np.testing.assert_array_equal(p[b].numpy(), np.asarray(j))
    np.testing.assert_array_equal(PG.free_mask(p)[0].numpy(),
                                  np.asarray(JG.free_mask(j)))


@pytest.mark.parametrize("mission", [
    "use the key to open the door and then get to the goal",
    "get to the green goal square",
    "pick up the red ball, then go to the door on your left",
    "avoid the lava and get to the green goal square",
])
def test_tokenize_matches_jax(mission):
    assert PM.WORDS == JM.WORDS and PM.VOCAB_SIZE == JM.VOCAB_SIZE
    tok = PM.tokenize(mission)
    np.testing.assert_array_equal(tok, JM.tokenize(mission))
    assert PM.detokenize(tok) == JM.detokenize(tok) == mission


def _step_pair(env_id, kind, T=16, B=128):
    """Step exported JAX states through jax.vmap(step_core) and the port's
    batched step_core side by side; compare after every step."""
    env, jst = jax_states(env_id, B)
    pst = export(jst)
    jstep = _jax_step_core(env.params)
    for t, a in enumerate(action_stream(kind, T, B)):
        jst, jr, jte = jstep(jst, jnp.asarray(a))
        pst, pr, pte = p_step_core(env.params, pst, torch.from_numpy(a))
        assert_state_equal(pst, jst, msg=f"{env_id} step {t}")
        np.testing.assert_array_equal(pte.numpy(), np.asarray(jte))
        np.testing.assert_allclose(pr.numpy(), np.asarray(jr), rtol=1e-6)
        assert pr.dtype == torch.float32
    return env, jst, pst


@pytest.mark.parametrize("env_id,kind", [
    ("MiniGrid-DoorKey-8x8-v0", "uniform"),
    ("MiniGrid-DoorKey-8x8-v0", "interact"),
    ("MiniGrid-DoorKey-5x5-v0", "interact"),
    ("MiniGrid-Empty-5x5-v0", "uniform"),
])
def test_step_core_matches_jax(env_id, kind):
    _step_pair(env_id, kind)


def test_step_core_reward_on_goal_matches_jax():
    # agents one step before the goal, facing it: every env collects the
    # reward at a different step count
    env, jst = jax_states("MiniGrid-DoorKey-5x5-v0", 128)
    B = 128
    sc = (np.arange(B) * 7 % env.params.max_steps).astype(np.int32)
    jst = jst.replace(agent_pos=jnp.tile(jnp.asarray([[3, 2]], jnp.int32),
                                         (B, 1)),
                      agent_dir=jnp.ones((B,), jnp.int32),
                      step_count=jnp.asarray(sc))
    pst = export(jst)
    a = np.full((B,), 2, np.int32)
    jst2, jr, jte = jax.vmap(lambda s, a: j_step_core(env.params, s, a))(
        jst, jnp.asarray(a))
    pst2, pr, pte = p_step_core(env.params, pst, torch.from_numpy(a))
    assert np.asarray(jte).all() and pte.all()
    np.testing.assert_allclose(pr.numpy(), np.asarray(jr), rtol=1e-6)
    assert_state_equal(pst2, jst2)


@functools.lru_cache(maxsize=None)
def _stepped_doorkey():
    """DoorKey-8x8 states after 10 interaction steps on both sides (held
    equal at every step), shared by the observation cases."""
    return _step_pair("MiniGrid-DoorKey-8x8-v0", "interact", T=10, B=96)


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("see_through", [False, True])
def test_gen_obs_matches_jax(packed, see_through):
    env, jst, pst = _stepped_doorkey()
    params = dataclasses.replace(env.params, packed_obs=packed,
                                 see_through_walls=see_through)
    jo = jax.vmap(lambda s: j_gen_obs(params, s))(jst)
    po = p_gen_obs(params, pst)
    assert po.keys() == jo.keys()
    for k in jo:
        np.testing.assert_array_equal(po[k].numpy(), np.asarray(jo[k]),
                                      err_msg=k)
    key = "packed" if packed else "image"
    assert po[key].dtype == (torch.int32 if packed else torch.uint8)


@pytest.mark.parametrize("v", [3, 5, 7])
def test_process_vis_random_matches_jax(v):
    rng = np.random.default_rng(0)
    trans = np.concatenate([rng.random((40, v, v)) >= d
                            for d in (0.0, 0.1, 0.3, 0.5, 0.8, 1.0)])
    want = jax.vmap(lambda t: j_process_vis(t, v // 2))(jnp.asarray(trans))
    got = p_process_vis(torch.from_numpy(trans), v // 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_process_vis_exhaustive_3x3_matches_jax():
    trans = np.array(list(itertools.product([False, True], repeat=9)))
    trans = trans.reshape(-1, 3, 3)
    want = jax.vmap(lambda t: j_process_vis(t, 1))(jnp.asarray(trans))
    got = p_process_vis(torch.from_numpy(trans), 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert p_process_vis(torch.ones((1, 7, 7), dtype=torch.bool), 3).all()
