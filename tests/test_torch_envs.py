"""The port's env layer (minigrid_tpu_torch/envs, registry) against the JAX
package: Empty layouts exactly, DoorKey layouts by invariants and by
chi-square against JAX draws (the two RNGs cannot replay each other), the
layout pool's rows bit-exact after conversion, the staggered reset and the
registry."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
from scipy import stats as sps

import jax
import torch

import minigrid_tpu

import minigrid_tpu_torch
from minigrid_tpu_torch.convert import layout_pool_from_entries
from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core.mission import tokenize
from minigrid_tpu_torch.envs.base import presample_reset_states
from minigrid_tpu_torch.models.actor_critic import ActorCritic

from tests.torch_port_utils import (CPU, assert_state_equal,
                                    doorkey_features)

# every JAX ID, the 6 WaveFunctionCollapse ones included
PORT_IDS = minigrid_tpu.registered_ids()


def test_registry_matches_jax():
    """The 178 IDs, each with the JAX env's params, class name, default
    mission, action count and reward range."""
    assert len(PORT_IDS) == 178
    assert minigrid_tpu_torch.registered_ids() == sorted(PORT_IDS)
    for env_id in PORT_IDS:
        p = minigrid_tpu_torch.make(env_id, device=CPU)
        j = minigrid_tpu.make(env_id)
        assert dataclasses.asdict(p.params) == dataclasses.asdict(j.params)
        assert type(p).__name__ == type(j).__name__
        assert p.default_mission() == j.default_mission()
        assert p.num_actions == j.num_actions, env_id
        assert tuple(p.reward_range) == tuple(j.reward_range), env_id


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        minigrid_tpu_torch.make("MiniGrid-DoorKey-8x8-v0")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ActorCritic()
    env = minigrid_tpu_torch.make("MiniGrid-DoorKey-8x8-v0", device=CPU)
    assert env.device.type == "cpu"


@pytest.mark.parametrize("env_id", ["MiniGrid-Empty-5x5-v0",
                                    "MiniGrid-Empty-6x6-v0",
                                    "MiniGrid-Empty-8x8-v0",
                                    "MiniGrid-Empty-16x16-v0"])
@pytest.mark.parametrize("packed", [False, True])
def test_empty_reset_exact(env_id, packed):
    jenv = minigrid_tpu.make(env_id)
    penv = minigrid_tpu_torch.make(env_id, device=CPU)
    if packed:
        jenv, penv = jenv.packed(), penv.packed()
    jo, jst = jax.jit(jax.vmap(jenv.reset))(
        jax.random.split(jax.random.PRNGKey(0), 4))
    po, pst = penv.reset(penv.generator(0), 4)
    assert_state_equal(pst, jst, fields=(
        "grid", "agent_pos", "agent_dir", "carrying", "step_count",
        "terminated", "truncated", "mission"))
    for k in jo:
        np.testing.assert_array_equal(po[k].numpy(), np.asarray(jo[k]))


def test_empty_random_start_is_a_free_cell():
    env = minigrid_tpu_torch.make("MiniGrid-Empty-Random-6x6-v0", device=CPU)
    _, st = env.reset(env.generator(1), 512)
    b = torch.arange(512)
    x, y = st.agent_pos[:, 0].long(), st.agent_pos[:, 1].long()
    assert (st.grid[b, x, y, 0] == C.EMPTY).all()
    assert len(set(map(tuple, st.agent_pos.tolist()))) > 10
    assert set(st.agent_dir.tolist()) == {0, 1, 2, 3}


@pytest.mark.parametrize("size", [5, 8, 16])
def test_doorkey_layout_invariants(size):
    env = minigrid_tpu_torch.make(f"MiniGrid-DoorKey-{size}x{size}-v0",
                                  device=CPU)
    B = 512
    _, st = env.reset(env.generator(size), B)
    g = st.grid.numpy()
    wall = np.array([C.WALL, C.COLOR_TO_IDX["grey"], 0, 0, 0])
    for border in (g[:, 0], g[:, -1], g[:, :, 0], g[:, :, -1]):
        assert (border == wall).all()
    goal = np.array([C.GOAL, C.COLOR_TO_IDX["green"], 0, 0, 0])
    assert (g[:, size - 2, size - 2] == goal).all()
    f = doorkey_features(g, st.agent_pos, st.agent_dir)
    assert ((f["split"] >= 2) & (f["split"] <= size - 3)).all()
    assert ((f["door_row"] >= 1) & (f["door_row"] <= size - 3)).all()
    yellow = C.COLOR_TO_IDX["yellow"]
    for b in range(B):
        s, dy = f["split"][b], f["door_row"][b]
        col = g[b, s]
        assert (col[dy] == [C.DOOR, yellow, C.LOCKED, 0, 0]).all()
        assert (np.delete(col, dy, axis=0) == wall).all()
        kx, ky = divmod(f["key"][b], size)
        assert (g[b, kx, ky] == [C.KEY, yellow, 0, 0, 0]).all() and kx < s
        ax, ay = divmod(f["agent"][b], size)
        assert ax < s and g[b, ax, ay, 0] == C.EMPTY  # on no object
    assert set(f["agent_dir"].tolist()) == {0, 1, 2, 3}
    assert (st.carrying.numpy() == C.EMPTY_CELL).all()
    assert (st.step_count == 0).all() and not st.terminated.any()
    np.testing.assert_array_equal(
        st.mission.numpy(),
        np.broadcast_to(tokenize(env.default_mission()), st.mission.shape))


def test_doorkey_distribution_matches_jax():
    """Chi-square of each layout feature: ~2000 port draws against ~2000
    draws of the JAX generator, p > 1e-3 for each."""
    n = 2000
    jenv = minigrid_tpu.make("MiniGrid-DoorKey-8x8-v0")
    jst = jax.jit(jax.vmap(jenv._gen_grid))(
        jax.random.split(jax.random.PRNGKey(11), n))
    penv = minigrid_tpu_torch.make("MiniGrid-DoorKey-8x8-v0", device=CPU)
    pst = penv._gen_grid(penv.generator(11), n)
    jf = doorkey_features(jst.grid, jst.agent_pos, jst.agent_dir)
    pf = doorkey_features(pst.grid.numpy(), pst.agent_pos, pst.agent_dir)
    for k in jf:
        cats = np.union1d(jf[k], pf[k])
        table = np.stack([(jf[k][:, None] == cats).sum(0),
                          (pf[k][:, None] == cats).sum(0)])
        p = sps.chi2_contingency(table)[1]
        assert p > 1e-3, (k, p, table)


def test_pool_rows_from_jax_entries_exact():
    jenv = minigrid_tpu.make("MiniGrid-DoorKey-8x8-v0").packed()
    jpool = jenv.make_pool(jax.random.PRNGKey(2), 12)
    entries = [jax.tree.map(np.asarray, jpool.entry(i)) for i in range(12)]
    pool = layout_pool_from_entries(entries, CPU)
    assert pool.size == 12
    for i in (0, 5, 11):
        e = pool.entry(i)
        je = jax.tree.map(lambda x: x[None], jpool.entry(i))
        assert_state_equal(e, je, fields=(
            "grid", "agent_pos", "agent_dir", "carrying", "step_count",
            "terminated", "truncated", "mission"))
    # a presampled row holds exactly the pool row it was drawn from
    g = torch.Generator().manual_seed(0)
    idx = torch.randint(0, 12, (6,), generator=torch.Generator().manual_seed(0))
    rows = presample_reset_states(g, pool, 6)
    assert torch.equal(rows.grid, pool.grid[idx])
    assert torch.equal(rows.scal, pool.scal[idx])
    assert torch.equal(rows.mission, pool.mission[idx])


def test_pool_draws_are_uniform():
    env = minigrid_tpu_torch.make("MiniGrid-DoorKey-8x8-v0", device=CPU)
    g = env.generator(4)
    pool = env.make_pool(g, 16)
    pool = type(pool)(grid=pool.grid, scal=pool.scal,
                      mission=torch.arange(16)[:, None].expand(16, 4),
                      width=8, height=8)
    drawn = presample_reset_states(g, pool, 4000).mission[:, 0].numpy()
    counts = np.bincount(drawn, minlength=16)
    assert sps.chisquare(counts).pvalue > 1e-3


def test_reset_staggered_offsets():
    env = minigrid_tpu_torch.make("MiniGrid-DoorKey-5x5-v0", device=CPU)
    ms = env.params.max_steps
    _, st = env.reset_staggered(env.generator(0), 4000)
    sc = st.step_count.numpy()
    assert sc.dtype == np.int32
    assert sc.min() >= 0 and sc.max() < ms
    counts = np.bincount(sc * 10 // ms, minlength=10)
    assert sps.chisquare(counts).pvalue > 1e-3
