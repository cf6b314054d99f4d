"""The port's registry (minigrid_tpu_torch/register_envs.py) against the
JAX package's: the ID set (all 178 JAX IDs), each ID's constructor
attributes, keyword overrides, and every ID
reset and stepped on the CPU through each auto-reset mode (the per-ID
params, class names and missions are in
tests/test_torch_envs.py::test_registry_matches_jax).
"""

from __future__ import annotations

import pytest
import torch

import minigrid_tpu

import minigrid_tpu_torch
from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core.types import MISSION_LEN
from minigrid_tpu_torch.envs.base import pool_from_states, random_keys

from tests.torch_port_utils import share_cpu  # noqa: F401
from tests.torch_port_utils import CPU

pytestmark = pytest.mark.usefixtures("share_cpu")

# constructor attributes the generators and hooks read: the JAX env's public
# attributes of these types
SIMPLE = (int, str, bool, float, tuple, type(None))


def test_ported_ids_are_the_jax_ids_of_these_families():
    want = sorted(minigrid_tpu.registered_ids())
    assert minigrid_tpu_torch.registered_ids() == want
    assert len(want) == 178
    assert sum(i.startswith("MiniGrid-WFC-") for i in want) == 6
    assert sum(i.startswith("MiniGrid-") for i in want) == 82
    assert sum(i.startswith("BabyAI-") for i in want) == 96


@pytest.mark.parametrize("env_id", minigrid_tpu_torch.registered_ids())
def test_id_attributes_match_jax(env_id):
    p = minigrid_tpu_torch.make(env_id, device=CPU)
    j = minigrid_tpu.make(env_id)
    attrs = {k: v for k, v in vars(j).items()
             if isinstance(v, SIMPLE) and not k.startswith("_")}
    for a, v in attrs.items():
        assert getattr(p, a, "missing") == v, (env_id, a)


@pytest.mark.parametrize("env_id", minigrid_tpu_torch.registered_ids())
def test_id_resets_and_steps_on_cpu(env_id):
    """A staggered reset, then pooled, fresh and regen auto-reset steps
    with truncations forced, on the CPU: shapes, dtypes, ``extra`` carried,
    every reset state a step-0 state."""
    Bsz = 6
    env = minigrid_tpu_torch.make(env_id, device=CPU).packed()
    g = env.generator(0)
    # one generation call for the batch, the pool's 4 layouts and the fresh
    # buffer's 12 (a WFC solve or a level that never validates costs about
    # the same for 6 envs as for 22): the staggered reset of 22, whose last
    # 16 with their step counts zeroed are what make_pool and
    # presample_fresh would have generated
    obs, st = env.reset_staggered(g, Bsz + 16)
    rest = st.map(lambda x: x[Bsz:]).replace(step_count=torch.zeros(
        16, dtype=torch.int32))
    obs = {k: v[:Bsz] for k, v in obs.items()}
    st = st.map(lambda x: x[:Bsz])
    pool = pool_from_states(rest.map(lambda x: x[:4]))
    buffer = rest.map(lambda x: x[4:])
    V = env.params.view_size
    assert obs["packed"].shape == (Bsz, V, V)
    assert obs["mission"].shape == (Bsz, MISSION_LEN)
    extra_keys = set(st.extra or {})
    cursor = torch.zeros((), dtype=torch.int32)
    budget = "max_steps" in extra_keys
    if budget:
        # a BabyAI level's budget is per episode; the staggered offset is
        # drawn below params.max_steps = 2^30 (as in JAX), so draw it again
        # below the episode's budget
        st = st.replace(step_count=st.step_count % st.extra["max_steps"])
    for mode in ("pooled", "fresh", "regen"):
        last = (st.extra["max_steps"] if budget else env.params.max_steps) - 1
        st = st.replace(step_count=torch.where(torch.arange(Bsz) % 2 == 0,
                                               last, st.step_count).to(
                                                   torch.int32))
        keys = random_keys(g, (Bsz, 2), CPU)
        a = torch.randint(0, env.num_actions, (Bsz,), generator=g)
        if mode == "pooled":
            out = env.step_autoreset_pooled(keys, st, a, pool, g)
        elif mode == "fresh":
            *out, cursor = env.step_autoreset_fresh(keys, st, a, buffer,
                                                    cursor, 6)
        else:
            out = env.step_autoreset(keys, st, a, g)
        obs, new, r, te, tr, _ = out
        assert r.dtype == torch.float32 and te.dtype == torch.bool
        assert obs["packed"].shape == (Bsz, V, V)
        assert set(new.extra or {}) == extra_keys
        done = te | tr
        assert done[::2].all(), (env_id, mode)
        assert (new.step_count[done] == 0).all()
        if not getattr(env, "start_carrying", False):
            assert (new.carrying[done, 0] == C.EMPTY).all()
        lo, hi = env.reward_range
        assert ((r >= lo) & (r <= hi)).all()
        st = new


def test_make_passes_keyword_overrides():
    env = minigrid_tpu_torch.make("MiniGrid-LavaGapS5-v0", device=CPU,
                                  obstacle_type="wall", max_steps=7)
    assert env.params.max_steps == 7 and env.obstacle_type == "wall"
    env = minigrid_tpu_torch.make("MiniGrid-MultiRoom-N6-v0", device=CPU,
                                  view_size=9)
    assert env.params.view_size == 9 and env.params.width == 25
    missing = "MiniGrid-NoSuchEnv-v0"  # an ID neither package registers
    assert missing not in minigrid_tpu.registered_ids()
    with pytest.raises(KeyError, match="Unknown environment"):
        minigrid_tpu_torch.make(missing, device=CPU)
