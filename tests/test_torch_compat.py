"""The port's user surface against the JAX package's: mission spaces and
class docs of all 178 IDs, the introspection helpers on converted states,
the Gymnasium adapter (``check_env``, lockstep with JAX's adapter from one
converted state, pickling, vectorisation, rendering), ``ManualControl``
driven by fake key events (JAX tests/test_scripts.py:20-75) and
``benchmark`` at tiny sizes, all on the CPU."""

from __future__ import annotations

import functools
import pickle
import re
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import jax

import minigrid_tpu
from minigrid_tpu.compat.gym_env import gym_make as jax_gym_make
from minigrid_tpu.core import obs as jax_obs
from minigrid_tpu.utils import introspect as JI

import minigrid_tpu_torch
from minigrid_tpu_torch.benchmark import benchmark
from minigrid_tpu_torch.compat import GymnasiumAdapter, gym_make
from minigrid_tpu_torch.convert import env_state_from_numpy
from minigrid_tpu_torch.manual_control import ManualControl
from minigrid_tpu_torch.utils import introspect as PI

from tests.torch_port_utils import share_cpu  # noqa: F401
from tests.torch_port_utils import CPU, export, jax_states

pytestmark = pytest.mark.usefixtures("share_cpu")

ALL_IDS = minigrid_tpu_torch.registered_ids()
# tests/test_compat.py's IDs, plus one WFC ID
CHECK_IDS = ["MiniGrid-Empty-8x8-v0", "MiniGrid-DoorKey-5x5-v0",
             "MiniGrid-Fetch-5x5-N2-v0", "MiniGrid-PutNear-6x6-N2-v0",
             "MiniGrid-LockedRoom-v0", "BabyAI-GoToRedBallGrey-v0",
             "MiniGrid-WFC-MazeSimple-v0"]
# the IDs whose steps draw nothing: the two adapters step in lockstep
LOCKSTEP_IDS = ["MiniGrid-DoorKey-5x5-v0", "MiniGrid-Fetch-5x5-N2-v0",
                "MiniGrid-PutNear-6x6-N2-v0", "MiniGrid-LockedRoom-v0",
                "BabyAI-GoToRedBallGrey-v0", "MiniGrid-WFC-MazeSimple-v0"]
INTROSPECT_IDS = ["MiniGrid-DoorKey-8x8-v0", "MiniGrid-LockedRoom-v0",
                  "MiniGrid-Fetch-8x8-N3-v0", "MiniGrid-KeyCorridorS3R3-v0",
                  "MiniGrid-Playground-v0", "MiniGrid-MultiRoom-N6-v0"]
BENCHMARK_KEYS = {"reset_ms", "render_fps", "agent_view_fps",
                  "batched_steps_per_s"}  # JAX benchmark()'s result keys


def spaces(env_id):
    return (minigrid_tpu_torch.make(env_id, device=CPU).mission_space(),
            minigrid_tpu.make(env_id).mission_space())


def plain_repr(space) -> str:
    """A mission space's repr without object addresses and package."""
    r = re.sub(r" at 0x[0-9a-f]+", "", repr(space))
    return r.replace("minigrid_tpu_torch.", "minigrid_tpu.")


@pytest.mark.parametrize("env_id", ALL_IDS)
def test_mission_space_matches_jax(env_id):
    """``sample`` (seeded alike), ``contains`` on both packages' samples
    and on strings of other IDs, the placeholders and the repr."""
    p, j = spaces(env_id)
    assert type(p).__name__ == type(j).__name__
    assert p.ordered_placeholders == j.ordered_placeholders
    assert plain_repr(p) == plain_repr(j)
    p.seed(7)
    j.seed(7)
    ps = [p.sample() for _ in range(6)]
    assert ps == [j.sample() for _ in range(6)]
    probes = ps + [minigrid_tpu.make(i).mission_space().sample()
                   for i in ("MiniGrid-Fetch-8x8-N3-v0",
                             "MiniGrid-PutNear-8x8-N3-v0",
                             "MiniGrid-GoToDoor-8x8-v0")]
    probes += ["", "go to the red", 3, "traverse the maze to get to the goal"]
    for x in probes:
        assert p.contains(x) == j.contains(x), (env_id, x)
    assert p.contains(ps[0])


def test_mission_space_equality_matches_jax():
    """``__eq__`` between the spaces of every pair of IDs, as JAX's."""
    port, jx = zip(*(spaces(i) for i in ALL_IDS))
    got = np.array([[a == b for b in port] for a in port])
    want = np.array([[a == b for b in jx] for a in jx])
    np.testing.assert_array_equal(got, want)
    assert not (port[0] == jx[0])  # a JAX space is not a port space


@pytest.mark.parametrize("env_id", ALL_IDS)
def test_class_doc_matches_jax(env_id):
    p = type(minigrid_tpu_torch.make(env_id, device=CPU))
    j = type(minigrid_tpu.make(env_id))
    assert p.__doc__ == j.__doc__, env_id


@functools.lru_cache(maxsize=None)
def jitted_gen_obs():
    """JAX's ``gen_obs``, jitted (its params static): what JAX's
    ``agent_sees`` calls, compiled once per env instead of run op by op
    (integer ops: the same observation)."""
    return jax.jit(jax_obs.gen_obs, static_argnums=0)


@pytest.mark.parametrize("env_id", INTROSPECT_IDS)
def test_introspection_matches_jax(env_id, monkeypatch):
    """``pprint_grid``, ``get_view_coords``, ``relative_coords``,
    ``in_view`` and ``agent_sees`` of converted JAX states, env by env."""
    monkeypatch.setattr(jax_obs, "gen_obs", jitted_gen_obs())
    jenv, jst = jax_states(env_id, 4, seed=2, packed=False)
    pst = export(jst)
    params = jenv.params
    rng = np.random.default_rng(0)
    for b in range(4):
        one = jax.tree.map(lambda x: x[b], jst)
        assert PI.pprint_grid(pst, b) == JI.pprint_grid(one)
        grid = np.asarray(one.grid)
        cells = np.argwhere(grid[..., 0] != 1)     # non-empty (x, y)
        for x, y in cells[rng.choice(len(cells), 6, replace=False)]:
            x, y = int(x), int(y)
            assert (PI.get_view_coords(params, pst, x, y, b)
                    == JI.get_view_coords(params, one, x, y))
            assert (PI.relative_coords(params, pst, x, y, b)
                    == JI.relative_coords(params, one, x, y))
            assert (PI.in_view(params, pst, x, y, b)
                    == JI.in_view(params, one, x, y))
            assert (PI.agent_sees(params, pst, x, y, b)
                    == JI.agent_sees(params, one, x, y)), (env_id, b, x, y)


@pytest.mark.parametrize("env_id", CHECK_IDS)
def test_check_env(env_id):
    from gymnasium.utils.env_checker import check_env

    env = gym_make(env_id, device=CPU)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*render.*")
        warnings.filterwarnings("ignore", message=".*Official support.*")
        check_env(env, skip_render_check=True)
    env.close()


def to_port_state(jax_state):
    """An unbatched JAX adapter state as the port's batch of one."""
    return env_state_from_numpy(jax.tree.map(lambda x: np.asarray(x)[None],
                                             jax_state), CPU)


@pytest.mark.parametrize("env_id", LOCKSTEP_IDS)
def test_adapter_lockstep_with_jax(env_id):
    """JAX's adapter reset, its state converted into the port's adapter,
    then 24 steps of both with the same actions: observations (image,
    direction, mission), rewards, flags and the introspection properties
    bit for bit."""
    j = jax_gym_make(env_id)
    p = gym_make(env_id, device=CPU)
    j.reset(seed=3)
    p.reset(seed=3)
    p._state = to_port_state(j._state)
    rng = np.random.default_rng(1)
    for t in range(24):
        a = int(rng.integers(0, j.action_space.n))
        jo, jr, jte, jtr, _ = j.step(a)
        po, pr, pte, ptr, _ = p.step(a)
        np.testing.assert_array_equal(po["image"], jo["image"])
        assert (po["direction"], po["mission"], pr, pte, ptr) == (
            jo["direction"], jo["mission"], jr, jte, jtr), (env_id, t)
        assert p.agent_pos == j.agent_pos and p.agent_dir == j.agent_dir
        assert (p.carrying, p.step_count, p.max_steps) == (
            j.carrying, j.step_count, j.max_steps)
        np.testing.assert_array_equal(p.encode_grid(), j.encode_grid())
        if jte or jtr:
            break
    np.testing.assert_array_equal(p.get_frame(tile_size=8),
                                  j.get_frame(tile_size=8))


def test_reset_seed_determinism_and_step_types():
    env = gym_make("MiniGrid-WFC-MazeSimple-v0", device=CPU, size=11)
    obs1, _ = env.reset(seed=42)
    h1 = env.hash()
    obs2, _ = env.reset(seed=42)
    assert env.hash() == h1
    assert np.array_equal(obs1["image"], obs2["image"])
    assert obs1["image"].dtype == np.uint8 and obs1["image"].shape == (7, 7, 3)
    assert obs1["mission"] in env.observation_space["mission"]
    obs, reward, term, trunc, _ = env.step(2)
    assert isinstance(reward, float) and isinstance(term, bool)
    assert isinstance(trunc, bool)
    assert env.step_count == 1 and env.steps_remaining == env.max_steps - 1
    hashes = set()
    for _ in range(4):  # unseeded resets draw from np_random
        env.reset()
        hashes.add(env.hash())
    assert len(hashes) > 1


def test_adapter_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gym_make("MiniGrid-Empty-5x5-v0")
    assert gym_make("MiniGrid-Empty-5x5-v0", device=CPU).env.device.type == (
        "cpu")


def test_introspection_properties_and_render():
    env = gym_make("MiniGrid-DoorKey-5x5-v0", device=CPU,
                   render_mode="rgb_array", tile_size=8)
    env.reset(seed=3)
    assert env.width == env.height == 5
    x, y = env.agent_pos
    assert 0 <= x < 5 and 0 <= y < 5 and 0 <= env.agent_dir < 4
    assert env.carrying is None
    enc = env.encode_grid()
    assert enc.shape == (5, 5, 3) and enc.dtype == np.uint8
    img = env.render()
    assert img.shape == (40, 40, 3) and img.dtype == np.uint8
    env.close()


@pytest.mark.parametrize("env_id", ["MiniGrid-DoorKey-5x5-v0",
                                    "MiniGrid-Dynamic-Obstacles-6x6-v0",
                                    "MiniGrid-WFC-ObstaclesBlackdots-v0"])
def test_pickle_env(env_id):
    """A mid-episode copy continues the episode identically (its
    generator's state travels with it)."""
    env = gym_make(env_id, device=CPU)
    obs1, _ = env.reset(seed=7)
    clone = pickle.loads(pickle.dumps(env))
    obs2, _ = clone.reset(seed=7)
    assert np.array_equal(obs1["image"], obs2["image"])
    env.reset(seed=11)
    env.step(2)
    clone = pickle.loads(pickle.dumps(env))
    for action in [2, 2, 0, 2, 1, 2]:
        ra, rb = env.step(action), clone.step(action)
        assert np.array_equal(ra[0]["image"], rb[0]["image"])
        assert ra[1:] == rb[1:]


def test_pickle_preserves_space_rng():
    env = gym_make("MiniGrid-Empty-5x5-v0", device=CPU)
    env.reset(seed=0)
    env.action_space.seed(123)
    env.observation_space.seed(456)
    expect = [env.action_space.sample() for _ in range(4)]
    env.action_space.seed(123)
    env.observation_space.seed(456)
    clone = pickle.loads(pickle.dumps(env))
    assert [clone.action_space.sample() for _ in range(4)] == expect
    assert np.array_equal(env.observation_space["image"].sample(),
                          clone.observation_space["image"].sample())


def test_sync_vector_env():
    import gymnasium as gym

    env = gym.vector.SyncVectorEnv(
        [lambda: gym_make("MiniGrid-Empty-8x8-v0", device=CPU)
         for _ in range(4)])
    obs, _ = env.reset(seed=0)
    assert obs["image"].shape == (4, 7, 7, 3)
    assert env.single_observation_space == gym_make(
        "MiniGrid-Empty-8x8-v0", device=CPU).observation_space
    obs, reward, term, trunc, _ = env.step(env.action_space.sample())
    assert obs["image"].shape == (4, 7, 7, 3)
    assert reward.shape == term.shape == (4,)
    env.close()


def test_manual_control_fake_events():
    """ManualControl with fake keyboard events, headless (rgb_array)."""

    class FakeRandomKeyboardEvent:
        active_actions = ["left", "right", "up", "space", "pageup",
                          "pagedown"]

        def __init__(self, reset=False, close=False):
            if reset:
                self.key = "backspace"
            elif close:
                self.key = "escape"
            else:
                self.key = np.random.choice(self.active_actions)

    env = GymnasiumAdapter("MiniGrid-Empty-8x8-v0", render_mode="rgb_array",
                           device=CPU)
    mc = ManualControl(env, seed=42)
    np.random.seed(0)
    for _ in range(2):
        mc.reset(42)
        for _ in range(12):
            mc.key_handler(FakeRandomKeyboardEvent())
        assert env.step_count > 0
        mc.key_handler(FakeRandomKeyboardEvent(reset=True))
        assert env.step_count == 0
    mc.key_handler(FakeRandomKeyboardEvent(close=True))
    assert mc.closed


def test_manual_control_full_episode():
    """Forward, forward, right, forward, forward reaches Empty-5x5's goal;
    the termination resets to step 0."""

    class E:
        def __init__(self, key):
            self.key = key

    env = GymnasiumAdapter("MiniGrid-Empty-5x5-v0", render_mode="rgb_array",
                           device=CPU)
    mc = ManualControl(env, seed=7)
    mc.reset(7)
    for key in ["up", "up", "right", "up"]:
        mc.key_handler(E(key))
    assert env.step_count == 4
    mc.key_handler(E("up"))
    assert env.step_count == 0


@pytest.mark.parametrize("env_id", ["MiniGrid-Empty-5x5-v0",
                                    "MiniGrid-WFC-MazeSimple-v0"])
def test_benchmark_returns_jax_keys(env_id):
    res = benchmark(env_id, num_resets=2, num_frames=4, batch=8, chunk=4,
                    device=CPU)
    assert set(res) == BENCHMARK_KEYS
    assert all(v > 0 for v in res.values())


def test_benchmark_batched_failure_is_raised(monkeypatch):
    """A failure in the batched phase fails the call (JAX's swallows it)."""
    from minigrid_tpu_torch.envs import base

    def broken(*a, **k):
        raise RuntimeError("pooled step failed")

    monkeypatch.setattr(base.MiniGridEnv, "step_autoreset_pooled", broken)
    with pytest.raises(RuntimeError, match="pooled step failed"):
        benchmark("MiniGrid-Empty-5x5-v0", num_resets=1, num_frames=1,
                  batch=4, chunk=2, device=CPU)


def test_port_imports_neither_jax_nor_gymnasium():
    """The package, its subpackages' re-exports and its entry points
    import no JAX, and ``compat`` (gymnasium) only when asked for."""
    code = ("import sys, minigrid_tpu_torch, minigrid_tpu_torch.benchmark, "
            "minigrid_tpu_torch.envs.wfc.graphtransforms, "
            "minigrid_tpu_torch.utils.introspect, minigrid_tpu_torch.models, "
            "minigrid_tpu_torch.utils, minigrid_tpu_torch.envs, "
            "minigrid_tpu_torch.ops, minigrid_tpu_torch.core; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'minigrid_tpu', 'gymnasium', 'pygame')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True)
