"""The port's spans and counters (minigrid_tpu_torch/utils/trace.py) on tiny
CPU train steps of DoorKey-8x8 (pooled resets) and BabyAI-PutNextLocal
(fresh resets: the hooks and the fresh buffer's generation): with tracing
off a step enters no profiler range of the program's and stores nothing;
under ``torch.profiler`` and under ``enable()`` it records the layers' span
tree, whose ``mg.*`` ranges the profiler's events carry; ``counters()`` is
the counter objects' own fields."""

from __future__ import annotations

import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import minigrid_tpu_torch as mt
from minigrid_tpu_torch import wrappers as W
from minigrid_tpu_torch.core import roomgrid
from minigrid_tpu_torch.envs.base import random_keys
from minigrid_tpu_torch.envs.wfc import solver
from minigrid_tpu_torch.models import ppo as PPO
from minigrid_tpu_torch.models.actor_critic import ActorCritic
from minigrid_tpu_torch.models.policy_step import POLICY
from minigrid_tpu_torch.ops import native
from minigrid_tpu_torch.utils import trace
from tests.torch_port_utils import share_cpu  # noqa: F401

B, T = 8, 2
DOORKEY = "MiniGrid-DoorKey-8x8-v0"
# case -> (env id, reset mode, fresh buffer rows)
CASES = {"DoorKey-8x8 pooled": (DOORKEY, "pooled", None),
         "PutNextLocal fresh": ("BabyAI-PutNextLocal-v0", "fresh", 32)}
# (span, the span it opened under) in every train step
TREE = {("train_step", None), ("rollout", "train_step"),
        ("policy", "rollout"), ("env.step", "rollout"),
        ("env.kernel", "env.step"), ("env.select", "env.step"),
        ("update", "train_step")}
# and in a fresh BabyAI step: the verifier's hooks, the buffer's generation
# and its stages
FRESH_HOOKED = {("env.hooks", "env.step"), ("gen", "rollout"),
                ("gen.layout", "gen"), ("gen.instr", "gen"),
                ("gen.validate", "gen")}


class Loop:
    """A tiny train step of one case, its state carried from call to call
    (one a case in the module: :func:`loop_of`)."""

    def __init__(self, case):
        env_id, self.resets, fresh_buffer = CASES[case]
        env = mt.make(env_id, device="cpu").packed()
        self.g = env.generator(0)
        model = ActorCritic(view_size=env.params.view_size, hidden=32,
                            mission_dim=16, device="cpu")
        cfg = PPO.PPOConfig(num_envs=B, rollout_len=T, num_minibatches=2)
        self.pool = env.make_pool(self.g, 8) if self.resets == "pooled" \
            else None
        self.obs, self.st = env.reset(self.g, B)
        self.train_step = PPO.make_train_step(
            env, model, cfg, PPO.make_optimizer(model, cfg),
            resets=self.resets, fresh_buffer=fresh_buffer)

    def step(self):
        self.st, self.obs, _ = self.train_step(self.st, self.obs, self.g,
                                               self.pool)

    def tree(self):
        return TREE | (FRESH_HOOKED if self.resets == "fresh" else set())


LOOPS = {}


def loop_of(case):
    if case not in LOOPS:
        LOOPS[case] = Loop(case)
    return LOOPS[case]


@pytest.fixture(params=list(CASES))
def loop(request):
    return loop_of(request.param)


def tree_of(recs):
    name = {r.id: r.name for r in recs}
    return {(r.name, name.get(r.parent)) for r in recs}


def assert_self_within_inclusive(recs):
    child = {}
    for r in recs:
        if r.parent is not None:
            child[r.parent] = child.get(r.parent, 0) + r.end_ns - r.start_ns
    for r in recs:
        ns = r.end_ns - r.start_ns
        assert 0 <= ns - child.get(r.id, 0) <= ns, r
    for row in trace.summary(recs).values():
        assert 0 <= row["self_ms"] <= row["ms"]


def count_ranges(monkeypatch):
    """The names of the profiler ranges entered from now on."""
    entered = []

    class Counting(torch.autograd.profiler.record_function):
        def __init__(self, name, *args, **kwargs):
            entered.append(name)
            super().__init__(name, *args, **kwargs)

    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        Counting)
    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    return entered


def test_off_a_step_enters_no_range_and_stores_nothing(loop, monkeypatch):
    entered = count_ranges(monkeypatch)
    trace.clear()
    loop.step()
    # torch's optimizer enters a range of its own at every step, spans on
    # or off: the program's ranges are the mg.* ones
    assert [n for n in entered if n.startswith(trace.PREFIX)] == []
    assert trace.records() == []


def test_a_step_under_the_profiler_records_the_tree_as_named_ranges(
        monkeypatch):
    loop = loop_of("DoorKey-8x8 pooled")
    entered = count_ranges(monkeypatch)
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        loop.step()
    want = {trace.PREFIX + n for n, _ in loop.tree()}
    assert want <= {e.name for e in prof.events()}
    assert want <= set(entered)
    recs = trace.records()
    assert tree_of(recs) == loop.tree()
    assert_self_within_inclusive(recs)
    trace.clear()


def test_a_step_under_enable_records_the_layers_span_tree(loop):
    trace.clear()
    trace.enable()
    try:
        loop.step()
    finally:
        trace.disable()
    recs = trace.records()
    assert tree_of(recs) == loop.tree()
    assert [r.name for r in recs if r.parent is None] == ["train_step"]
    calls = {k: v["calls"] for k, v in trace.summary().items()}
    assert calls["policy"] == calls["env.step"] == T
    assert_self_within_inclusive(recs)
    trace.clear()


def test_env_step_counts_once_through_a_wrapper_and_other_roots():
    """A wrapper's entry that delegates to the env's records one env.step;
    the vector step and the pool refresh are roots of their own."""
    env = mt.make(DOORKEY, device="cpu").packed()
    g = env.generator(1)
    pool = env.make_pool(g, 4)
    stack = W.ImgObsWrapper(env)
    _, st = stack.reset(g, 4)
    reset, vstep = env.vector(4)
    _, vst = reset(g)
    a = torch.zeros((4,), dtype=torch.int32)
    trace.clear()
    trace.enable()
    try:
        stack.step_autoreset_presampled(random_keys(g, (4, 2), "cpu"), st, a,
                                        pool.rows(0))
        vstep(random_keys(g, (4, 2), "cpu"), vst, a, g)
        mt.refresh_layout_pool(env, g, pool)
    finally:
        trace.disable()
    recs = trace.records()
    assert [r.name for r in recs if r.parent is None] == [
        "env.step", "env.step", "pool_refresh"]
    assert tree_of(recs) == {
        ("env.step", None), ("env.kernel", "env.step"),
        ("env.select", "env.step"), ("gen", "env.step"),
        ("env.hooks", "env.step"), ("pool_refresh", None),
        ("gen", "pool_refresh")}
    assert_self_within_inclusive(recs)
    trace.clear()


def test_counters_are_the_counter_objects_fields():
    loop_of("PutNextLocal fresh").step()
    got = trace.counters()
    want = {f"gen.{f.name}": getattr(roomgrid.COUNTERS, f.name)
            for f in dataclasses.fields(roomgrid.COUNTERS)}
    want |= {f"wfc.{f.name}": getattr(solver.COUNTERS, f.name)
             for f in dataclasses.fields(solver.COUNTERS)}
    want |= {f"policy.{k}": getattr(POLICY, k)
             for k in ("graph_captures", "graph_replays", "eager_steps")}
    want |= {f"kernel.{k}": getattr(native.COUNTERS, k)
             for k in ("launches", "observe_launches", "wide_launches",
                       "wide_observe_launches", "verify_launches",
                       "select_launches")}
    assert got == want
    assert got["gen.host_syncs"] > 0  # PutNextLocal's generator syncs
