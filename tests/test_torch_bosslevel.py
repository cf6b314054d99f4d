"""BabyAI-BossLevel against the benchmark's plain reference
(``port_bench/reference/levelgen.py``), on the CPU.

Cases built by hand on the port's own BossLevel layouts: an agent placed
between two objects of a generated level and given one instruction per
leaf kind and per root kind, then stepped through the fresh auto-reset
path and followed by the reference (``reference/follow.py::replay``, the
check that decides a run's ``correct``); each case's success step is
upstream's, written in the case. The location words against upstream's
matches on a grid built by hand. The port's BossLevel train step at B=64
followed by the reference. Two faults of the port that the check must
catch: the verifier dispatching a "before" root to its "and" branch, and
the batch's largest budget in place of each env's."""

from __future__ import annotations

import functools
import json
import sys
import time
from pathlib import Path

import torch

import minigrid_tpu_torch as mt
from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.envs.babyai.core import instrs as I
from minigrid_tpu_torch.envs.babyai.core import level as L
from minigrid_tpu_torch.envs.base import random_keys
from tests.torch_port_utils import share_cpu  # noqa: F401

BENCH = Path(__file__).resolve().parent.parent / "port_bench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from reference import follow as FL  # noqa: E402
from reference import levelgen as LG  # noqa: E402

ENV_ID = "BabyAI-BossLevel-v0"
CELL = "bosslevel.train_fresh_own"
CONFIG = json.loads((BENCH / "configs" / "bosslevel.json").read_text())
ENV = CONFIG["env"]
LEFT, RIGHT, FORWARD, PICKUP, DROP, TOGGLE, DONE = range(7)
DIRS = ((1, 0), (0, 1), (-1, 0), (0, -1))
# the port's descriptor type of each object type
DESC_TYPE = {C.BOX: 0, C.BALL: 1, C.KEY: 2, C.DOOR: 3}


@functools.lru_cache(maxsize=None)
def port_env():
    return mt.make(ENV_ID, device="cpu").packed()


@functools.lru_cache(maxsize=None)
def layouts(seed=11, n=64):
    env = port_env()
    states, ok, _ = env.generate(env.generator(seed), n)
    assert bool(ok.all())
    return states


def obj_desc(cell, loc=I.LOC_NONE):
    return L.desc(DESC_TYPE[int(cell[0])], int(cell[1]), loc)


def _poses(state, b):
    """(x, y, d) poses of layout b where the agent may start (an empty
    cell, facing an empty cell or a wall) with objects at its left and its
    right, neither a key, of different types or colours."""
    g = state.grid[b]
    W, H = g.shape[:2]

    def at(x, y):
        return g[x, y] if 0 <= x < W and 0 <= y < H else None

    out = []
    for x in range(1, W - 1):
        for y in range(1, H - 1):
            if int(g[x, y, 0]) != C.EMPTY:
                continue
            for d in range(4):
                f = at(x + DIRS[d][0], y + DIRS[d][1])
                lc = at(x + DIRS[(d + 3) % 4][0], y + DIRS[(d + 3) % 4][1])
                rc = at(x + DIRS[(d + 1) % 4][0], y + DIRS[(d + 1) % 4][1])
                if int(f[0]) not in (C.EMPTY, C.WALL):
                    continue
                kinds = (int(lc[0]), int(rc[0]))
                if any(k not in (C.BOX, C.BALL, C.DOOR) for k in kinds):
                    continue
                if tuple(lc[:2].tolist()) == tuple(rc[:2].tolist()):
                    continue
                out.append((x, y, d, lc.clone(), rc.clone()))
    return out


def build(cases, step_count=0):
    """The port's states of ``cases``: each (layout, pose, spec), the
    layout's grid with the agent at the pose and the spec's instruction
    (its descriptors matched, its budget, its surface). Returns (obs,
    state)."""
    env = port_env()
    src = layouts()
    rows = [c[0] for c in cases]
    n = len(cases)
    g = env.generator(0)
    b = env.builder(g, n).replace(
        grid=src.grid[rows].clone(),
        agent_pos=torch.tensor([c[1][:2] for c in cases], dtype=torch.int32),
        agent_dir=torch.tensor([c[1][2] for c in cases], dtype=torch.int32))
    specs = [c[2] for c in cases]

    def col(f):
        return torch.stack([torch.as_tensor(f(s)) for s in specs])

    spec = {"root": col(lambda s: s["root"]),
            "a_and": col(lambda s: s["a_and"]),
            "b_and": col(lambda s: s["b_and"]),
            "leaves": [{"kind": col(lambda s: s["leaves"][k]["kind"]),
                        "strict": False,
                        "move": tuple(col(lambda s: s["leaves"][k]["move"][j])
                                      for j in range(3)),
                        "fixed": tuple(col(lambda s: s["leaves"][k]["fixed"][j])
                                       for j in range(3))}
                       for k in range(4)]}
    instr = env._instr_from_spec(spec, b)
    assert bool(env._validate(b, instr).all())
    extra = {**instr.to_extra(), "max_steps": env._max_steps_value(instr)}
    st = env.finish(g, b, mission=I.surface_tokens(instr), extra=extra)
    obs, st = env.reset_from(st)
    return obs, st.replace(step_count=torch.full_like(st.step_count,
                                                      step_count))


def core(st):
    return {k: getattr(st, k).clone() for k in FL.STATE_KEYS}


def follow(obs, st, actions, buffer_seed=5):
    """Step the port's fresh auto-reset with ``actions`` (T lists of B
    actions) and follow it with the reference: (env_mismatches, the port's
    rewards (T, B))."""
    env = port_env()
    g = env.generator(buffer_seed)
    buffer = env.presample_fresh(g, 40)
    B, T = st.batch_size, len(actions)
    rec = {"mode": "fresh", "rollout_len": T, "buffers": [core(buffer)],
           "start": {"state": core(st), "obs": obs["packed"].clone()},
           "steps": []}
    cursor = torch.zeros((), dtype=torch.int32)
    rewards = []
    for a in actions:
        a = torch.tensor(a, dtype=torch.int32)
        keys = random_keys(g, (B, 2), "cpu")
        obs, st, r, term, trunc, _, cursor = env.step_autoreset_fresh(
            keys, st, a, buffer, cursor, 32)
        rec["steps"].append({
            "action": a, "state": core(st), "obs": obs["packed"].clone(),
            "direction": obs["direction"].clone(), "reward": r.clone(),
            "terminated": term.clone(), "truncated": trunc.clone(),
            "window": 32})
        rewards.append(r)
    faults, _ = FL.replay(rec, ENV, "cpu")
    return sum(faults.values()), torch.stack(rewards)


def _spec(kind, row, x, y, d, lc, rc):
    """(spec, actions, upstream's success step, 1-based) of a case at this
    pose, or None where the pose does not suit the kind."""
    left = int(lc[0])
    dl, dr = obj_desc(lc), obj_desc(rc)
    if kind == "goto":
        return L.single(L.leaf(I.GOTO, dl)), [LEFT], 1
    if kind == "open":
        if left != C.DOOR or int(lc[2]) != C.CLOSED:
            return None
        return L.single(L.leaf(I.OPEN, dl)), [LEFT, TOGGLE], 2
    if kind == "pickup":
        if left == C.DOOR:
            return None
        return L.single(L.leaf(I.PICKUP, dl)), [LEFT, PICKUP], 2
    if kind == "putnext":
        # carry the left object to the empty front cell, next to the object
        # beyond it
        fx, fy = x + DIRS[d][0], y + DIRS[d][1]
        g = layouts().grid[row]
        W, H = g.shape[:2]
        bx, by = fx + DIRS[d][0], fy + DIRS[d][1]
        if left == C.DOOR or int(g[fx, fy, 0]) != C.EMPTY or not (
                0 <= bx < W and 0 <= by < H):
            return None
        beyond = g[bx, by]
        if int(beyond[0]) not in (C.BOX, C.BALL, C.DOOR):
            return None
        return (L.single(L.leaf(I.PUTNEXT, dl, obj_desc(beyond))),
                [LEFT, PICKUP, RIGHT, DROP], 4)
    if kind == "and":
        return (L.and_instr(L.leaf(I.GOTO, dl), L.leaf(I.GOTO, dr)),
                [LEFT, RIGHT, RIGHT], 3)
    if kind == "before":
        # "go to <right>, then go to <left>": facing the left one first
        # does nothing
        return (L.before_instr([L.leaf(I.GOTO, dr)], [L.leaf(I.GOTO, dl)]),
                [LEFT, RIGHT, RIGHT, LEFT, LEFT], 5)
    if kind == "after":
        # "go to <left> after you go to <right>"
        return (L.after_instr([L.leaf(I.GOTO, dl)], [L.leaf(I.GOTO, dr)]),
                [LEFT, RIGHT, RIGHT, LEFT, LEFT], 5)
    if kind == "left":
        return L.single(L.leaf(I.GOTO, obj_desc(lc, loc=0))), [LEFT], 1
    if kind == "pickup, then pickup":
        # "pick up the <left>, then pick up a <its type>": upstream's second
        # pickup, called first on the step the first one picks the object
        # up, finds preCarrying None and succeeds at step 2; the JAX
        # package's pre_empty starts false, so the port (and the reference,
        # which follows the JAX package here) needs the object dropped and
        # picked up again: step 4
        if left == C.DOOR:
            return None
        return (L.before_instr([L.leaf(I.PICKUP, dl)],
                               [L.leaf(I.PICKUP, L.desc(dl[0]))]),
                [LEFT, PICKUP, DROP, PICKUP], 4)
    raise ValueError(kind)


def _valid(row, pose, spec):
    """Whether the case is a BossLevel layout: the port validates its
    instruction and the reference finds no fault (the agent outside the
    locked room, among others)."""
    try:
        _, st = build([(row, pose, spec)])
    except AssertionError:
        return False
    return int(FL.family(ENV).layout_faults(core(st)).sum()) == 0


def _case_of(kind):
    """(layout, pose, spec, actions, upstream's success step) of one
    hand-built case."""
    for row in range(layouts().batch_size):
        for x, y, d, lc, rc in _poses(layouts(), row):
            got = _spec(kind, row, x, y, d, lc, rc)
            if got is not None and _valid(row, (x, y, d), got[0]):
                return (row, (x, y, d)) + got
    raise AssertionError(f"no layout holds a {kind} case")


KINDS = ("goto", "open", "pickup", "putnext", "and", "before", "after",
         "left", "pickup, then pickup")


@functools.lru_cache(maxsize=None)
def cases():
    return tuple(_case_of(k) for k in KINDS)


def run_cases(step_count=0):
    cs = cases()
    obs, st = build([c[:3] for c in cs], step_count)
    T = max(len(c[3]) for c in cs) + 1
    actions = [[c[3][t] if t < len(c[3]) else DONE for c in cs]
               for t in range(T)]
    return follow(obs, st, actions)


def test_hand_built_cases_succeed_where_upstream_does():
    mismatches, rewards = run_cases()
    assert mismatches == 0
    for k, (kind, c) in enumerate(zip(KINDS, cases())):
        won = torch.nonzero(rewards[:, k] > 0)[:, 0].tolist()
        assert won[:1] == [c[4] - 1], (kind, won)


def test_location_words_match_as_upstream():
    """The agent at (10, 10) facing east in the middle room (7..14): the
    ball at (12, 10) is in front, (8, 10) behind, (10, 8) on the left (the
    north, for an agent facing east), (10, 12) on the right; the ball at
    (16, 10), in the next room, matches no location word."""
    W = H = 22
    grid = torch.zeros((1, W, H, 5), dtype=torch.uint8)
    grid[..., 0] = C.EMPTY
    balls = {"front": (12, 10), "behind": (8, 10), "left": (10, 8),
             "right": (10, 12), "outside": (16, 10)}
    for x, y in balls.values():
        grid[0, x, y, :2] = torch.tensor([C.BALL, 0])
    pos = torch.tensor([[10, 10]], dtype=torch.int32)
    d = torch.zeros(1, dtype=torch.int32)
    want = {0: "left", 1: "right", 2: "front", 3: "behind"}
    rect = port_env().layout.room_rect_mask(1, 1)
    for loc, name in want.items():
        t = torch.tensor([[1]])
        port = I.match_mask(grid, pos, d, rect, t, torch.tensor([[0]]),
                            torch.tensor([[loc]]))[0, 0]
        ref = LG.match(grid, pos, d, torch.tensor([[C.BALL]]),
                       torch.tensor([[0]]), torch.tensor([[loc]]), 8)[0, 0]
        cells = {tuple(c) for c in torch.nonzero(ref).tolist()}
        assert cells == {balls[name]}, (name, cells)
        assert torch.equal(port, ref), name


def test_train_steps_follow_the_reference():
    """Three checked train steps of ``make_train_step(resets="fresh")`` at
    B=64, T=16 with the benchmark's seeded weights, each env staggered
    below its own budget, followed step by step: every env answer exact,
    the first gradient to rounding (the learner's later gaps swing more at
    this size than at the cell's, where its limits were set)."""
    from harness.manifest import Bench
    from harness.runner import Run

    bench = Bench(BENCH.parent)
    cell = bench.cell(CELL)
    run = Run(bench=bench, cell=cell, seed=2**31 + 29, seconds=0.0,
              trace=False, device="cpu", t_start=time.perf_counter(),
              sizes={"ppo": {"num_envs": 64, "rollout_len": 16}})
    driver = bench.driver(cell["driver"]).make(run)
    driver.setup()
    budgets = [LG.budget(m.navs(), 8, 3, 3) for m in LG.parse_tokens(
        driver.rec["start"]["state"]["mission"], ENV["vocabulary"])]
    assert (driver.rec["start"]["state"]["step_count"]
            < torch.tensor(budgets)).all()
    driver.release()
    got = driver.readings()
    limits = cell["workload"]["limits"]
    assert got["env_mismatches"] == 0
    assert got["grad_gap"] <= limits["grad_gap"]


def test_before_verified_as_and_is_caught(monkeypatch):
    inner = I.verify

    def as_and(params, instr, prev, new, action, use_done_actions=False):
        before = instr.root_kind == I.ROOT_BEFORE
        status, out = inner(params, instr.replace(root_kind=torch.where(
            before, I.ROOT_AND, instr.root_kind)), prev, new, action,
            use_done_actions)
        return status, out.replace(root_kind=instr.root_kind)

    monkeypatch.setattr(I, "verify", as_and)
    mismatches, _ = run_cases()
    assert mismatches > 0


def test_the_batchs_largest_budget_is_caught(monkeypatch):
    """Every case one step before the smallest budget (576): the one-leaf
    cases truncate there, on their own budget."""
    inner = L.RoomGridLevel._max_steps_value

    def largest(self, instr):
        v = inner(self, instr)
        return torch.full_like(v, int(v.max()))

    assert run_cases(575)[0] == 0
    monkeypatch.setattr(L.RoomGridLevel, "_max_steps_value", largest)
    assert run_cases(575)[0] > 0


def test_spans_of_generation_nest_under_gen_and_count():
    """``gen.layout``, ``gen.instr`` and ``gen.validate`` open under
    ``gen``; ``gen.levels`` counts the levels asked of ``generate`` and
    ``gen.attempts`` the attempts it returned."""
    from minigrid_tpu_torch.utils import trace

    env = port_env()
    trace.clear()
    trace.enable()
    try:
        env.reset(env.generator(3), 8)
    finally:
        trace.disable()
    recs = [r for r in trace.records() if r.name.startswith("gen")]
    name = {r.id: r.name for r in recs}
    assert {(r.name, name.get(r.parent)) for r in recs} == {
        ("gen", None), ("gen.layout", "gen"), ("gen.instr", "gen"),
        ("gen.validate", "gen")}
    trace.clear()
    before = trace.counters()
    _, _, took = env.generate(env.generator(4), 16)
    after = trace.counters()
    levels = after["gen.levels"] - before["gen.levels"]
    attempts = after["gen.attempts"] - before["gen.attempts"]
    assert levels == 16
    assert attempts == int(took.sum()) >= levels
    assert trace.records() == []


def test_a_site_off_costs_nothing_measurable():
    from minigrid_tpu_torch.utils import trace

    n = 20000
    t0 = time.perf_counter()
    for _ in range(n):
        with trace.span("gen.instr"):
            pass
    per = (time.perf_counter() - t0) / n
    assert trace.records() == []
    assert per < 5e-6, per
