"""The reference against the port's CPU path at a tiny size, and the
controls: the reference one precision below the stated one, in the
program's place, fails the limits the cells hold."""

import pytest
import torch

from bench_test_util import ROOT, TINY, run_tiny

from harness.control import readings
from harness.manifest import Bench
from reference import follow as FL
from reference import minigrid as M


def limits(cell):
    return Bench(ROOT).cell(cell)["workload"]["limits"]


@pytest.mark.parametrize("cell", sorted(TINY))
def test_the_port_agrees_with_the_reference(cell):
    """Every env answer exactly, and the first gradient to rounding. (The
    learner's later gaps swing more at a test's size than at the cell's:
    its limits hold on the card, where they were set.)"""
    out = run_tiny(cell, seed=2**31 + 17)
    checks = out["checks"]
    assert checks["env_mismatches"]["value"] == 0
    if "grad_gap" in checks:
        assert checks["grad_gap"]["value"] <= checks["grad_gap"]["limit"]
    else:
        assert out["correct"], checks


@pytest.mark.parametrize("cell", ["doorkey8x8.train_pooled",
                                  "putnextlocal.train_fresh"])
def test_train_control_and_half_batch_fail(cell):
    """The control and the half-batch fault each fail one of the cell's
    limits, and read well above the program at the same size."""
    lim = limits(cell)
    torch.set_num_threads(2)
    got = readings(ROOT, cell, 5, 0.0, "cpu", TINY[cell])
    assert got["program"]["env_mismatches"] == 0
    for name in ("control_fp8", "fault_half_batch"):
        assert any(got[name][k] > lim[k] for k in lim), (name, got[name])
        assert any(got[name][k] > 3 * got["program"][k] for k in lim
                   if k != "env_mismatches"), (name, got)


def _winning_step(dtype):
    """A step of the port's CPU vector env in which every agent stands
    before the goal and moves onto it, judged with the reference's reward
    computed in ``dtype``."""
    import minigrid_tpu_torch as mt

    env = mt.make("MiniGrid-DoorKey-8x8-v0", device="cpu").packed()
    B = 16
    reset, step = env.vector(B)
    g = env.generator(0)
    _, st = reset(g)
    # the goal is at (6, 6): put each agent at (6, 5) facing down, on the
    # goal's side of the wall, at varied step counts
    grid = st.grid.clone()
    grid[:, 6, 5] = torch.tensor([1, 0, 0, 0, 0], dtype=torch.uint8)
    st = st.replace(grid=grid,
                    agent_pos=torch.tensor([[6, 5]] * B, dtype=torch.int32),
                    agent_dir=torch.ones(B, dtype=torch.int32),
                    step_count=torch.arange(3, 3 + 37 * B, 37,
                                            dtype=torch.int32))
    before = {k: getattr(st, k).clone() for k in FL.STATE_KEYS}
    a = torch.full((B,), M.FORWARD, dtype=torch.int32)
    keys = torch.zeros((B, 2), dtype=torch.int32)
    obs, st2, r, term, trunc, _ = step(keys, st, a, g)
    assert bool((r > 0).all())
    sample = {"before": before, "action": a,
              "state": {k: getattr(st2, k) for k in FL.STATE_KEYS},
              "obs": obs["packed"], "reward": r, "terminated": term,
              "truncated": trunc,
              "host_read": (int((term | trunc).sum()), float(r.sum()))}
    cfg = Bench(ROOT).cell("doorkey8x8.vector_regen")["config"]["env"]
    faults = FL.check_regen_steps([sample], cfg, "cpu", dtype)
    return faults


def test_vector_control_fails_where_an_episode_is_won():
    assert sum(_winning_step(torch.float32).values()) == 0
    faults = _winning_step(torch.bfloat16)
    assert faults["rewards"] > 0


def test_reference_visibility_hides_what_walls_hide():
    # light goes round a lone wall cell, but not through a row of walls
    V = 7
    cells = torch.zeros((1, V, V, 5), dtype=torch.uint8)
    cells[..., 0] = M.EMPTY
    cells[0, V // 2, V - 2, 0] = M.WALL
    assert M.process_vis(cells).all()
    cells[0, :, V - 2, 0] = M.WALL
    vis = M.process_vis(cells)
    assert vis[0, :, V - 2:].all() and not vis[0, :, :V - 2].any()
    cells[0, 1, V - 2] = torch.tensor([M.DOOR, 0, M.OPEN, 0, 0])
    assert M.process_vis(cells)[0, :, :V - 2].any()


def test_putnext_reference_follows_the_bots_episodes():
    """The port's PutNextLocal stepped by the BabyAI bot to success, judged
    step by step by the reference level: the verifier fires where the
    reference's does, with the same reward, state and observation."""
    import minigrid_tpu_torch as mt
    from minigrid_tpu_torch.utils.baby_ai_bot import BabyAIBot, host_state

    env = mt.make("BabyAI-PutNextLocal-v0", device="cpu").packed()
    B = 12
    obs, st = env.reset(env.generator(4), B)
    bots = [BabyAIBot(env) for _ in range(B)]
    cfg = Bench(ROOT).cell("putnextlocal.train_fresh")["config"]["env"]
    fam = FL.family(cfg)
    assert int(FL.family(cfg).layout_faults(
        {k: getattr(st, k) for k in FL.STATE_KEYS}).sum()) == 0
    keys = torch.zeros((B, 2), dtype=torch.int32)
    running = torch.ones(B, dtype=torch.bool)
    wins = 0
    for _ in range(128):
        host = host_state(st)
        a = torch.tensor([bots[b].replan(host, b) if running[b] else 0
                          for b in range(B)], dtype=torch.int32)
        before = {k: getattr(st, k) for k in FL.STATE_KEYS}
        obs, st, r, term, trunc, _ = env.step(keys, st, a)
        new, rr, tt, tr = fam.step(before, a)
        got = {k: getattr(st, k) for k in FL.STATE_KEYS}
        live = running.clone()
        assert torch.equal(rr[live], r[live])
        assert torch.equal(tt[live], term[live])
        assert torch.equal(tr[live], trunc[live])
        assert not FL._env_differs(got, new)[live].any()
        assert torch.equal(M.observe(new, 7)[live], obs["packed"][live])
        wins += int((r[live] > 0).sum())
        running &= ~(term | trunc)
        if not running.any():
            break
    assert wins >= B // 2, wins
