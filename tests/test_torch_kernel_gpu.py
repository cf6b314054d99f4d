"""The CUDA fused step kernel and its observe entry against their plain
PyTorch versions on the card, bit-exact on every output, the BabyAI
post-step kernel and the fresh select kernel against their plain versions,
the recurrent policy's forward
card against CPU, the WFC solver card against CPU, and the rollout's policy
step as a CUDA graph replay against its eager run.
Marked ``gpu``: they skip without a CUDA device. The file imports no JAX,
so it also runs where only PyTorch is installed (``pytest
tests/test_torch_kernel_gpu.py -m gpu --noconftest``)."""

from __future__ import annotations

import dataclasses
import gc

import numpy as np
import pytest
import torch

import minigrid_tpu_torch
from minigrid_tpu_torch.envs.babyai.core import level as L
from minigrid_tpu_torch.envs.babyai.core import post_step as PS
from minigrid_tpu_torch.envs import base as EB
from minigrid_tpu_torch.envs.base import random_keys
from minigrid_tpu_torch.models import ppo as P
from minigrid_tpu_torch.models.actor_critic import (ActorCritic,
                                                    ActorCriticRNN,
                                                    init_params,
                                                    init_params_rnn)
from minigrid_tpu_torch.models import policy_step as PST
from minigrid_tpu_torch.models.policy_step import POLICY
from minigrid_tpu_torch.ops.fused_step import (GROUP_LANES,
                                               _fused_observe_cuda,
                                               _fused_rollout_cuda,
                                               fused_observe,
                                               fused_observe_reference,
                                               fused_rollout,
                                               fused_rollout_reference,
                                               launch_geometry, sm_count)
from minigrid_tpu_torch.ops import fresh_select as FS
from minigrid_tpu_torch.ops.native import COUNTERS
from minigrid_tpu_torch.utils import trace

# interaction-biased action stream of tests/test_fused_step.py
INTERACT = np.array([0, 1, 2, 2, 3, 4, 5, 5], np.int32)


@pytest.fixture
def cuda_device():
    """The card; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("env_id,kind,B,reset,skip", [
    ("MiniGrid-DoorKey-8x8-v0", "uniform", 4096, False, 0),
    ("MiniGrid-Empty-8x8-v0", "uniform", 4096, False, 0),
    ("MiniGrid-DoorKey-5x5-v0", "interact", 4096, False, 0),
    ("MiniGrid-DoorKey-8x8-v0", "uniform", 4000, False, 0),
    ("MiniGrid-DoorKey-8x8-v0", "uniform", 4096, True, 0),
    ("MiniGrid-DoorKey-16x16-v0", "interact", 1000, True, 0),
    # 25x25 (32 envs a block at G=8), 16x8 (W != H), see-through walls
    ("MiniGrid-MultiRoom-N6-v0", "interact", 4096, False, 0),
    ("MiniGrid-MultiRoom-N6-v0", "interact", 1000, True, 0),
    ("MiniGrid-RedBlueDoors-8x8-v0", "interact", 4096, True, 0),
    ("MiniGrid-Fetch-8x8-N3-v0", "interact", 4096, False, 0),
    ("MiniGrid-Dynamic-Obstacles-16x16-v0", "uniform", 1000, True, 0),
    ("MiniGrid-LavaCrossingS11N5-v0", "uniform", 4096, True, 0),
    # BabyAI's 3x3 maze of 8-rooms (22x22) and ObstructedMaze-Full (16x16),
    # the step entry without a row (their hook path)
    ("BabyAI-BossLevel-v0", "uniform", 4096, False, 0),
    ("BabyAI-BossLevel-v0", "interact", 1001, False, 0),
    ("MiniGrid-ObstructedMaze-Full-v0", "interact", 4096, False, 0),
    # WFC's 25x25 layouts, with the pooled row (no step hooks)
    ("MiniGrid-WFC-ObstaclesAngular-v0", "interact", 1024, True, 0),
    # grids of W*H*5 bytes that are no multiple of 16: 5x5 with the row,
    # 9x9, 19x19
    ("MiniGrid-Empty-5x5-v0", "interact", 4096, True, 0),
    ("MiniGrid-LavaCrossingS9N2-v0", "interact", 4096, True, 0),
    ("MiniGrid-FourRooms-v0", "interact", 1001, True, 0),
    # a grid input that starts off a 16-byte boundary: envs skip.. of a
    # contiguous batch, whose run offsets differ from the output's
    ("MiniGrid-MultiRoom-N6-v0", "interact", 1001, True, 1),
    ("BabyAI-BossLevel-v0", "interact", 4096, False, 1),
    ("MiniGrid-LavaCrossingS9N2-v0", "uniform", 1001, True, 3),
])
def test_kernel_matches_plain_on_card(cuda_device, env_id, kind, B, reset,
                                      skip):
    _check_case(cuda_device, env_id, kind, B, reset, skip=skip)


@pytest.mark.gpu
@pytest.mark.parametrize("view,group_lanes", [(21, None), (31, 2), (7, 1)])
def test_kernel_25x25_view_sizes_on_card(cuda_device, view, group_lanes):
    """MultiRoom's 25x25 where one warp of G=1 envs does not fit the
    shared memory (a view of 21 or more: the picked G widens) and where
    it does."""
    env = minigrid_tpu_torch.make("MiniGrid-MultiRoom-N6-v0",
                                  device=cuda_device).packed()
    env = env.replace_params(view_size=view)
    _check_case(cuda_device, env, "interact", 1001, True, group_lanes)


@pytest.mark.gpu
@pytest.mark.parametrize("view,B,reset,group_lanes", [
    (3, 4096, False, None),
    (9, 4096, False, None),
    (9, 1001, True, None),
    (7, 4100, True, None),
    *[(7, 1001, True, g) for g in GROUP_LANES],
])
def test_kernel_view_sizes_and_group_widths_on_card(cuda_device, view, B,
                                                    reset, group_lanes):
    """DoorKey-8x8 at other view sizes, at batches that are not a multiple
    of the envs per block, and at every group width G."""
    env = minigrid_tpu_torch.make("MiniGrid-DoorKey-8x8-v0",
                                  device=cuda_device).packed()
    env = env.replace_params(view_size=view)
    if B != 4096:  # a ragged last block
        geo = launch_geometry(B, 8, 8, view, sm_count(cuda_device),
                              group_lanes)
        assert B % geo.envs_per_block != 0
    _check_case(cuda_device, env, "interact", B, reset, group_lanes)


@pytest.mark.gpu
@pytest.mark.parametrize("env_id,view,B,reset,group_lanes", [
    ("MiniGrid-DoorKey-8x8-v0", 33, 1024, True, None),
    ("MiniGrid-DoorKey-8x8-v0", 63, 1001, False, None),
    ("MiniGrid-MultiRoom-N6-v0", 63, 1024, True, None),
    ("MiniGrid-MultiRoom-N6-v0", 33, 1001, False, 32),
    *[("MiniGrid-DoorKey-8x8-v0", 49, 1001, True, g)
      for g in GROUP_LANES[2:]],
])
def test_kernel_64_bit_rows_on_card(cuda_device, env_id, view, B, reset,
                                    group_lanes):
    """Views of 33-63 (64-bit view rows): both entries against the plain
    versions, bit-exact, on 8x8 and 25x25 grids, ragged blocks and the G
    that fit."""
    env = minigrid_tpu_torch.make(env_id, device=cuda_device).packed()
    env = env.replace_params(view_size=view)
    _check_case(cuda_device, env, "interact", B, reset, group_lanes)
    _, st = env.reset(env.generator(5), B)
    got = (fused_observe(env.params, st) if group_lanes is None else
           _fused_observe_cuda(env.params, st, group_lanes))
    assert torch.equal(got, fused_observe_reference(env.params, st))


@pytest.mark.gpu
def test_recurrent_forward_card_matches_cpu(cuda_device):
    """ActorCriticRNN in float32 on the card against the same parameters
    on the CPU, on DoorKey-8x8 observations from a nonzero hidden state:
    logits, value and the new hidden within 1e-5 (the devices sum the
    matmuls in different orders); bf16 on the card gives finite outputs
    in its dtype."""
    from minigrid_tpu_torch.models.actor_critic import (ActorCriticRNN,
                                                        init_params_rnn)

    env = minigrid_tpu_torch.make("MiniGrid-DoorKey-8x8-v0",
                                  device=cuda_device).packed()
    g = env.generator(0)
    obs, _ = env.reset_staggered(g, 1024)
    card = init_params_rnn(ActorCriticRNN(dtype=torch.float32,
                                          device=cuda_device), g)
    cpu = ActorCriticRNN(dtype=torch.float32, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    h = torch.randn((1024, card.hidden), generator=g, device=cuda_device)
    with torch.no_grad():
        (lc, vc), hc = card(obs, h)
        (lp, vp), hp = cpu({k: v.cpu() for k, v in obs.items()}, h.cpu())
    for got, want in ((lc, lp), (vc, vp), (hc, hp)):
        assert (got.cpu() - want).abs().max().item() <= 1e-5
    bf = ActorCriticRNN(device=cuda_device)
    with torch.no_grad():
        (lb, vb), hb = bf(obs, bf.initial_state(1024))
    assert hb.dtype == torch.bfloat16 and lb.dtype == torch.float32
    assert torch.isfinite(lb).all() and torch.isfinite(vb).all()


def _check_case(device, env, kind, B, reset, group_lanes=None, T=32,
                skip=0):
    """One launch of the kernel against the plain version, bit-exact; with
    ``skip``, on the contiguous view of envs ``skip..`` of a batch of
    ``B + skip``, whose grid does not start on a 16-byte boundary."""
    if isinstance(env, str):
        env = minigrid_tpu_torch.make(env, device=device).packed()
    g = env.generator(0)
    _, st = (env.reset_staggered if reset else env.reset)(g, B + skip)
    if skip:
        st = st.map(lambda t: t[skip:])
        assert st.grid.is_contiguous() and st.grid.data_ptr() % 16 != 0
    rng = np.random.default_rng(1)
    choices = INTERACT if kind == "interact" else np.arange(7)
    actions = torch.from_numpy(choices[rng.integers(0, len(choices), (T, B))]
                               .astype(np.int32)).to(device)
    rg = rs = None
    if reset:
        rows = env.make_pool(g, 64).rows(
            torch.randint(0, 64, (T,), generator=g, device=device))
        rg, rs = rows.grid, rows.scal
    launches = COUNTERS.launches
    if group_lanes is None:
        got = fused_rollout(env.params, st, actions, False, rg, rs)
    else:
        got = _fused_rollout_cuda(env.params, st, actions, False, rg, rs,
                                  group_lanes)
    torch.cuda.synchronize()
    assert COUNTERS.launches == launches + 1
    want = fused_rollout_reference(env.params, st, actions, False, rg, rs)
    for k, v in want[0].tensors().items():
        assert torch.equal(got[0].tensors()[k], v), k
    for name, a, b in zip(("obs", "reward", "term", "trunc"), got[1:],
                          want[1:]):
        assert torch.equal(a, b), name


@pytest.mark.gpu
@pytest.mark.parametrize("view,B,group_lanes", [
    (3, 4096, None), (7, 4096, None), (9, 4096, None), (9, 1001, None),
    *[(7, 1001, g) for g in GROUP_LANES]])
def test_observe_entry_matches_plain_on_card(cuda_device, view, B,
                                             group_lanes):
    """The observe entry on DoorKey-8x8 states after 16 interaction steps
    (doors opened, keys carried), at view sizes 3/7/9 and every G."""
    env = minigrid_tpu_torch.make("MiniGrid-DoorKey-8x8-v0",
                                  device=cuda_device).packed()
    env = env.replace_params(view_size=view)
    _, st = env.reset(env.generator(0), B)
    rng = np.random.default_rng(2)
    actions = torch.from_numpy(INTERACT[rng.integers(0, 8, (16, B))]).to(
        cuda_device)
    st = fused_rollout(env.params, st, actions)[0]
    launches = COUNTERS.observe_launches
    got = (fused_observe(env.params, st) if group_lanes is None else
           _fused_observe_cuda(env.params, st, group_lanes))
    torch.cuda.synchronize()
    assert COUNTERS.observe_launches == launches + 1
    assert torch.equal(got, fused_observe_reference(env.params, st))
    assert (st.carrying[:, 0] != 1).any()


@pytest.mark.gpu
@pytest.mark.parametrize("env_id,view", [
    ("MiniGrid-MultiRoom-N6-v0", None),
    ("MiniGrid-RedBlueDoors-8x8-v0", None),
    ("MiniGrid-GoToDoor-8x8-v0", None),
    ("BabyAI-BossLevel-v0", None),
    ("MiniGrid-ObstructedMaze-Full-v0", None),
    ("MiniGrid-DoorKey-5x5-v0", None),
    ("MiniGrid-WFC-MazeSimple-v0", None),
    ("MiniGrid-DoorKey-8x8-v0", 33),
    ("MiniGrid-MultiRoom-N6-v0", 63),
])
def test_observe_entry_other_shapes_on_card(cuda_device, env_id, view):
    """The observe entry, which reads each env's window from device
    memory, on the grids of other shapes (25x25, 16x8, 22x22, 16x16, 5x5)
    and at views of 33 and 63: one launch a call, bit-exact."""
    env = minigrid_tpu_torch.make(env_id, device=cuda_device).packed()
    if view is not None:
        env = env.replace_params(view_size=view)
    _, st = env.reset(env.generator(3), 2048)
    rng = np.random.default_rng(4)
    actions = torch.from_numpy(INTERACT[rng.integers(0, 8, (16, 2048))]).to(
        cuda_device)
    st = fused_rollout(env.params, st, actions)[0]
    launches = COUNTERS.observe_launches
    got = fused_observe(env.params, st)
    torch.cuda.synchronize()
    assert COUNTERS.observe_launches == launches + 1
    assert torch.equal(got, fused_observe_reference(env.params, st))


# BabyAI levels: every leaf and root kind, the 22x22 maze
LEVEL_IDS = ["BabyAI-GoToObj-v0", "BabyAI-PutNextLocal-v0",
             "BabyAI-OpenDoorsOrderN4-v0", "BabyAI-SynthSeq-v0",
             "BabyAI-BossLevel-v0"]
HOOK_IDS = ["MiniGrid-MemoryS13Random-v0", "MiniGrid-RedBlueDoors-8x8-v0",
            "MiniGrid-GoToObject-8x8-N2-v0", "MiniGrid-Fetch-8x8-N3-v0",
            "MiniGrid-GoToDoor-8x8-v0", "MiniGrid-PutNear-8x8-N3-v0",
            "MiniGrid-Dynamic-Obstacles-16x16-v0", "MiniGrid-Unlock-v0",
            "MiniGrid-KeyCorridorS3R3-v0", "MiniGrid-ObstructedMaze-2Dlh-v0"]


@pytest.mark.gpu
@pytest.mark.parametrize("env_id", HOOK_IDS + LEVEL_IDS)
def test_hook_step_on_card_matches_cpu(cuda_device, env_id):
    """A hook family's step and pooled auto-reset on the card (hooks in
    PyTorch around the step entry; the row selected, then observed) equal
    the same steps on the CPU, ``extra`` included, with one step launch a
    step and one observe launch a pooled step; a BabyAI level's verifier
    replaces the state, so its steps are observed too."""
    env = minigrid_tpu_torch.make(env_id, device=cuda_device).packed()
    cpu = minigrid_tpu_torch.make(env_id, device="cpu").packed()
    g = env.generator(5)
    B, T = 512, 12
    _, st = env.reset(g, B)
    level = env_id in LEVEL_IDS
    ms = st.extra["max_steps"] if level else env.params.max_steps
    st = st.replace(step_count=(ms - 1 - torch.arange(B, device=cuda_device)
                                % T).to(torch.int32))
    st_c = st.map(lambda x: x.cpu())
    pool = env.make_pool(g, 16)
    counts = COUNTERS.launches, COUNTERS.observe_launches
    for t in range(T):
        keys = random_keys(g, (B, 2), cuda_device)
        a = torch.randint(0, 7, (B,), generator=g, device=cuda_device,
                          dtype=torch.int32)
        if t % 2 == 0:
            out = env.step(keys, st, a)
            ref = cpu.step(keys.cpu(), st_c, a.cpu())
        else:
            row = pool.rows(t % 16)
            out = env.step_autoreset_presampled(keys, st, a, row)
            ref = cpu.step_autoreset_presampled(keys.cpu(), st_c, a.cpu(),
                                                row.to("cpu"))
        assert torch.equal(out[0]["packed"].cpu(), ref[0]["packed"])
        for k, v in ref[1].tensors().items():
            assert torch.equal(out[1].tensors()[k].cpu(), v), (t, k)
        for x, y in zip(out[2:5], ref[2:5]):
            assert torch.equal(x.cpu(), y)
        st, st_c = out[1], ref[1]
    torch.cuda.synchronize()
    assert (COUNTERS.launches - counts[0],
            COUNTERS.observe_launches - counts[1]) == (T, T if level
                                                     else T // 2)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["regen", "independent", "fresh"])
def test_reset_modes_step_then_observe_on_card(cuda_device, mode):
    """Each three-stage reset launches the step entry once and the observe
    entry once per step, and the observation it returns is the plain
    observation of the state it returns."""
    env = minigrid_tpu_torch.make("MiniGrid-DoorKey-8x8-v0",
                                  device=cuda_device).packed()
    g = env.generator(1)
    B = 512
    _, st = env.reset(g, B)
    st = st.replace(step_count=torch.full((B,), 639, dtype=torch.int32,
                                          device=cuda_device))
    keys = random_keys(g, (B, 2), cuda_device)
    a = torch.zeros((B,), dtype=torch.int32, device=cuda_device)
    counts = COUNTERS.launches, COUNTERS.observe_launches
    selects = COUNTERS.select_launches
    if mode == "regen":
        out = env.step_autoreset(keys, st, a, g)
    elif mode == "independent":
        out = env.step_autoreset_pooled(keys, st, a, env.make_pool(g, 64), g,
                                        independent=True)
    else:
        out = env.step_autoreset_fresh(
            keys, st, a, env.presample_fresh(g, 600),
            torch.zeros((), dtype=torch.int32, device=cuda_device), 512)
    torch.cuda.synchronize()
    assert (COUNTERS.launches, COUNTERS.observe_launches) == (counts[0] + 1,
                                                            counts[1] + 1)
    assert COUNTERS.select_launches == selects + (mode == "fresh")
    obs, new = out[0], out[1]
    assert out[4].all() and (new.step_count == 0).all()
    assert torch.equal(obs["packed"], fused_observe_reference(env.params,
                                                              new))


def _same(a, b):
    """Equal tensors, dicts or states of them across devices (NaN equals
    NaN)."""
    if hasattr(a, "tensors"):
        a, b = a.tensors(), b.tensors()
    if isinstance(a, dict):
        return set(a) == set(b) and all(_same(a[k], b[k]) for k in b)
    a, b = a.cpu(), b.cpu()
    return torch.equal(a, b) or (
        a.is_floating_point() and a.shape == b.shape
        and bool(((a == b) | (a.isnan() & b.isnan())).all()))


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [8, 32])
def test_frames_on_card_match_cpu(cuda_device, tile):
    """Full frames with and without the view cone and POV frames of
    DoorKey-8x8 states after interaction steps, on the card (the cone and
    POV cells from the observe entry, one launch each) and on the CPU."""
    from minigrid_tpu_torch.render import get_frame

    env = minigrid_tpu_torch.make("MiniGrid-DoorKey-8x8-v0",
                                  device=cuda_device).packed()
    g = env.generator(2)
    B = 1024
    _, st = env.reset(g, B)
    choice = torch.tensor(INTERACT, device=cuda_device)
    for _ in range(8):
        a = choice[torch.randint(0, 8, (B,), generator=g,
                                 device=cuda_device)]
        st = env.step(random_keys(g, (B, 2), cuda_device), st, a)[1]
    st_c = st.map(lambda x: x.cpu())
    o0 = COUNTERS.observe_launches
    for kw in ({}, {"highlight": False}, {"agent_pov": True}):
        got = get_frame(env.params, st, tile_size=tile, **kw)
        assert _same(got, get_frame(env.params, st_c, tile_size=tile, **kw))
    assert COUNTERS.observe_launches - o0 == 2


@pytest.mark.gpu
@pytest.mark.parametrize("stack", ["NoDeath", "ActionBonus(NoDeath)",
                                   "ImgObs"])
def test_wrapped_pooled_steps_on_card_match_cpu(cuda_device, stack):
    """A wrapper stack's pooled auto-reset on the card and on the CPU with
    the same keys, actions and rows: a transition or stateful stack takes
    the step entry without a row and the observe entry (the NoDeath lava
    cancel happens before the select), a stateless one the row entry."""
    from minigrid_tpu_torch import wrappers as W
    from minigrid_tpu_torch.envs.base import presample_reset_states

    def wrap(env):
        if stack == "ImgObs":
            return W.ImgObsWrapper(env)
        nd = W.NoDeath(env, no_death_types=("lava",), death_cost=-0.2)
        return W.ActionBonus(nd) if stack.startswith("Action") else nd

    env_id = "MiniGrid-LavaGapS5-v0"
    w = wrap(minigrid_tpu_torch.make(env_id, device=cuda_device).packed())
    wc = wrap(minigrid_tpu_torch.make(env_id, device="cpu").packed())
    g = w.generator(3)
    B, T = 1024, 16
    _, st = w.reset_staggered(g, B)
    st_c = st.map(lambda x: x.cpu())
    rows = presample_reset_states(g, w.make_pool(g, 64), T)
    counts = COUNTERS.launches, COUNTERS.observe_launches
    penalties = 0
    for t in range(T):
        keys = random_keys(g, (B, 2), cuda_device)
        a = torch.where(torch.rand((B,), generator=g, device=cuda_device)
                        < 0.7, 2, torch.randint(0, 7, (B,), generator=g,
                                                device=cuda_device))
        a = a.to(torch.int32)
        out = w.step_autoreset_presampled(keys, st, a, rows.rows(t))
        ref = wc.step_autoreset_presampled(keys.cpu(), st_c, a.cpu(),
                                           rows.rows(t).to("cpu"))
        for x, y in zip(out[:5], ref[:5]):
            assert _same(x, y), t
        st, st_c = out[1], ref[1]
        penalties += int((out[2] < 0).sum())
    observes = 0 if stack == "ImgObs" else T
    assert (COUNTERS.launches - counts[0],
            COUNTERS.observe_launches - counts[1]) == (T, observes)
    assert stack != "NoDeath" or penalties > 0


@pytest.mark.gpu
@pytest.mark.parametrize("preset,options", [
    ("MazeSimple", {"loc_heuristic": "spiral", "choice_heuristic": "lexical"}),
    ("ObstaclesAngular", {}),
    ("ObstaclesBlackdots", {"backtracking": True,
                            "global_constraint": "allpatterns"})])
def test_wfc_solver_on_card_matches_cpu(cuda_device, preset, options):
    """The WFC solver from the same keys on the card and on the CPU (its
    draws are hashes of the keys): grids and ``ok`` bit-exact, and the
    layouts built from them."""
    from minigrid_tpu_torch.core import constants as C
    from minigrid_tpu_torch.envs.wfc import WFCEnv
    from minigrid_tpu_torch.envs.wfc import solver as S

    env = WFCEnv(wfc_config=preset, size=14, device=cuda_device)
    cpu_env = WFCEnv(wfc_config=preset, size=14, device="cpu")
    keys = random_keys(env.generator(0), (32, 2), cuda_device)
    args = (env._adj, env._weights, (12, 12), env.config.output_periodic)
    grid, ok = S.solve(keys, *args, **options)
    grid_c, ok_c = S.solve(keys.cpu(), *args, **options)
    assert torch.equal(grid.cpu(), grid_c) and torch.equal(ok.cpu(), ok_c)
    st = env.layout(env.generator(1), grid)
    st_c = cpu_env.layout(cpu_env.generator(1), grid_c)
    assert torch.equal(st.grid.cpu()[..., 0] == C.WALL,
                       st_c.grid[..., 0] == C.WALL)


# tests/test_torch_babyai.py's STEP_LEVELS: every root kind and leaf kind,
# strict failures and a carried start
VERIFY_LEVELS = ["BabyAI-GoToObj-v0", "BabyAI-OpenDoorsOrderN4-v0",
                 "BabyAI-PutNextLocal-v0", "BabyAI-GoToSeq-v0",
                 "BabyAI-SynthSeq-v0", "BabyAI-PickupDistDebug-v0",
                 "BabyAI-PutNextS5N2Carrying-v0"]
_LEVEL_BATCHES: dict = {}


@pytest.mark.gpu
@pytest.mark.parametrize("done_actions", [False, True])
@pytest.mark.parametrize("B", [4096, 1000])
@pytest.mark.parametrize("env_id", VERIFY_LEVELS)
def test_babyai_post_step_kernel_matches_plain_on_card(
        cuda_device, env_id, B, done_actions, monkeypatch):
    """64 uniform then 64 interaction-biased pooled steps of a level on the
    card, each post-step computed by the kernel and by its plain version
    (``I.verify`` and the reward arithmetic) on the same CUDA inputs:
    status, reward (its bits), terminated, truncated and every InstrState
    field equal; the inputs unchanged after the launch; one kernel launch
    a step; episodes ending by the verifier and by the budget."""
    monkeypatch.setattr(L, "USE_DONE_ACTIONS", done_actions)
    env = minigrid_tpu_torch.make(env_id, device=cuda_device).packed()
    if (env_id, B) not in _LEVEL_BATCHES:
        g = env.generator(7)
        _LEVEL_BATCHES[env_id, B] = env.reset(g, B)[1], env.make_pool(g, 16)
    st, pool = _LEVEL_BATCHES[env_id, B]
    ms = st.extra["max_steps"]
    st = st.replace(step_count=(ms - 1 - torch.arange(B, device=cuda_device)
                                % ms).to(torch.int32))
    kernel = PS._babyai_post_step_cuda
    ended = [0, 0]

    def checked(params, prev, new, action, reward, terminated, mode):
        inputs = PS._inputs(prev, new, action, reward, terminated)
        before = [t.clone() for t in inputs]
        got = kernel(params, prev, new, action, reward, terminated, mode)
        want = PS.babyai_post_step_reference(params, prev, new, action,
                                             reward, terminated, mode)
        assert mode == done_actions
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[2].view(torch.int32),
                           want[2].view(torch.int32))
        assert torch.equal(got[3], want[3]) and torch.equal(got[4], want[4])
        for k, v in want[1].items():
            assert torch.equal(got[1].get(k, prev.extra[k]), v), k
        for t, c in zip(inputs, before):
            assert torch.equal(t, c)
        ended[0] += int((got[0] != 0).sum())
        ended[1] += int(got[4].sum())
        return got

    monkeypatch.setattr(PS, "_babyai_post_step_cuda", checked)
    g = env.generator(8)
    launches = COUNTERS.verify_launches
    T = 64
    for t in range(2 * T):
        keys = random_keys(g, (B, 2), cuda_device)
        if t < T:
            a = torch.randint(0, 7, (B,), generator=g, device=cuda_device)
        else:
            a = torch.from_numpy(INTERACT).to(cuda_device)[torch.randint(
                0, len(INTERACT), (B,), generator=g, device=cuda_device)]
        st = env.step_autoreset_presampled(keys, st, a.to(torch.int32),
                                           pool.rows(t % 16))[1]
    torch.cuda.synchronize()
    assert COUNTERS.verify_launches - launches == 2 * T
    assert ended[0] > 0 and ended[1] > 0, ended


# the fresh select's states: DoorKey-8x8's 9 tensors, a BabyAI level's 28
# (masks (8, H) at H=8 and 22); B=1000 leaves the outputs of every other
# call off a 16-byte boundary (the kernel's byte path)
SELECT_CASES = [("MiniGrid-DoorKey-8x8-v0", 64), ("MiniGrid-DoorKey-8x8-v0",
                                                  4096),
                ("MiniGrid-DoorKey-8x8-v0", 1000),
                ("BabyAI-PutNextLocal-v0", 64), ("BabyAI-PutNextLocal-v0",
                                                 4096),
                ("BabyAI-BossLevel-v0", 64), ("BabyAI-BossLevel-v0", 4096)]


@pytest.mark.gpu
@pytest.mark.parametrize("env_id,B", SELECT_CASES)
def test_fresh_select_kernel_matches_plain_on_card(cuda_device, env_id, B):
    """The fresh select kernel against its plain version
    (``fresh_candidates`` then ``select_reset_states``) on the same CUDA
    inputs, bit for bit: every tensor of the state, ``reset_overflow`` and
    the cursor. Windows 1, 32 and n_buf; cursors 0, past n_buf - window and
    past n_buf; no env done, every env, a random third; a whole batch and a
    stub ``finishers`` with fixed device offset and total. The inputs are
    left as they were, and ``kernel.select_launches`` counts one a call;
    the fresh step's routing takes the kernel."""
    env = minigrid_tpu_torch.make(env_id, device=cuda_device).packed()
    g = env.generator(11)
    _, st = env.reset(g, B)
    st = st.replace(step_count=torch.randint(0, 64, (B,), generator=g,
                                             device=cuda_device,
                                             dtype=torch.int32))
    n_buf = 2 * B if B < 1000 else 600
    buffer = env.presample_fresh(g, n_buf)
    keys = random_keys(g, (B, 2), cuda_device)
    i32 = torch.int32
    stub = (torch.tensor(7, dtype=i32, device=cuda_device),
            torch.tensor(B + 20, dtype=i32, device=cuda_device))
    inputs = [keys, *st.tensors().values(), *buffer.tensors().values()]
    before = [t.clone() for t in inputs]
    calls, launches = 0, trace.counters()["kernel.select_launches"]
    for window in (1, 32, n_buf):
        for cursor in (0, n_buf - window + 5, n_buf + 3):
            cursor = torch.tensor(cursor, dtype=i32, device=cuda_device)
            for done in (torch.zeros(B, dtype=torch.bool, device=cuda_device),
                         torch.ones(B, dtype=torch.bool, device=cuda_device),
                         torch.rand(B, generator=g, device=cuda_device) < 1 / 3):
                for finishers in (None, lambda count: stub):
                    got = FS.fresh_select_cuda(keys, done, st, buffer, cursor,
                                               window, finishers,
                                               EB._SALT_WORDS)
                    calls += 1
                    cand, overflow, new_cursor = EB.fresh_candidates(
                        keys, done, buffer, cursor, window, finishers)
                    want = EB.select_reset_states(done, st, cand)
                    where = (window, int(cursor), int(done.sum()),
                             finishers is not None)
                    assert _same(got[0], want), where
                    assert got[1].dtype == got[2].dtype == i32
                    assert (int(got[1]), int(got[2])) == (
                        int(overflow), int(new_cursor)), where
    torch.cuda.synchronize()
    assert trace.counters()["kernel.select_launches"] - launches == calls
    for t, c in zip(inputs, before):
        assert torch.equal(t, c)
    done = torch.ones(B, dtype=torch.bool, device=cuda_device)
    obs, new, info, cursor = EB._fresh_select(
        env, keys, st, done, buffer, torch.zeros((), dtype=i32,
                                                 device=cuda_device), 32)
    assert COUNTERS.select_launches - launches == calls + 1
    assert int(cursor) == B and int(info["reset_overflow"]) == B - 32


# (env id, reset mode) of the graphed rollout's cases: the benchmark's
# pooled DoorKey and fresh PutNextLocal cells
GRAPH_CASES = [("MiniGrid-DoorKey-8x8-v0", "pooled"),
               ("BabyAI-PutNextLocal-v0", "fresh")]


def _rollout_case(device, env_id, resets, B=4096, seed=0):
    """(env, generator, bf16 ActorCritic(256), pool, state, obs, fresh
    buffer rows) as the benchmark's cells build them."""
    env = minigrid_tpu_torch.make(env_id, device=device).packed()
    g = env.generator(seed)
    model = init_params(ActorCritic(device=device), g)
    pool = env.make_pool(g, 1024) if resets == "pooled" else None
    obs, st = env.reset_staggered(g, B)
    n_buf = int(B * 1.3) + 256 if resets == "fresh" else None
    return env, g, model, pool, st, obs, n_buf


def _ran(before: dict) -> dict:
    return {k: getattr(POLICY, k) - v for k, v in before.items()}


def _graphed_and_eager(monkeypatch, model, env, st, obs, g, pool, resets,
                       n_buf, T=128):
    """One rollout as the program runs it and the same rollout (state,
    noise, generator) with every policy step eager; returns both outputs
    and the counters' moves in the first."""
    noise = P.sample_rollout_noise(g, pool, st.batch_size, T,
                                   model.num_actions, device=st.device)
    start = g.get_state()
    before = dataclasses.asdict(POLICY)
    graphed = P.rollout(model, env, st.map(torch.clone), dict(obs), noise,
                        resets, g, n_buf)
    torch.cuda.synchronize()
    ran = _ran(before)
    g.set_state(start)
    with monkeypatch.context() as m:
        m.setattr(P, "graphed_policy", lambda *a: None)
        eager = P.rollout(model, env, st.map(torch.clone), dict(obs), noise,
                          resets, g, n_buf)
    return graphed, eager, ran


def _assert_same_rollout(got, want):
    (st, obs, traj, over), (st2, obs2, traj2, over2) = got, want
    for k in P.OBS_KEYS:
        assert torch.equal(traj.obs[k], traj2.obs[k]), k
    for k in ("action", "log_prob", "value", "reward", "done"):
        a, b = getattr(traj, k), getattr(traj2, k)
        assert a.dtype == b.dtype and torch.equal(a, b), k
    assert traj.hidden is None and torch.equal(over, over2)
    for k in obs:
        assert torch.equal(obs[k], obs2[k]), k
    for k, v in st2.tensors().items():
        assert torch.equal(st.tensors()[k], v), k


@pytest.mark.gpu
@pytest.mark.parametrize("env_id,resets", GRAPH_CASES)
def test_graphed_rollout_equals_eager_on_card(cuda_device, monkeypatch,
                                              env_id, resets):
    """At B=4096, T=128 the graphed rollout equals the eager one bit for
    bit (encodings, actions, log-probs, values, env results), one replay a
    step; after an Adam step the next rollout replays the same graph on
    the new weights and still equals the eager one; a ``load_state_dict``
    that reallocates the parameters, and a new batch, capture again; a
    dropped model frees its graph."""
    env, g, model, pool, st, obs, n_buf = _rollout_case(cuda_device, env_id,
                                                        resets)
    got, want, ran = _graphed_and_eager(monkeypatch, model, env, st, obs, g,
                                        pool, resets, n_buf)
    assert ran == {"graph_captures": 1, "graph_replays": 128,
                   "eager_steps": 0}
    _assert_same_rollout(got, want)

    opt = P.make_optimizer(model, P.PPOConfig())
    logits, value = model({k: v[0] for k, v in got[2].obs.items()})
    (logits.square().mean() + value.square().mean()).backward()
    weights = model.trunk1.weight.detach().clone()
    opt.step()
    assert not torch.equal(weights, model.trunk1.weight)
    st, obs = got[0], got[1]
    got, want, ran = _graphed_and_eager(monkeypatch, model, env, st, obs, g,
                                        pool, resets, n_buf)
    assert ran == {"graph_captures": 0, "graph_replays": 128,
                   "eager_steps": 0}
    _assert_same_rollout(got, want)

    model.load_state_dict({k: v.clone() for k, v in
                           model.state_dict().items()}, assign=True)
    recaptured = {"graph_captures": 1, "graph_replays": 128,
                  "eager_steps": 0}
    got, want, ran = _graphed_and_eager(monkeypatch, model, env, got[0],
                                        got[1], g, pool, resets, n_buf)
    assert ran == recaptured
    _assert_same_rollout(got, want)
    _, g, _, pool, st, obs, n_buf = _rollout_case(cuda_device, env_id,
                                                  resets, B=1000, seed=1)
    got, want, ran = _graphed_and_eager(monkeypatch, model, env, st, obs, g,
                                        pool, resets, n_buf)
    assert ran == recaptured
    _assert_same_rollout(got, want)
    graphs = len(PST._GRAPHS)
    del model, opt
    gc.collect()
    assert len(PST._GRAPHS) == graphs - 1


class _Replicated:
    """A tensor-parallel marker over one rank: gathering is the identity."""

    @staticmethod
    def gather(x):
        return x


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["recurrent", "tensor_parallel"])
def test_policy_steps_eager_where_the_graph_does_not_apply(cuda_device,
                                                           kind):
    """A recurrent policy and a model with a tensor-parallel parameter step
    eagerly on the card: T eager steps, no capture, no replay."""
    env = minigrid_tpu_torch.make("MiniGrid-DoorKey-8x8-v0",
                                  device=cuda_device).packed()
    g = env.generator(0)
    pool = env.make_pool(g, 64)
    obs, st = env.reset_staggered(g, 1024)
    h = None
    if kind == "recurrent":
        model = init_params_rnn(ActorCriticRNN(device=cuda_device), g)
        h = model.initial_state(1024)
    else:
        model = init_params(ActorCritic(device=cuda_device), g)
        model.mission_embed.tensor_parallel = _Replicated()
    noise = P.sample_rollout_noise(g, pool, 1024, 16, model.num_actions)
    before = dataclasses.asdict(POLICY)
    out = P.rollout(model, env, st, obs, noise, h=h)
    torch.cuda.synchronize()
    assert _ran(before) == {"graph_captures": 0, "graph_replays": 0,
                            "eager_steps": 16}
    assert out[2].action.shape == (16, 1024)
