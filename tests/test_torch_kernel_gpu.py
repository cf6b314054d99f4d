"""The CUDA fused step kernel and its observe entry against their plain
PyTorch versions on the card, bit-exact on every output, the recurrent
policy's forward card against CPU, and the WFC solver card against CPU.
Marked ``gpu``: they skip without a CUDA device. The file imports no JAX,
so it also runs where only PyTorch is installed (``pytest
tests/test_torch_kernel_gpu.py -m gpu --noconftest``)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import minigrid_tpu_torch
from minigrid_tpu_torch.envs.base import random_keys
from minigrid_tpu_torch.ops.fused_step import (GROUP_LANES, KERNEL,
                                               _fused_observe_cuda,
                                               _fused_rollout_cuda,
                                               fused_observe,
                                               fused_observe_reference,
                                               fused_rollout,
                                               fused_rollout_reference,
                                               launch_geometry, sm_count)

# interaction-biased action stream of tests/test_fused_step.py
INTERACT = np.array([0, 1, 2, 2, 3, 4, 5, 5], np.int32)


@pytest.fixture
def cuda_device():
    """The card; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("env_id,kind,B,reset", [
    ("MiniGrid-DoorKey-8x8-v0", "uniform", 4096, False),
    ("MiniGrid-Empty-8x8-v0", "uniform", 4096, False),
    ("MiniGrid-DoorKey-5x5-v0", "interact", 4096, False),
    ("MiniGrid-DoorKey-8x8-v0", "uniform", 4000, False),
    ("MiniGrid-DoorKey-8x8-v0", "uniform", 4096, True),
    ("MiniGrid-DoorKey-16x16-v0", "interact", 1000, True),
    # 25x25 (32 envs a block at G=8), 16x8 (W != H), see-through walls
    ("MiniGrid-MultiRoom-N6-v0", "interact", 4096, False),
    ("MiniGrid-MultiRoom-N6-v0", "interact", 1000, True),
    ("MiniGrid-RedBlueDoors-8x8-v0", "interact", 4096, True),
    ("MiniGrid-Fetch-8x8-N3-v0", "interact", 4096, False),
    ("MiniGrid-Dynamic-Obstacles-16x16-v0", "uniform", 1000, True),
    ("MiniGrid-LavaCrossingS11N5-v0", "uniform", 4096, True),
    # BabyAI's 3x3 maze of 8-rooms (22x22) and ObstructedMaze-Full (16x16),
    # the step entry without a row (their hook path)
    ("BabyAI-BossLevel-v0", "uniform", 4096, False),
    ("BabyAI-BossLevel-v0", "interact", 1001, False),
    ("MiniGrid-ObstructedMaze-Full-v0", "interact", 4096, False),
    # WFC's 25x25 layouts, with the pooled row (no step hooks)
    ("MiniGrid-WFC-ObstaclesAngular-v0", "interact", 1024, True),
])
def test_kernel_matches_plain_on_card(cuda_device, env_id, kind, B, reset):
    _check_case(cuda_device, env_id, kind, B, reset)


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


def _check_case(device, env, kind, B, reset, group_lanes=None, T=32):
    """One launch of the kernel against the plain version, bit-exact."""
    if isinstance(env, str):
        env = minigrid_tpu_torch.make(env, device=device).packed()
    g = env.generator(0)
    _, st = (env.reset_staggered if reset else env.reset)(g, B)
    rng = np.random.default_rng(1)
    choices = INTERACT if kind == "interact" else np.arange(7)
    actions = torch.from_numpy(choices[rng.integers(0, len(choices), (T, B))]
                               .astype(np.int32)).to(device)
    rg = rs = None
    if reset:
        rows = env.make_pool(g, 64).rows(
            torch.randint(0, 64, (T,), generator=g, device=device))
        rg, rs = rows.grid, rows.scal
    launches = KERNEL.launches
    if group_lanes is None:
        got = fused_rollout(env.params, st, actions, False, rg, rs)
    else:
        got = _fused_rollout_cuda(env.params, st, actions, False, rg, rs,
                                  group_lanes)
    torch.cuda.synchronize()
    assert KERNEL.launches == launches + 1
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
    launches = KERNEL.observe_launches
    got = (fused_observe(env.params, st) if group_lanes is None else
           _fused_observe_cuda(env.params, st, group_lanes))
    torch.cuda.synchronize()
    assert KERNEL.observe_launches == launches + 1
    assert torch.equal(got, fused_observe_reference(env.params, st))
    assert (st.carrying[:, 0] != 1).any()


@pytest.mark.gpu
@pytest.mark.parametrize("env_id", ["MiniGrid-MultiRoom-N6-v0",
                                    "MiniGrid-RedBlueDoors-8x8-v0",
                                    "MiniGrid-GoToDoor-8x8-v0",
                                    "BabyAI-BossLevel-v0",
                                    "MiniGrid-ObstructedMaze-Full-v0"])
def test_observe_entry_other_shapes_on_card(cuda_device, env_id):
    env = minigrid_tpu_torch.make(env_id, device=cuda_device).packed()
    _, st = env.reset(env.generator(3), 2048)
    rng = np.random.default_rng(4)
    actions = torch.from_numpy(INTERACT[rng.integers(0, 8, (16, 2048))]).to(
        cuda_device)
    st = fused_rollout(env.params, st, actions)[0]
    assert torch.equal(fused_observe(env.params, st),
                       fused_observe_reference(env.params, st))


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
    counts = KERNEL.launches, KERNEL.observe_launches
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
    assert (KERNEL.launches - counts[0],
            KERNEL.observe_launches - counts[1]) == (T, T if level
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
    counts = KERNEL.launches, KERNEL.observe_launches
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
    assert (KERNEL.launches, KERNEL.observe_launches) == (counts[0] + 1,
                                                          counts[1] + 1)
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
    o0 = KERNEL.observe_launches
    for kw in ({}, {"highlight": False}, {"agent_pov": True}):
        got = get_frame(env.params, st, tile_size=tile, **kw)
        assert _same(got, get_frame(env.params, st_c, tile_size=tile, **kw))
    assert KERNEL.observe_launches - o0 == 2


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
    counts = KERNEL.launches, KERNEL.observe_launches
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
    assert (KERNEL.launches - counts[0],
            KERNEL.observe_launches - counts[1]) == (T, observes)
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
