#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``minigrid_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. the card (name, power limit) and the kernel build (ptxas report);
2. the fused step kernel against its plain PyTorch version on the card,
   bit-exact on every output, for every case below (another view size and
   every group width G among them);
3. the main path through the public entry points: DoorKey-8x8 with packed
   observations, a 1024-entry layout pool, 4096 staggered envs, the bf16
   ActorCritic and one 128-step pooled rollout, with the kernel's launch
   count read before and after; then a small rollout replayed through the
   plain path on the CPU;
4. timings: the rollout, pure packed stepping, and the kernel's device
   time per launch (profiler) at T=1 and T=128 for B=4096 and at T=128 for
   B=65536, with the group width G chosen for each, beside its bound (the
   larger of the byte and the integer-operation bound) and the plain
   version's time (CUDA events).

The line before the last is the card as ``nvidia-smi`` reports it; the last
line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or outside
the repository, it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

ENV_ID = "MiniGrid-DoorKey-8x8-v0"
BATCH = 4096
POOL_SIZE = 1024
ROLLOUT_LEN = 128
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
# INT32 issue rate of an H100 SXM: 64 INT32 lanes per SM (Hopper
# architecture white paper) x 132 SMs x the 1.98 GHz boost clock that the
# data sheet's 67 TFLOP/s of fp32 implies (67e12 / (132 SMs * 128 lanes * 2))
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` on the card, by CUDA events,
    after one warm-up call."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, reps: int, kernel: str = "fused_step_kernel") -> float:
    """Mean device time of one launch of ``kernel`` over ``reps`` calls of
    ``fn``, from the profiler's CUDA activity (CUPTI): the kernel's own time,
    whatever the host spends around the launches. The profiler now and then
    drops one launch's record (seen once in 20 on an H100), so up to a
    tenth of them may be missing; fewer fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and kernel in e.name]
    if not reps - max(1, reps // 10) <= len(us) <= reps:
        raise AssertionError(f"profiled {len(us)} launches of {kernel}, "
                             f"expected {reps}")
    return sum(us) / len(us) / 1e3


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def launch_bytes(states, actions, outputs, reset_grid=None,
                 reset_scal=None) -> int:
    """Bytes the fused step must move: every input read once, every output
    written once (mission/rng are not touched by the kernel)."""
    new_states, obs, reward, term, trunc = outputs
    core = ("grid", "agent_pos", "agent_dir", "carrying", "step_count")
    moved = nbytes(*(getattr(states, k) for k in core), actions, obs, reward,
                   term, trunc)
    moved += nbytes(*(getattr(new_states, k) for k in core),
                    new_states.terminated, new_states.truncated)
    if reset_grid is not None:
        moved += nbytes(reset_grid, reset_scal)
    return moved


def step_ops(view_size: int) -> int:
    """Integer operations one env-step needs at least: a read and a
    transparency test per window cell, two operations per Kogge-Stone step
    (V rows, two sweeps of ceil(log2 V) steps), ~30 for the transition."""
    V = view_size
    return 2 * V * V + V * 2 * math.ceil(math.log2(V)) * 2 + 30


def bound_ms(nbytes_moved: int, env_steps: int, view_size: int):
    """(least time in ms, "bytes" or "operations"): the larger of the bytes
    over the HBM rate and the operations over the INT32 rate."""
    by_bytes = nbytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = env_steps * step_ops(view_size) / INT32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def compare(name, got, want) -> float:
    """Bit-exact comparison of the kernel's outputs with the plain
    version's; returns the largest absolute difference (0 when equal)."""
    import torch

    gs, *gt = got
    ws, *wt = want
    pairs = [(k, getattr(gs, k), getattr(ws, k))
             for k in ("grid", "agent_pos", "agent_dir", "carrying",
                       "step_count", "terminated", "truncated")]
    pairs += list(zip(("obs", "reward", "terminated_t", "truncated_t"),
                      gt, wt))
    err = 0.0
    for k, a, b in pairs:
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{name}: {k} {a.shape}/{a.dtype} vs "
                                 f"{b.shape}/{b.dtype}")
        diff = (a.double() - b.double()).abs().max().item()
        err = max(err, diff)
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: {k} differs from the plain "
                                 f"version (max abs {diff})")
    print(f"kernel == plain: {name} (max_abs_err {err})")
    return err


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import minigrid_tpu_torch as mt
    from minigrid_tpu_torch.models.actor_critic import (ActorCritic,
                                                        encode_obs,
                                                        init_params)
    from minigrid_tpu_torch.models.ppo import rollout, sample_rollout_noise
    from minigrid_tpu_torch.ops.fused_step import (
        GROUP_LANES, KERNEL, _fused_rollout_cuda, fused_rollout_reference,
        launch_geometry, sm_count)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {kind}")

    # --- 1. build -------------------------------------------------------
    t0 = time.perf_counter()
    KERNEL.library()
    print(f"kernel built in {time.perf_counter() - t0:.2f} s")
    for line in KERNEL.build_log.splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print("  " + line.strip())
    sms = sm_count(torch.device("cuda"))

    def geometry(B, W=8, H=8, V=7, group_lanes=None):
        geo = launch_geometry(B, W, H, V, sms, group_lanes)
        return (f"G={geo.group_lanes}, {geo.envs_per_block} envs x "
                f"{geo.blocks} blocks, {geo.threads} threads, "
                f"{geo.shared_memory_bytes} bytes of shared memory per "
                f"block, {geo.blocks * geo.threads / 32 / sms:.1f} warps "
                f"per SM")

    print(f"  {sms} SMs; DoorKey-8x8 B={BATCH}: {geometry(BATCH)}; "
          f"B=65536: {geometry(65536)}; DoorKey-16x16 B=1000: "
          f"{geometry(1000, 16, 16)}")

    # --- 2. kernel against plain version -------------------------------
    def check(name, env_id, B, T, hint=None, reset=False, native=False,
              view=None, group_lanes=None):
        env = mt.make(env_id, device="cuda").packed()
        if view is not None:
            env = env.replace_params(view_size=view)
        g = env.generator(SEED + 1)
        if reset:
            _, st = env.reset_staggered(g, B)
        else:
            _, st = env.reset(g, B)
        if hint == "interact":
            choice = torch.tensor([0, 1, 2, 2, 3, 4, 5, 5], device="cuda")
            actions = choice[torch.randint(0, 8, (T, B), generator=g,
                                           device="cuda")]
        else:
            actions = torch.randint(0, 7, (T, B), generator=g, device="cuda")
        actions = actions.to(torch.int32)
        rg = rs = None
        if reset:
            rows = env.make_pool(g, 64).rows(
                torch.randint(0, 64, (T,), generator=g, device="cuda"))
            rg, rs = rows.grid, rows.scal
        got = _fused_rollout_cuda(env.params, st, actions, native, rg, rs,
                                  group_lanes)
        torch.cuda.synchronize()
        want = fused_rollout_reference(env.params, st, actions, native, rg,
                                       rs)
        torch.cuda.synchronize()
        if reset:
            n_done = int((got[3] | got[4]).sum())
            print(f"  {name}: {n_done} resets selected over {T} steps")
        return compare(name, got, want)

    errs = [
        check("DoorKey-8x8 B=4096 T=64 pure", ENV_ID, BATCH, 64),
        check("Empty-8x8 B=4096 T=64 see-through native layout",
              "MiniGrid-Empty-8x8-v0", BATCH, 64, native=True),
        check("DoorKey-5x5 B=4096 T=64 interaction stream",
              "MiniGrid-DoorKey-5x5-v0", BATCH, 64, hint="interact"),
        check("DoorKey-8x8 ragged B=4000 T=32", ENV_ID, 4000, 32),
        check("DoorKey-8x8 B=4096 T=64 reset-row entry", ENV_ID, BATCH, 64,
              reset=True),
        check("DoorKey-16x16 B=1000 T=16 reset-row entry",
              "MiniGrid-DoorKey-16x16-v0", 1000, 16, hint="interact",
              reset=True),
        check("DoorKey-8x8 view size 9 B=4096 T=64 reset-row entry", ENV_ID,
              BATCH, 64, hint="interact", reset=True, view=9),
    ]
    for G in GROUP_LANES:  # every width, a ragged last block in each
        errs.append(check(f"DoorKey-8x8 G={G} B=1001 T=16 reset-row entry",
                          ENV_ID, 1001, 16, hint="interact", reset=True,
                          group_lanes=G))
    max_err = max(errs)

    # --- 3. the main path -----------------------------------------------
    env = mt.make(ENV_ID, device="cuda").packed()
    g = env.generator(SEED)
    pool = env.make_pool(g, POOL_SIZE)
    obs, st = env.reset_staggered(g, BATCH)
    model = init_params(ActorCritic(hidden=256, dtype=torch.bfloat16,
                                    device="cuda"), g)
    warm = sample_rollout_noise(g, pool, BATCH, 4, model.num_actions)
    st, obs, _ = rollout(model, env, st, obs, warm)       # cuBLAS warm-up
    noise = sample_rollout_noise(g, pool, BATCH, ROLLOUT_LEN,
                                 model.num_actions)
    torch.cuda.synchronize()
    KERNEL.launches = 0
    t0 = time.perf_counter()
    st, obs, traj = rollout(model, env, st, obs, noise)
    torch.cuda.synchronize()
    rollout_s = time.perf_counter() - t0
    launches = KERNEL.launches
    print(f"main path: {ROLLOUT_LEN}-step pooled rollout, B={BATCH}: "
          f"{launches} kernel launches")
    if launches != ROLLOUT_LEN:
        raise AssertionError(f"expected {ROLLOUT_LEN} kernel launches on the "
                             f"main path, counted {launches}")
    V = env.params.view_size
    assert traj.obs["img_feat"].shape == (ROLLOUT_LEN, BATCH, V * V * 24)
    assert traj.action.shape == (ROLLOUT_LEN, BATCH)
    for k in ("log_prob", "value", "reward"):
        x = getattr(traj, k)
        assert x.shape == (ROLLOUT_LEN, BATCH) and torch.isfinite(x).all(), k
    assert int(traj.obs["img_feat"].sum(-1).min()) == V * V * 3
    assert ((traj.reward >= 0) & (traj.reward <= 1)).all()
    n_done = int(traj.done.sum())
    assert n_done > 0, "no episode ended in the rollout"
    assert ((obs["packed"] >> 9) == 0).all()
    print(f"  {n_done} episodes ended, {int((traj.reward > 0).sum())} "
          f"reached the goal; outputs finite and in range")

    # a small rollout on the card, replayed through the plain path on the
    # CPU with the actions the card took: observations, rewards and dones
    # exact, the f32 policy's values and log-probs within 1e-4 (the two
    # devices sum the matmuls in different orders)
    sm_env = mt.make(ENV_ID, device="cuda").packed()
    sg = sm_env.generator(SEED + 2)
    sm_pool = sm_env.make_pool(sg, 32)
    sm_obs, sm_st = sm_env.reset_staggered(sg, 64)
    f32 = init_params(ActorCritic(dtype=torch.float32, device="cuda"), sg)
    sm_noise = sample_rollout_noise(sg, sm_pool, 64, 16, f32.num_actions)
    _, _, sm_traj = rollout(f32, sm_env, sm_st, sm_obs, sm_noise)
    cpu_env = mt.make(ENV_ID, device="cpu").packed()
    cpu_model = ActorCritic(dtype=torch.float32, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               f32.state_dict().items()})
    st_c = sm_st.map(lambda x: x.cpu())
    obs_c = {k: v.cpu() for k, v in sm_obs.items()}
    from minigrid_tpu_torch.models.actor_critic import mission_counts
    counts = mission_counts(obs_c["mission"])
    rows = sm_noise.reset_rows
    for t in range(16):
        enc = encode_obs({"packed": obs_c["packed"], "direction":
                          obs_c["direction"], "mission_counts": counts})
        for k, v in enc.items():
            if not torch.equal(v, sm_traj.obs[k][t].cpu()):
                raise AssertionError(f"replay step {t}: obs {k} differs")
        logits, value = cpu_model(enc)
        lp = torch.log_softmax(logits, -1).gather(
            -1, sm_traj.action[t].cpu().long()[:, None])[:, 0]
        torch.testing.assert_close(value, sm_traj.value[t].cpu(), rtol=0,
                                   atol=1e-4)
        torch.testing.assert_close(lp, sm_traj.log_prob[t].cpu(), rtol=0,
                                   atol=1e-4)
        row = rows.rows(t)
        obs_c, st_c, r, te, tr, _ = cpu_env.step_autoreset_presampled(
            sm_noise.step_keys[t].cpu(), st_c, sm_traj.action[t].cpu(),
            row.to("cpu"))
        if not (torch.equal(r, sm_traj.reward[t].cpu())
                and torch.equal(te | tr, sm_traj.done[t].cpu())):
            raise AssertionError(f"replay step {t}: reward/done differ")
        counts = torch.where((te | tr)[:, None],
                             mission_counts(row.mission.cpu()), counts)
    print("small rollout (B=64, T=16, f32) on the card == replay through "
          "the plain path on the CPU")

    # --- 4. timings -----------------------------------------------------
    rollout_rate = BATCH * ROLLOUT_LEN / rollout_s
    print(f"rollout: {rollout_rate:.0f} env-steps/s (B={BATCH}, "
          f"T={ROLLOUT_LEN}, bf16 ActorCritic, pooled resets; host clock; "
          f"{card})")

    _, st0 = env.reset(g, BATCH)
    rows1 = pool.rows(0)
    a1 = torch.randint(0, 7, (1, BATCH), generator=g, device="cuda",
                       dtype=torch.int32)
    p = env.params
    run1 = lambda: _fused_rollout_cuda(p, st0, a1, False, rows1.grid,
                                       rows1.scal)
    plain1 = lambda: fused_rollout_reference(p, st0, a1, False, rows1.grid,
                                             rows1.scal)
    ms1 = device_ms(run1, 200)
    call_ms1 = cuda_ms(run1, 200)
    plain_ms1 = cuda_ms(plain1, 10)
    bound1, by1 = bound_ms(
        launch_bytes(st0, a1, run1(), rows1.grid, rows1.scal), BATCH, V)

    a128 = torch.randint(0, 7, (128, BATCH), generator=g, device="cuda",
                         dtype=torch.int32)
    run128 = lambda: _fused_rollout_cuda(p, st0, a128, False, None, None)
    ms128 = device_ms(run128, 20)
    plain_ms128 = cuda_ms(
        lambda: fused_rollout_reference(p, st0, a128, False), 1)
    bound128, by128 = bound_ms(launch_bytes(st0, a128, run128()),
                               BATCH * 128, V)
    big = 65536
    _, st_big = env.reset(g, big)
    a_big = torch.randint(0, 7, (128, big), generator=g, device="cuda",
                          dtype=torch.int32)
    run_big = lambda: _fused_rollout_cuda(p, st_big, a_big, False, None,
                                          None)
    ms_big = device_ms(run_big, 5)
    bound_big, by_big = bound_ms(launch_bytes(st_big, a_big, run_big()),
                                 big * 128, V)
    del st_big, a_big
    groups = {f"t1_b{BATCH}": launch_geometry(BATCH, 8, 8, V, sms)
              .group_lanes,
              f"t128_b{BATCH}": launch_geometry(BATCH, 8, 8, V, sms)
              .group_lanes,
              f"t128_b{big}": launch_geometry(big, 8, 8, V, sms).group_lanes}
    print(f"kernel per launch, DoorKey-8x8, device time ({card}):")
    print(f"  B={BATCH} T=1 with reset row, G={groups[f't1_b{BATCH}']}: "
          f"{ms1 * 1e3:.2f} us (bound {bound1 * 1e3:.2f} us by {by1}, "
          f"plain version {plain_ms1 * 1e3:.1f} us; {call_ms1 * 1e3:.1f} "
          f"us per call back to back, host-bound)")
    print(f"  B={BATCH} T=128 pure, G={groups[f't128_b{BATCH}']}: "
          f"{ms128 * 1e3:.2f} us (bound {bound128 * 1e3:.2f} us by "
          f"{by128}, plain version {plain_ms128 * 1e3:.1f} us)")
    print(f"  B={big} T=128 pure, G={groups[f't128_b{big}']}: "
          f"{ms_big * 1e3:.2f} us (bound {bound_big * 1e3:.2f} us by "
          f"{by_big})")

    # pure packed stepping: one T=128 launch per chunk, the state carried
    # from chunk to chunk (host clock around the synchronised chunks)
    env_state = st0
    chunks = 10
    acts = [torch.randint(0, 7, (128, BATCH), generator=g, device="cuda",
                          dtype=torch.int32) for _ in range(chunks)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for a in acts:
        env_state, o, *_ = _fused_rollout_cuda(p, env_state, a, False, None,
                                               None)
    torch.cuda.synchronize()
    pure_rate = chunks * 128 * BATCH / (time.perf_counter() - t0)
    print(f"pure packed stepping: {pure_rate:.0f} env-steps/s (B={BATCH}, "
          f"T=128 per launch; {card})")

    kernels = [{
        "name": "fused_step",
        "route": "cuda",
        "source": "minigrid_tpu_torch/csrc/fused_step.cu",
        "replaces": "minigrid_tpu/ops/fused_step.py:58",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms1,
        "plain_ms": plain_ms1,
        "bound_ms": bound1,
        "bound_by": by1,
        "library_ms": None,
        "call_ms": call_ms1,
        "ms_t128": ms128,
        "plain_ms_t128": plain_ms128,
        "bound_ms_t128": bound128,
        "ms_t128_b65536": ms_big,
        "bound_ms_t128_b65536": bound_big,
        "group_lanes": groups,
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
