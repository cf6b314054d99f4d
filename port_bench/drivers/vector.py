"""Driver of the ``env.vector(n)`` cells: the README's quick start in a
closed loop, as a user who brings a learner of their own steps it.

Set-up makes the env and ``reset, step = env.vector(n)``, resets the batch
from the seed and staggers its step counts below the episode budget (so
episodes end at a steady rate, not in batch-wide waves), then warms the
loop. Each step of the window draws uniform random actions and step keys on
the card from the benchmark's own generator, calls ``step`` (the regen
auto-reset: a fresh layout batch every step), and reads on the host the
step's count of ended episodes and its summed reward, as an
episode-statistics logger does; the step's latency runs from the call to
that read. A sample of the window's steps, drawn from the seed (reservoir
sampling), is kept for the check: the state before, the actions and what
the step returned, copied outside the timed span into slots allocated in
set-up, so the window allocates nothing the program does not.
"""

from __future__ import annotations

import math
import random
import sys
import time

import torch

from harness import counts as CT
from harness import trace as TR
from reference import follow as FL

STREAM_SALT = 0xB0A7_5EED   # the benchmark's draws: a stream of their own


def make(run):
    return VectorLoop(run)


def _fields(state) -> dict:
    return {k: getattr(state, k) for k in FL.STATE_KEYS}


def _sample(before, a, out) -> dict:
    """What a sampled step keeps: the state before, the actions and the
    step's results."""
    obs, st, reward, term, trunc = out[:5]
    return {"before": before, "action": a,
            "state": _fields(st),
            "obs": obs["packed"], "reward": reward, "terminated": term,
            "truncated": trunc}


def _copy_into(slot: dict, src: dict):
    for k, v in src.items():
        if isinstance(v, dict):
            _copy_into(slot[k], v)
        else:
            slot[k].copy_(v)


class VectorLoop:
    # the control judges the steps of a (short) window at the cell's load
    CONTROL_WINDOW = True

    def __init__(self, run):
        self.run = run
        self.cfg = run.cell["config"]
        self.traffic = run.cell["traffic"]
        self.limits = run.cell["workload"]["limits"]

    def setup(self):
        import minigrid_tpu_torch as mt

        run, dev = self.run, self.run.device
        envc = self.cfg["env"]
        self.B = run.param("traffic", "num_envs")
        env = mt.make(envc["id"], device=dev)
        if envc["packed_obs"]:
            env = env.packed()
        self.env = env
        self.A = self.cfg["policy"]["num_actions"]
        self.reset, self.vstep = env.vector(self.B)
        self.g = env.generator(run.seed)
        self.draws = torch.Generator(device=dev).manual_seed(
            run.seed ^ STREAM_SALT)
        obs, st = self.reset(self.g)
        st = st.replace(step_count=torch.randint(
            0, envc["max_steps"], (self.B,), generator=self.draws,
            device=dev, dtype=torch.int32))
        self.start = {"state": {k: v.cpu() for k, v in _fields(st).items()},
                      "obs": obs["packed"].cpu()}
        self.st = st
        for _ in range(self.traffic["warm_steps"]):
            before = _fields(self.st)
            _, a, out, _ = self._step()
        # the sample slots, and one copy into each: the window allocates none
        first = _sample(before, a, out)
        self.slots = [self._new_slot(first)
                      for _ in range(self.traffic["sampled_steps"])]

    def _new_slot(self, like: dict) -> dict:
        slot = {k: (self._new_slot(v) if isinstance(v, dict)
                    else torch.empty_like(v)) for k, v in like.items()}
        _copy_into(slot, like)
        return slot

    def _step(self):
        """One step of the loop: (seconds from the call to the host read,
        actions, the step's results, the host read)."""
        keys = torch.randint(-2**31, 2**31, (self.B, 2), generator=self.draws,
                             device=self.run.device, dtype=torch.int32)
        a = torch.randint(0, self.A, (self.B,), generator=self.draws,
                          device=self.run.device, dtype=torch.int32)
        t0 = time.perf_counter()
        out = self.vstep(keys, self.st, a, self.g)
        done = out[3] | out[4]
        read = torch.stack([done.sum().to(torch.float32),
                            out[2].sum()]).tolist()
        lat = time.perf_counter() - t0
        self.st = out[1]
        return lat, a, out, read

    def window(self, seconds):
        run = self.run
        keep = self.traffic["sampled_steps"]
        pick = random.Random(run.seed)
        lat = []
        ended = rewards = 0.0
        bad = 0
        run.sync()
        t0 = time.perf_counter()
        n = 0
        reads = []
        while n == 0 or time.perf_counter() - t0 < seconds:
            slot = n if n < keep else pick.randrange(n + 1)
            if slot < keep:
                before = _fields(self.st)
            secs, a, out, read = self._step()
            lat.append(secs)
            ended += read[0]
            rewards += read[1]
            bad += not all(math.isfinite(x) for x in read)
            if slot < keep:
                _copy_into(self.slots[slot], _sample(before, a, out))
                if slot < len(reads):
                    reads[slot] = (int(read[0]), read[1])
                else:
                    reads.append((int(read[0]), read[1]))
            n += 1
        run.sync()
        secs = time.perf_counter() - t0
        self.samples = [dict(s, host_read=r)
                        for s, r in zip(self.slots, reads)]
        run.window.update(attempted=n, failed=bad, seconds=secs, steps=n,
                          env_steps=n * self.B, latencies=lat,
                          episodes_ended=ended, reward_sum=rewards)

    def profile(self):
        run = self.run
        k = self.traffic["profiled_steps"]
        observed = []

        def steps():
            for _ in range(k):
                _, _, out, _ = self._step()
                observed.append((out[1].agent_pos, out[1].agent_dir))

        summary = TR.profile(steps, run.sync, run.device.startswith("cuda"))
        envc = self.cfg["env"]
        W = H = envc["size"]
        V = envc["view_size"]
        run.counters["profiled_env_steps"] = k
        run.counters["env_contract_bytes"] = k * self.B * CT.env_step_bytes(
            W, H, V) + sum(CT.observe_read_bytes(W, H, V, p, d)
                           for p, d in observed)
        return summary

    def release(self):
        self.env = self.reset = self.vstep = self.st = None

    def readings(self, reward=None):
        """The compared number: what in the sampled steps and in the start
        differs from the reference; with ``reward`` the reference's reward
        computed in that dtype is put in the program's place (the
        control)."""
        dev = self.run.device
        faults = FL.Counter()
        FL.check_start(self.start, self.cfg["env"], dev, faults)
        dtype = {None: torch.float32, "bfloat16": torch.bfloat16}[reward]
        faults.update(FL.check_regen_steps(self.samples, self.cfg["env"], dev,
                                           dtype))
        for what, count in sorted(faults.items()):
            if count:
                print(f"mismatch: {what}: {count}", file=sys.stderr)
        wins = sum(int((s["reward"] > 0).sum()) for s in self.samples)
        print(f"checked {len(self.samples)} sampled steps of "
              f"{self.run.window['steps']}; {wins} rewarded env-steps among "
              "them", file=sys.stderr)
        return {"env_mismatches": sum(faults.values())}

    def controls(self) -> dict:
        """Readings for setting the limit: the program's, and the
        control's (the reference's reward in bfloat16 in the program's
        place)."""
        return {"program": self.readings(),
                "control_bf16_reward": self.readings(reward="bfloat16")}

    def check(self):
        return {k: {"value": v, "limit": self.limits[k]}
                for k, v in self.readings().items()}
