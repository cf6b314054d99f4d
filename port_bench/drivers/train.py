"""Driver of the PPO train cells: the port's ``make_train_step`` in a closed
loop, as ``models/train.py::train`` runs it.

Set-up builds the env, the policy (the benchmark's own weights, drawn on
the card from the seed), Adam, the layout pool and the staggered batch,
then runs the cell's checked train steps through the very train step the
window drives, recording what the reference needs (see :class:`Recorder`);
those steps warm every shape. A pooled cell refreshes its pool after each
checked step, as ``train()`` calls ``refresh_layout_pool``, so that the
check holds each refreshed pool and the steps that draw from it. The
window calls the train step back to back, refreshes the pool every
``pool_refresh_every`` steps and reads the metrics on the host every
``log_every``, and ends with a synchronisation; the pool it ends with is
checked too. The traced run adds spans around the rollout, the update and
the pool refresh, then profiles ``profiled_steps`` more train steps.
"""

from __future__ import annotations

import math
import sys
import time

import torch

from harness import counts as CT
from harness import trace as TR
from reference import follow as FL
from reference import policy as P

WEIGHT_SALT = 0x5EED_0F_A11  # the benchmark's weights: a stream of its own


def make(run):
    return TrainLoop(run)


def _generator_syncs():
    """The RoomGrid generators' count of host syncs (a program counter that
    BabyAI's levels add to), or None where the program has none."""
    try:
        from minigrid_tpu_torch.core import roomgrid
    except ImportError:
        return None
    return getattr(getattr(roomgrid, "COUNTERS", None), "host_syncs", None)


def _core(state) -> dict:
    return {k: getattr(state, k).detach().cpu()
            for k in FL.STATE_KEYS}


def _pool(pool) -> dict:
    return {"grid": pool.grid.cpu(), "scal": pool.scal.cpu(),
            "mission": pool.mission.cpu()}


class Recorder:
    """What the checked train steps did, taken at the program's public
    seams and handed to the reference after the window: each pooled env
    step's actions, reset row and results (the env's
    ``step_autoreset_presampled``, which the rollout calls), the first
    timestep the update's forward saw in each minibatch (a forward hook on
    the policy, with gradients on), and the first gradient as the optimizer
    gets it (a step pre-hook). Everything is copied to the host."""

    def __init__(self, env, model, optimizer, num_envs: int, mode: str):
        self.env, self.B = env, num_envs
        self.steps, self.update_inputs, self.first_grads = [], [], None
        self.buffers = []
        self.names = [k for k, _ in model.named_parameters()]
        self.params = [p for _, p in model.named_parameters()]

        def record(actions, out, **more):
            obs, st, reward, term, trunc = out[:5]
            self.steps.append({
                "action": actions.detach().cpu(), "state": _core(st),
                "obs": obs["packed"].cpu(),
                "direction": obs["direction"].cpu(), "reward": reward.cpu(),
                "terminated": term.cpu(), "truncated": trunc.cpu(), **more})

        if mode == "regen":
            inner = env.step_autoreset

            def step(keys, states, actions, generator, layouts=None):
                out = inner(keys, states, actions, generator, layouts)
                record(actions, out)
                return out

            self.seams = {"step_autoreset": step}
        elif mode == "pooled":
            inner = env.step_autoreset_presampled

            def step(keys, states, actions, reset_row):
                out = inner(keys, states, actions, reset_row)
                record(actions, out, row={
                    "grid": reset_row.grid[0].cpu(),
                    "scal": reset_row.scal[0].cpu(),
                    "mission": reset_row.mission[0].cpu()})
                return out

            self.seams = {"step_autoreset_presampled": step}
        else:
            inner_step, inner_buffer = (env.step_autoreset_fresh,
                                        env.presample_fresh)

            def step(keys, states, actions, buffer, cursor, window=32,
                     finishers=None):
                out = inner_step(keys, states, actions, buffer, cursor,
                                 window, finishers)
                record(actions, out, window=int(window))
                return out

            def presample(generator, n):
                buffer = inner_buffer(generator, n)
                self.buffers.append(_core(buffer))
                return buffer

            self.seams = {"step_autoreset_fresh": step,
                          "presample_fresh": presample}
        for name, fn in self.seams.items():
            setattr(env, name, fn)
        self._hooks = [model.register_forward_hook(self._forward),
                       optimizer.register_step_pre_hook(self._optimizer)]

    def begin_train_step(self):
        self.update_inputs.append([])

    def _forward(self, module, args, output):
        if not torch.is_grad_enabled():
            return
        inp = args[0]
        feat = inp["img_feat"]
        self.update_inputs[-1].append({
            "img_feat": feat.reshape(-1, feat.shape[-1])[:self.B].cpu(),
            "direction": inp["direction"].reshape(-1)[:self.B].cpu()})

    def _optimizer(self, optimizer, args, kwargs):
        if self.first_grads is None:
            self.first_grads = {k: p.grad.detach().cpu().clone()
                                for k, p in zip(self.names, self.params)}

    def close(self):
        for name in self.seams:
            delattr(self.env, name)
        for h in self._hooks:
            h.remove()


class TrainLoop:
    # the control's readings follow the checked steps of set-up alone
    CONTROL_WINDOW = False

    def __init__(self, run):
        self.run = run
        self.cfg = run.cell["config"]
        self.traffic = run.cell["traffic"]
        self.limits = run.cell["workload"]["limits"]
        self.mode = self.traffic["resets"]
        if self.mode not in ("pooled", "fresh", "regen"):
            raise ValueError(f"resets {self.mode!r}: not a reset mode")

    def _ppo(self) -> dict:
        return {k: self.run.param("ppo", k) for k in self.cfg["ppo"]}

    def setup(self):
        import minigrid_tpu_torch as mt
        from minigrid_tpu_torch.models import ppo as PPO
        from minigrid_tpu_torch.models.actor_critic import ActorCritic

        run, dev = self.run, self.run.device
        envc, pol = self.cfg["env"], self.cfg["policy"]
        self.ppo = self._ppo()
        self.B, self.T = self.ppo["num_envs"], self.ppo["rollout_len"]
        env = mt.make(envc["id"], device=dev)
        if envc["packed_obs"]:
            env = env.packed()
        self.env = env
        pcfg = PPO.PPOConfig(**self.ppo)
        g = env.generator(run.seed)
        wg = torch.Generator(device=dev).manual_seed(run.seed ^ WEIGHT_SALT)
        self.weights0 = P.init_weights(pol, wg, dev)
        model = ActorCritic(view_size=pol["view_size"], hidden=pol["hidden"],
                            mission_dim=pol["mission_dim"],
                            num_actions=pol["num_actions"],
                            dtype=P.DTYPES[pol["trunk_dtype"]], device=dev)
        names = sorted(k for k, _ in model.named_parameters())
        if names != sorted(self.weights0):
            raise RuntimeError(f"the policy's parameters {names} are not "
                               f"the configuration's {list(self.weights0)}")
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(self.weights0[k])
        opt = PPO.make_optimizer(model, pcfg)
        pooled = self.mode == "pooled"
        pool = (env.make_pool(g, run.param("train", "pool_size")) if pooled
                else None)
        obs, st = env.reset_staggered(g, self.B)
        fresh_buffer = None
        if st.extra is not None and "max_steps" in st.extra:
            st, fresh_buffer = self._stagger_budget(st, g)
        step = PPO.make_train_step(env, model, pcfg, opt, resets=self.mode,
                                   fresh_buffer=fresh_buffer)

        self.refresh = mt.refresh_layout_pool
        rec = Recorder(env, model, opt, self.B, self.mode)
        start = {"state": _core(st), "obs": obs["packed"].cpu()}
        losses, pools = [], []
        try:
            for _ in range(self.traffic["checked_steps"]):
                rec.begin_train_step()
                st, obs, m = step(st, obs, g, pool)
                losses.append(float(m["loss"]))
                if pooled:
                    # pools[k] is the pool step k drew from; pools[k + 1]
                    # is its refresh
                    pools.append(_pool(pool))
                    pool = self.refresh(env, g, pool)
        finally:
            rec.close()
        self.rec = {"mode": self.mode, "start": start, "rollout_len": self.T,
                    "steps": rec.steps, "buffers": rec.buffers,
                    "update_inputs": rec.update_inputs, "losses": losses,
                    "first_grads": rec.first_grads,
                    "params": {k: p.detach().cpu().clone()
                               for k, p in model.named_parameters()}}
        if pooled:
            self.rec["pools"] = pools + [_pool(pool)]
        self.PPO, self.model, self.opt = PPO, model, opt
        self.step, self.g, self.pool = step, g, pool
        self.st, self.obs = st, obs
        run.counters["train_step_flops"] = CT.train_step_flops(
            pol, self.B, self.T, self.ppo["num_epochs"])

    def _stagger_budget(self, st, g):
        """A dynamic-budget batch (BabyAI's) staggered uniformly below its
        largest episode budget, and the fresh buffer's rows for it, ``int(B
        * T / budget * factor) + extra`` (the JAX bench's sizing,
        ``bench.py:281-284, 300``; ``chip_smoke.py::stagger_budget``). A
        fixed-budget env keeps ``reset_staggered``'s draw and the program's
        own buffer size, as ``train()`` runs it."""
        budget = int(st.extra["max_steps"].max())
        st = st.replace(step_count=torch.randint(
            0, budget, (self.B,), generator=g, device=st.device,
            dtype=torch.int32))
        rule = self.traffic.get("fresh_buffer")
        if rule is None:
            return st, None
        return st, int(self.B * self.T / budget * rule["factor"]) + rule[
            "extra"]

    def _train_steps(self, more, spans=None):
        """Train steps while ``more(n)`` (n done so far), refreshing the
        pool and reading the metrics on the train loop's schedule. Returns
        (steps, steps whose metrics read not finite, pool refreshes)."""
        every = (self.run.param("train", "pool_refresh_every")
                 if self.pool is not None else 0)
        log_every = self.run.param("train", "log_every")
        n = bad = refreshes = 0
        while more(n):
            self.st, self.obs, m = self.step(self.st, self.obs, self.g,
                                             self.pool)
            n += 1
            if self.pool is not None and n % every == 0:
                refreshes += 1
                if spans is None:
                    self.pool = self.refresh(self.env, self.g, self.pool)
                else:
                    with spans.span("pool_refresh"):
                        self.pool = self.refresh(self.env, self.g, self.pool)
            if n % log_every == 0:
                if not all(math.isfinite(float(v)) for v in m.values()):
                    bad += log_every
        self.last_metrics = m
        return n, bad, refreshes

    def _spanned(self, spans):
        """Put ``spans`` around the rollout and the update the train step
        calls (module attributes of ``models/ppo.py``, looked up at each
        call); returns the undo."""
        names = ("rollout", "ppo_update")
        missing = [n for n in names if not hasattr(self.PPO, n)]
        if missing:
            raise RuntimeError(
                f"models/ppo.py has no {', '.join(missing)}: the traced "
                "run's spans wrap them (port_bench/README.md lists the "
                "program's names the harness hooks)")
        inner = {n: getattr(self.PPO, n) for n in names}
        for n in names:
            setattr(self.PPO, n, spans.wrap(n.replace("ppo_", ""), inner[n]))

        def undo():
            for n in names:
                setattr(self.PPO, n, inner[n])
        return undo

    def window(self, seconds):
        run = self.run
        spans = run.spans
        undo = self._spanned(spans) if spans is not None else None
        syncs = _generator_syncs()
        try:
            run.sync()
            t0 = time.perf_counter()
            n, bad, refreshes = self._train_steps(
                lambda k: k == 0 or time.perf_counter() - t0 < seconds, spans)
            run.sync()
            secs = time.perf_counter() - t0
        finally:
            if undo is not None:
                undo()
        if refreshes:
            # the pool the window's last refresh made, for the check
            self.rec["window_pool"] = _pool(self.pool)
        if syncs is not None:
            run.counters["gen_host_syncs"] = _generator_syncs() - syncs
        final = [float(v) for v in self.last_metrics.values()]
        bad += 0 if all(math.isfinite(v) for v in final) else 1
        run.window.update(attempted=n, failed=min(bad, n), seconds=secs,
                          steps=n, env_steps=n * self.B * self.T)

    def profile(self):
        run = self.run
        k = self.traffic["profiled_steps"]
        undo = self._spanned(TR.Spans(run.sync))
        observed = []
        seam = {"fresh": "step_autoreset_fresh",
                "regen": "step_autoreset"}.get(self.mode)
        if seam is not None:
            # the states the observe entry looks at again, for its bytes
            inner = getattr(self.env, seam)

            def step(*args, **kwargs):
                out = inner(*args, **kwargs)
                observed.append((out[1].agent_pos, out[1].agent_dir))
                return out

            setattr(self.env, seam, step)
        try:
            summary = TR.profile(lambda: self._train_steps(lambda n: n < k),
                                 run.sync, run.device.startswith("cuda"))
        finally:
            undo()
            if seam is not None:
                delattr(self.env, seam)
        envc = self.cfg["env"]
        W = H = envc["size"]
        V = envc["view_size"]
        steps = k * self.T
        run.counters["profiled_rollout_steps"] = steps
        moved = steps * self.B * CT.env_step_bytes(W, H, V)
        if self.mode == "pooled":
            moved += steps * CT.reset_row_bytes(W, H)
        moved += sum(CT.observe_read_bytes(W, H, V, p, d)
                     for p, d in observed)
        run.counters["env_contract_bytes"] = moved
        return summary

    def release(self):
        for name in ("step", "model", "opt", "pool", "st", "obs", "env",
                     "last_metrics"):
            setattr(self, name, None)

    def readings(self, quant=None, half_batch=False):
        """The compared numbers: the program's run against the reference,
        or with ``quant``/``half_batch`` the reference so changed put in
        the program's place (the control and a fault)."""
        dev = self.run.device
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        faults, traj = FL.replay(self.rec, self.cfg["env"], dev)
        ref = FL.follow_learner(self.rec, traj, self.cfg["policy"], self.ppo,
                                self.weights0, dev)
        if quant or half_batch:
            prog = FL.follow_learner(self.rec, traj, self.cfg["policy"],
                                     self.ppo, self.weights0, dev,
                                     quant=quant, half_batch=half_batch)
        else:
            prog = self.rec
        gaps = FL.learner_gaps(prog, ref, self.weights0)
        faults["minibatch order"] += ref["order_faults"]
        for what, count in sorted(faults.items()):
            if count:
                print(f"mismatch: {what}: {count}", file=sys.stderr)
        if gaps["left_out"]:
            print("left out of the change (gradient nought to rounding): "
                  + ", ".join(gaps["left_out"]), file=sys.stderr)
        return {"env_mismatches": sum(faults.values()),
                "loss_gap": gaps["loss_gap"], "grad_gap": gaps["grad_gap"],
                "change_gap": gaps["change_gap"]}

    def controls(self) -> dict:
        """Readings for setting the limits: the program's, the control's
        (the reference in bfloat16's place at float8) and a fault's (each
        minibatch's loss over half of its envs)."""
        return {"program": self.readings(),
                "control_fp8": self.readings(quant="fp8"),
                "fault_half_batch": self.readings(half_batch=True)}

    def check(self):
        values = self.readings()
        return {k: {"value": v, "limit": self.limits[k]}
                for k, v in values.items()}

