"""The reference follows what the program's timed path did, and the
comparison that decides ``correct``.

The program's layouts come from its own generator, which the reference
cannot replay; so the reference follows the program step by step from the
program's own state: the batch it started from and the pool or fresh
layouts it drew are checked by themselves (each a valid layout of the
family, at the step counts the traffic sets), and from there every step is
the reference's own: the transition, the reward, the flags, the reset
select and the observation, compared with what the program produced. The
program's sampled actions and its minibatch order are draws, as a served
model's sampled tokens are: the reference takes them and judges the rest.

Training: the reference runs the learner over the same steps (its own
forward, GAE, loss, clip-norm and Adam from the benchmark's initial
weights) and compares each train step's loss, the norms of the first
gradient as the optimizer gets it, leaf by leaf, and of each leaf's change
over the followed steps.
"""

from __future__ import annotations

import importlib
import re
import statistics
from collections import Counter

import torch

from reference import minigrid as M
from reference import policy as P

STATE_KEYS = M.CORE + ("mission",)
NAME = re.compile(r"[a-z0-9_]+\Z")
# a leaf whose first gradient is under this share of the median leaf's
# moves under Adam by round-off alone and is left out of the change
TINY_GRADIENT = 1e-3


def _to(d: dict, device):
    return {k: v.to(device) for k, v in d.items()}


def _env_differs(got: dict, want: dict) -> torch.Tensor:
    """(B,) bool: envs in which any field of the two states differs."""
    bad = torch.zeros(want["agent_dir"].shape[0], dtype=torch.bool,
                      device=want["agent_dir"].device)
    for k in STATE_KEYS:
        g, w = got[k], want[k]
        bad |= (g.to(w.dtype) != w).reshape(w.shape[0], -1).any(1)
    return bad


def family(env: dict):
    """The reference semantics of the configuration's env family:
    ``reference/families/<family>.py``'s ``Family`` (its ``step``, its
    ``layout_faults`` and its ``max_steps``). The reference observes as
    upstream does by default, walls and closed doors blocking the view; a
    configuration that sees through walls is refused."""
    name = env["family"]
    if not NAME.match(name):
        raise ValueError(f"family {name!r} is not a name")
    if env["see_through_walls"]:
        raise ValueError("see_through_walls: the reference implements only "
                         "false")
    return importlib.import_module(f"reference.families.{name}").Family(env)


def check_pool(pool: dict, env: dict, faults: Counter, what: str,
               before: dict | None = None):
    """Count the pool's rows that are not a layout of the family at step 0
    with clear flags; with ``before``, the pool it was refreshed from, a
    refresh that kept most rows counts once: a sound refresh draws every
    row anew, and two draws of a family's layout seldom agree."""
    W = H = env["size"]
    P_ = pool["grid"].shape[0]
    check_layouts({
        "grid": M.unpack_cells(pool["grid"]).reshape(P_, W, H, 5),
        "agent_pos": pool["scal"][:, 0:2],
        "agent_dir": pool["scal"][:, 2],
        "carrying": M.unpack_cells(pool["scal"][:, 3]),
        "step_count": pool["scal"][:, 4]}, env, faults, what)
    faults[f"{what}: flags"] += int((pool["scal"][:, 5:7] != 0).any(1).sum())
    if before is not None:
        kept = ((pool["grid"] == before["grid"]).all(1)
                & (pool["scal"] == before["scal"]).all(1)
                & (pool["mission"] == before["mission"]).all(1))
        faults[f"{what}: not refreshed"] += int(2 * int(kept.sum()) > P_)


def check_layouts(state: dict, env: dict, faults: Counter, what: str,
                  step_counts=(0, 1)):
    """Count envs of ``state`` whose layout is not one of the family's or
    whose step count lies outside ``step_counts`` (a range)."""
    bad = family(env).layout_faults(state) > 0
    sc = state["step_count"]
    bad |= (sc < step_counts[0]) | (sc >= step_counts[1])
    faults[what] += int(bad.sum())


def fresh_rows(done, cursor, n_buf: int, window: int):
    """The fresh reset's routing (the JAX package's ``autoreset_step_fresh``
    semantics): the r-th env to finish a step takes buffer row ``start +
    min(r, window - 1)``, ``start = min(cursor, n_buf - window)``; the
    cursor then advances by the step's finishers."""
    d = done.long()
    rank = torch.cumsum(d, 0) - d
    start = min(cursor, n_buf - window)
    return start + rank.clamp(max=window - 1), cursor + int(d.sum())


def replay(rec: dict, env: dict, device, reward_dtype=torch.float32):
    """Follow the recorded rollout steps with the reference env, in the
    recording's reset mode ("pooled": the step's broadcast row from the
    pool that train step drew from, each refresh of the pool checked by
    itself; "fresh": the rollout's buffer of fresh layouts, routed; "regen":
    a fresh layout of the program's generator, which is checked by itself
    and taken). Returns
    (faults, trajectory): the trajectory holds, per step, the observation
    the policy saw (packed view, mission, direction), the reward and the
    done flag, and after each train step the observation it ended on."""
    fam = family(env)
    W = H = env["size"]
    V = env["view_size"]
    faults = Counter()
    start = rec["start"]
    state = _to(start["state"], device)
    check_layouts(state, env, faults, "start layouts", (0, fam.max_steps))
    obs = M.observe(state, V)
    faults["start observations"] += int(
        (obs != start["obs"].to(device)).flatten(1).any(1).sum())
    mode = rec["mode"]
    pooled = mode == "pooled"
    if pooled:
        pools = [_to(q, device) for q in rec["pools"]]
        for k, q in enumerate(pools):
            check_pool(q, env, faults, "pool" if k == 0 else "refreshed pool",
                       pools[k - 1] if k else None)
        if "window_pool" in rec:
            check_pool(_to(rec["window_pool"], device), env, faults,
                       "the window's refreshed pool", pools[-1])

    traj = {k: [] for k in ("packed", "mission", "direction", "reward",
                            "done")}
    ends = []
    T = rec["rollout_len"]
    for i, r in enumerate(rec["steps"]):
        if pooled and i % T == 0:
            pool = pools[i // T]
        if mode == "fresh" and i % T == 0:
            buffer = _to(rec["buffers"][i // T], device)
            check_layouts(buffer, env, faults, "fresh layouts")
            cursor = 0
        traj["packed"].append(obs)
        traj["mission"].append(state["mission"])
        traj["direction"].append(state["agent_dir"])
        new, reward, term, trunc = fam.step(state, r["action"].to(device),
                                            reward_dtype)
        done = term | trunc
        if pooled:
            row = _to(r["row"], device)
            in_pool = ((pool["grid"] == row["grid"]).all(1)
                       & (pool["scal"] == row["scal"]).all(1)
                       & (pool["mission"] == row["mission"]).all(1))
            faults["reset rows not from the pool"] += int(not in_pool.any())
            reset = M.row_state(row["grid"], row["scal"], row["mission"],
                                W, H)
        elif mode == "fresh":
            rows, cursor = fresh_rows(done, cursor,
                                      buffer["step_count"].shape[0],
                                      r["window"])
            reset = {k: v[rows] for k, v in buffer.items()}
        got = _to(r["state"], device)
        if mode == "regen":
            reset = got
            check_layouts({k: v[done] for k, v in got.items()}, env, faults,
                          "fresh layouts")
            faults["fresh missions"] += int(
                (got["mission"][done] != state["mission"][done]).any(1).sum())
        new = M.select(done, new, reset)
        obs = M.observe(new, V)
        faults["states"] += int(_env_differs(got, new).sum())
        faults["observations"] += int(
            (obs != r["obs"].to(device)).flatten(1).any(1).sum())
        faults["directions"] += int(
            (r["direction"].to(device) != new["agent_dir"]).sum())
        faults["rewards"] += int((r["reward"].to(device) != reward).sum())
        faults["flags"] += int(((r["terminated"].to(device) != term)
                                | (r["truncated"].to(device) != trunc))
                               .sum())
        traj["reward"].append(reward)
        traj["done"].append(done)
        state = new
        if (i + 1) % T == 0:
            ends.append({"packed": obs, "mission": state["mission"],
                         "direction": state["agent_dir"]})
    out = {k: torch.stack(v) for k, v in traj.items()}
    out["ends"] = ends
    return faults, out


def _match_slab(fp: dict, img: torch.Tensor, direction: torch.Tensor,
                mbt: int, n: int):
    """The slab j whose first timestep the update forward ``fp`` saw."""
    dev = img.device
    for j in range(n):
        if (torch.equal(fp["img_feat"].to(dev), img[j * mbt])
                and torch.equal(fp["direction"].to(dev).long(),
                                direction[j * mbt].long())):
            return j
    return None


def follow_learner(rec: dict, traj: dict, policy: dict, ppo: dict,
                   weights0: dict, device, quant=None,
                   half_batch: bool = False):
    """Run the reference learner over the followed steps: per train step
    the rollout's values and log-probabilities of the program's actions,
    GAE, then the minibatches in the order the program took them. Returns
    the losses, their scales, the first gradient and the final weights.
    ``half_batch`` takes each minibatch's loss over its first half of the
    envs alone (a fault, for the check's own test)."""
    w = {k: v.to(device).clone() for k, v in weights0.items()}
    opt = P.Adam(w, ppo["lr"])
    T, n_mb = rec["rollout_len"], ppo["num_minibatches"]
    mbt = T // n_mb
    losses, scales, first = [], [], None
    order_faults = 0
    actions = torch.stack([r["action"] for r in rec["steps"]]).to(device)
    for k in range(len(rec["steps"]) // T):
        sl = slice(k * T, (k + 1) * T)
        enc = [P.encode(traj["packed"][t], traj["mission"][t],
                        traj["direction"][t], policy)
               for t in range(sl.start, sl.stop)]
        data = {key: torch.stack([e[key] for e in enc]) for key in enc[0]}
        act = actions[sl]
        values, logps = [], []
        with torch.no_grad():
            for t in range(T):
                logits, value = P.forward(w, enc[t], policy, quant)
                lp = torch.log_softmax(logits, -1).gather(
                    -1, act[t].long()[:, None]).squeeze(-1)
                values.append(value)
                logps.append(lp)
            end = traj["ends"][k]
            _, last = P.forward(w, P.encode(end["packed"], end["mission"],
                                            end["direction"], policy),
                                policy, quant)
        adv, ret = P.gae(traj["reward"][sl], torch.stack(values),
                         traj["done"][sl], last, ppo["gamma"],
                         ppo["gae_lambda"])
        data.update(action=act, log_prob=torch.stack(logps), adv=adv,
                    ret=ret)
        inputs = rec["update_inputs"][k]
        if len(inputs) != ppo["num_epochs"] * n_mb:
            order_faults += 1
        totals, terms = [], []
        for i, fp in enumerate(inputs):
            j = _match_slab(fp, data["img_feat"], data["direction"], mbt,
                            n_mb)
            if j is None:
                order_faults += 1
                j = i % n_mb
            B = act.shape[1]
            envs = slice(0, B // 2) if half_batch else slice(0, B)
            mb = {key: v[j * mbt:(j + 1) * mbt, envs].reshape(
                -1, *v.shape[2:]) for key, v in data.items()}
            leaves = {key: v.detach().requires_grad_() for key, v in w.items()}
            total, (pg, v_loss, ent) = P.ppo_loss(leaves, mb, policy, ppo,
                                                  quant)
            grads = dict(zip(leaves, torch.autograd.grad(
                total, list(leaves.values()))))
            grads = P.clip_global_norm(grads, ppo["max_grad_norm"])
            if first is None:
                first = {key: g.detach().clone() for key, g in grads.items()}
            opt.step(w, grads)
            totals.append(float(total.detach()))
            pg, v_loss, ent = (float(x.detach()) for x in (pg, v_loss, ent))
            terms.append(abs(pg) + ppo["vf_coef"] * v_loss
                         + ppo["ent_coef"] * abs(ent))
        losses.append(sum(totals) / max(1, len(totals)))
        scales.append(sum(terms) / max(1, len(terms)))
    return {"losses": losses, "scales": scales, "first_grads": first,
            "params": w, "order_faults": order_faults}


def _norms(d: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in d.items()}


def learner_gaps(prog: dict, ref: dict, weights0: dict) -> dict:
    """The numbers compared for a train cell, between the program's run
    (``losses``, ``first_grads``, ``params``) and the reference's: the
    largest gap of a train step's loss over the size of its terms, and by
    the worst leaf the gap between the two norms of the first gradient and
    of the change over the followed steps, each over the reference's norm
    of that leaf or of the median leaf, whichever is larger. Leaves whose
    reference gradient is under :data:`TINY_GRADIENT` of the median leaf's
    are left out of the change."""
    loss_gap = max((abs(a - b) / s for a, b, s in zip(
        prog["losses"], ref["losses"], ref["scales"])), default=float("inf"))
    if len(prog["losses"]) != len(ref["losses"]):
        loss_gap = float("inf")
    gr, gp = _norms(ref["first_grads"]), _norms(prog["first_grads"])
    med = statistics.median(gr.values())
    grad_gap = max(abs(gp[k] - gr[k]) / max(gr[k], med) for k in gr)
    keep = [k for k in gr if gr[k] >= TINY_GRADIENT * med]
    w0 = {k: v.to(ref["params"][k].device) for k, v in weights0.items()}
    dr = _norms({k: ref["params"][k] - w0[k] for k in keep})
    dp = _norms({k: prog["params"][k].to(w0[k].device) - w0[k]
                 for k in keep})
    med_d = statistics.median(dr.values())
    change_gap = max(abs(dp[k] - dr[k]) / max(dr[k], med_d) for k in keep)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap,
            "left_out": sorted(set(gr) - set(keep))}


def check_start(start: dict, env: dict, device, faults: Counter):
    """The batch a run starts from: valid layouts at step counts below the
    episode budget, and the observation of each."""
    state = _to(start["state"], device)
    check_layouts(state, env, faults, "start layouts",
                  (0, family(env).max_steps))
    obs = M.observe(state, env["view_size"])
    faults["start observations"] += int(
        (obs != start["obs"].to(device)).flatten(1).any(1).sum())


def check_regen_steps(samples: list, env: dict, device,
                      reward_dtype=torch.float32) -> Counter:
    """Judge sampled steps of the regen auto-reset (each the state before
    the step, the actions, what the program returned and what the host
    read): an env that goes on takes the reference's transition; an env
    that ends takes a valid fresh layout of the family at step 0, with the
    same mission; every env's observation, reward and flags are the
    reference's, and so are the host's count of ended episodes and its sum
    of rewards."""
    fam = family(env)
    V = env["view_size"]
    faults = Counter()
    for s in samples:
        before = _to(s["before"], device)
        got = _to(s["state"], device)
        new, reward, term, trunc = fam.step(before, s["action"].to(device),
                                            reward_dtype)
        done = term | trunc
        faults["states"] += int((_env_differs(got, new) & ~done).sum())
        fresh = {k: v[done] for k, v in got.items()}
        check_layouts(fresh, env, faults, "fresh layouts")
        faults["fresh missions"] += int(
            (got["mission"][done] != before["mission"][done]).any(1).sum())
        seen = M.select(done, new, got)
        obs = M.observe(seen, V)
        faults["observations"] += int(
            (obs != s["obs"].to(device)).flatten(1).any(1).sum())
        faults["rewards"] += int((s["reward"].to(device) != reward).sum())
        faults["flags"] += int(((s["terminated"].to(device) != term)
                                | (s["truncated"].to(device) != trunc))
                               .sum())
        ended, summed = s["host_read"]
        faults["host reads"] += int(ended != int(done.sum())
                                    or summed != float(reward.sum()))
    return faults
