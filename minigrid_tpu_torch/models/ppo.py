"""PPO over batched envs: the rollout in every reset mode and the update.

Counterpart of ``minigrid_tpu/models/ppo.py`` (MLP policy). The rollout
encodes each observation once (stored in the trajectory and fed to the
policy), samples the action by Gumbel-argmax with presampled noise, and
auto-resets finished envs in one of three modes:

- ``"pooled"``: this step's presampled broadcast row from a layout pool; the
  mission is carried as vocabulary counts, refreshed from the row;
- ``"fresh"``: a buffer of fresh layouts generated per rollout, consumed
  through a device-side cursor (``envs/base.py::autoreset_step_fresh``);
- ``"regen"``: a fresh ``_gen_grid`` batch every step, selected where done.

A wrapper stack (``wrappers``) rolls out like a bare env: its pooled and
fresh resets run batched (``make_train_step`` refuses a stack they cannot
run), a ``WrappedState`` batch threads through, a wrapper's observations
that are not the native dict are stored as they come and fed to the model
as they are, and no mission counts are carried (a wrapper may change the
mission).

On the card every env step is one launch of the fused CUDA kernel, and the
fresh and regen modes add one launch of its observe entry per step; a
feed-forward policy's step on the native observation dict is one replay of
a CUDA graph (``models/policy_step.py``). The
update is GAE, then ``num_epochs`` passes over ``num_minibatches``
minibatches of the clipped-surrogate loss, each followed by optax's global
clip-norm rule and Adam. ``make_train_step`` returns
``train_step(env_state, obs, generator, pool=None) -> (env_state, obs,
metrics)``, which updates the model and the optimizer in place; metrics stay
device tensors until the caller reads them.

A recurrent policy (``model.is_recurrent``, ``ActorCriticRNN``) threads its
hidden state ``h``: the rollout stores the ``h`` fed into each step and
zeroes it in finished envs after the step; the update replays each rotate
slab's GRU from the hidden stored at the slab's first step, re-zeroed at
the slab's episode ends (truncated backpropagation through time), so it
needs ``shuffle="rotate"``; the train step becomes ``train_step(env_state,
obs, h, generator, pool=None) -> (env_state, obs, h, metrics)``.

Over several ranks (``mesh``, ``parallel/mesh.py``) each rank holds its
data rank's block of the batch. One generator, seeded alike on every rank,
draws everything that one process draws, as one process draws it: the
step keys and the Gumbel noise, of which each rank keeps its block, the
reset rows, the regen layouts of the global batch (each rank keeps its
rows), the fresh buffer (whole on every rank) and the minibatch draws. The
fresh routing ranks a step's finishers over the global batch (one
all-reduce of the ranks' finisher counts a step, :func:`finisher_counts`),
so a rollout's rank block, in every reset mode, is exactly its rows of one
process's rollout. The update is the global update: the advantage
statistics, the loss's means and the gradients are all-reduced over the
data ranks, and every rank takes the same optimizer step. Without a mesh
there are no collectives.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from minigrid_tpu_torch.envs.base import (LayoutPool, presample_reset_states,
                                          random_keys)
from minigrid_tpu_torch.models.actor_critic import mission_counts
from minigrid_tpu_torch.models.policy_step import (POLICY, act,
                                                   graphed_policy,
                                                   selected_log_prob)
from minigrid_tpu_torch.utils import trace
from minigrid_tpu_torch.wrappers import ReseedWrapper, Wrapper

RESET_MODES = ("regen", "pooled", "fresh")
SHUFFLES = ("rotate", "timestep", "sample")
OBS_KEYS = ("img_feat", "mission_counts", "direction")
# a minibatch's entries besides the stored observations (a recurrent
# policy's also hold "done" and "hidden")
TRAJ_KEYS = ("action", "log_prob", "adv", "ret", "done", "hidden")


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """The JAX package's PPO settings, with the same defaults."""

    num_envs: int = 4096
    rollout_len: int = 128
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    lr: float = 2.5e-4
    max_grad_norm: float = 0.5
    num_epochs: int = 1
    num_minibatches: int = 4
    # "rotate": minibatch i is the contiguous timestep slab ((i + off) % n),
    # with a random offset per epoch (no copy); "timestep": a random
    # permutation of whole timesteps, then contiguous slabs; "sample": a
    # random permutation of all T*B samples
    shuffle: str = "rotate"


class Transition(NamedTuple):
    obs: Any
    action: torch.Tensor
    log_prob: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    # recurrent policies: the hidden state fed into each step
    hidden: torch.Tensor | None = None


def is_recurrent(model) -> bool:
    return bool(getattr(model, "is_recurrent", False))


@dataclasses.dataclass(frozen=True)
class RolloutNoise:
    """All per-step randomness of a rollout of T steps over B envs."""

    step_keys: torch.Tensor   # (T, B, 2) int32 env step keys
    gumbel: torch.Tensor      # (T, B, A) float32 action noise
    reset_rows: LayoutPool | None = None  # T broadcast reset rows (pooled)

    def shard(self, rows: slice) -> "RolloutNoise":
        """The noise of the envs ``rows`` (a data rank's block); the
        broadcast reset rows are every env's."""
        return dataclasses.replace(
            self, step_keys=self.step_keys[:, rows].contiguous(),
            gumbel=self.gumbel[:, rows].contiguous())


def sample_rollout_noise(generator: torch.Generator, pool: LayoutPool | None,
                         num_envs: int, length: int, num_actions: int,
                         device=None) -> RolloutNoise:
    """Draw a rollout's keys, Gumbel noise and (with a pool) reset rows up
    front. Without a pool, ``device`` says where."""
    dev = pool.grid.device if pool is not None else torch.device(device)
    keys = random_keys(generator, (length, num_envs, 2), dev)
    u = torch.rand((length, num_envs, num_actions), generator=generator,
                   device=dev)
    u = u.clamp(min=torch.finfo(torch.float32).tiny)
    gumbel = -torch.log(-torch.log(u))
    rows = (presample_reset_states(generator, pool, length)
            if pool is not None else None)
    return RolloutNoise(keys, gumbel, rows)


def fresh_sizes(env, cfg: PPOConfig,
                fresh_buffer: int | None = None) -> tuple[int, int]:
    """(buffer rows, routing window) of the fresh reset, as the JAX package
    sizes them: the buffer ~1.2x the expected resets of a rollout of the
    (global) batch plus 8 sigma, the window ~2x a step's mean finishers
    plus 6 sigma (at least 32, at most the buffer)."""
    if fresh_buffer is None:
        ms = int(env.params.max_steps)
        if ms > 1 << 16:
            raise ValueError(
                "resets='fresh' on a dynamic-budget env (max_steps "
                f"sentinel {ms}): pass fresh_buffer explicitly")
        mean = cfg.num_envs * cfg.rollout_len / ms
        fresh_buffer = int(mean * 1.2) + 8 * int(mean ** 0.5) + 64
    mean_step = fresh_buffer / max(cfg.rollout_len, 1)
    window = max(32, int(2 * mean_step + 6 * mean_step ** 0.5) + 1)
    return fresh_buffer, min(window, fresh_buffer)


def finisher_counts(mesh):
    """The fresh routing's ``finishers`` over the data ranks (see
    ``envs/base.py::fresh_candidates``): one all-reduce over
    ``mesh.data_group`` of an (n,) int32 vector in which this data rank
    writes its block's finisher count at its slot; returns (the counts of
    the ranks before it, the total), device int32 scalars."""
    def finishers(count):
        counts = torch.zeros((mesh.data_size,), dtype=torch.int32,
                             device=count.device)
        counts[mesh.data_rank] = count
        dist.all_reduce(counts, group=mesh.data_group)
        return (counts[:mesh.data_rank].sum(dtype=torch.int32),
                counts.sum(dtype=torch.int32))

    return finishers


def regen_layouts(env, generator: torch.Generator, num_envs: int,
                  rows: slice):
    """The rows ``rows`` of the regen layouts of a global batch of
    ``num_envs`` envs, drawn from ``generator`` as one process draws them
    (its bare env's ``_gen_grid``), or None for a stack holding a
    ``ReseedWrapper``, whose seeds dictate every reset (one process draws
    nothing)."""
    while isinstance(env, Wrapper):
        if isinstance(env, ReseedWrapper):
            return None
        env = env.env
    with trace.span("gen"):
        return env._gen_grid(generator, num_envs).map(lambda x: x[rows])


@trace.spanned("rollout")
@torch.no_grad()
def rollout(model, env, env_state, obs: dict, noise: RolloutNoise,
            resets: str = "pooled", generator: torch.Generator | None = None,
            fresh_buffer: int | None = None, fresh_window: int = 32,
            h: torch.Tensor | None = None, mesh=None):
    """T = noise.gumbel.shape[0] policy steps of every env.

    ``resets``: "pooled" takes ``noise.reset_rows``; "fresh" generates a
    buffer of ``fresh_buffer`` layouts from ``generator`` and routes them
    through a ``fresh_window``-row window; "regen" generates a batch from
    ``generator`` every step. With a ``mesh``, ``env_state`` and ``noise``
    hold the data rank's block of a global batch, and ``generator`` is the
    one every rank seeds alike: "regen" generates the global batch a step
    and keeps the rank's rows, "fresh" generates the whole buffer (size it
    from the global batch) and routes it over the global batch, one
    all-reduce of the finisher counts a step (:func:`finisher_counts`).
    Returns ``(env_state, obs, traj, reset_overflow)``: ``traj`` is a
    :class:`Transition` of (T, B, ...) tensors, ``traj.obs`` the encoded
    observations the policy saw (the raw ones for a model with
    ``takes_raw_obs``), and
    ``reset_overflow`` the fresh mode's degraded resets summed over the
    rollout (a device int32 scalar, 0 in the other modes). A recurrent
    ``model`` takes the hidden state ``h`` (B, H), stores each step's input
    hidden in ``traj.hidden``, zeroes it where an episode ended, and
    returns it as a fifth value."""
    if resets not in RESET_MODES:
        raise ValueError(f"resets must be one of {RESET_MODES}, got "
                         f"{resets!r}")
    T = noise.gumbel.shape[0]
    dev = noise.gumbel.device
    # the native observation dict is encoded once (the encoding is stored
    # and fed to the policy); a wrapper's other observations (an array, a
    # dict without a view) are stored as they come, and the model takes
    # them as they are
    std_obs = (isinstance(obs, dict) and ("packed" in obs or "image" in obs)
               and not getattr(model, "takes_raw_obs", False))
    view_key = "packed" if std_obs and "packed" in obs else "image"
    # a mission changes only at a reset, so the pooled mode carries its
    # counts and refreshes them from the reset row (the bare row's tokens:
    # not under a wrapper, which may transform the mission); otherwise
    # each step's tokens are counted
    carry = (resets == "pooled" and std_obs and "mission" in obs
             and not isinstance(env, Wrapper))
    counts = mission_counts(obs["mission"]) if carry else None
    if carry:
        reset_counts = mission_counts(noise.reset_rows.mission)   # (T, VOCAB)
    overflow = torch.zeros((), dtype=torch.int32, device=dev)
    if resets == "fresh":
        buffer = env.presample_fresh(generator, fresh_buffer)
        cursor = torch.zeros((), dtype=torch.int32, device=dev)
        finishers = None if mesh is None else finisher_counts(mesh)
    if resets == "regen" and mesh is not None:
        num_envs = env_state.batch_size * mesh.data_size
        rows = mesh.batch_slice(num_envs)
    recurrent = is_recurrent(model)
    if recurrent and h is None:
        raise ValueError("a recurrent policy's rollout needs its hidden "
                         "state h")

    def policy_inputs(obs, counts):
        """The policy step's input: the observation, in the pooled mode with
        the carried mission counts in place of the tokens."""
        if carry:
            return {view_key: obs[view_key], "mission_counts": counts,
                    "direction": obs["direction"]}
        return obs

    # on the card a feed-forward policy's step is one graph replay
    graphed = (graphed_policy(model, policy_inputs(obs, counts), noise.gumbel)
               if std_obs and not recurrent else None)
    policy_out, rewards, dones = [], [], []
    for t in range(T):
        with trace.span("policy"):
            inputs = policy_inputs(obs, counts)
            if graphed is not None:
                action = graphed.step(inputs)
            else:
                POLICY.eager_steps += 1
                h_in = h
                enc, action, log_prob, value, h = act(
                    model, inputs, noise.gumbel[t], std_obs,
                    h if recurrent else None)
                policy_out.append((enc, action.to(torch.int32), log_prob,
                                   value, h_in))
        keys = noise.step_keys[t]
        if resets == "pooled":
            obs, env_state, reward, term, trunc, _ = \
                env.step_autoreset_presampled(keys, env_state, action,
                                              noise.reset_rows.rows(t))
        elif resets == "fresh":
            obs, env_state, reward, term, trunc, info, cursor = \
                env.step_autoreset_fresh(keys, env_state, action, buffer,
                                         cursor, fresh_window, finishers)
            overflow = overflow + info["reset_overflow"]
        else:
            layouts = (None if mesh is None else
                       regen_layouts(env, generator, num_envs, rows))
            obs, env_state, reward, term, trunc, _ = env.step_autoreset(
                keys, env_state, action, generator, layouts)
        done = term | trunc
        if carry:
            counts = torch.where(done[:, None], reset_counts[t][None],
                                 counts)
        if recurrent:
            # the next step's forward starts a new episode from h = 0
            h = h * (1.0 - done[:, None].to(h.dtype))
        rewards.append(reward)
        dones.append(done)
    if graphed is not None:
        traj_obs, action, log_prob, value = graphed.trajectory()
        hidden = None
    else:
        encs, action, log_prob, value, hidden = zip(*policy_out)
        if isinstance(encs[0], dict):
            traj_obs = {k: torch.stack([e[k] for e in encs]) for k in encs[0]}
        else:
            traj_obs = torch.stack(encs)
        action, log_prob, value = (torch.stack(f)
                                   for f in (action, log_prob, value))
        hidden = torch.stack(hidden) if recurrent else None
    traj = Transition(traj_obs, action, log_prob, value,
                      torch.stack(rewards), torch.stack(dones), hidden)
    if recurrent:
        return env_state, obs, traj, overflow, h
    return env_state, obs, traj, overflow


def gae(reward, value, done, last_value, gamma: float, gae_lambda: float):
    """Generalized advantage estimation over (T, B) tensors, backwards in
    time from ``last_value`` (B,). Returns (advantages, returns)."""
    adv = torch.empty_like(value)
    adv_next = torch.zeros_like(last_value)
    v_next = last_value
    for t in range(value.shape[0] - 1, -1, -1):
        nonterm = 1.0 - done[t].to(torch.float32)
        delta = reward[t] + gamma * v_next * nonterm - value[t]
        adv_next = delta + gamma * gae_lambda * nonterm * adv_next
        adv[t] = adv_next
        v_next = value[t]
    return adv, adv + value


def policy_input(mb: dict):
    """The stored observations of a minibatch, as the policy takes them:
    the entry ``"obs"`` (an array observation), else every entry but the
    trajectory's own."""
    if "obs" in mb:
        return mb["obs"]
    return {k: v for k, v in mb.items() if k not in TRAJ_KEYS}


def replay_slab(model, mb: dict):
    """A recurrent policy's (logits, value) over a (mbt, B) slab: the
    inputs encoded over the whole slab, the GRU run step by step from the
    hidden stored at the slab's first step (``mb["hidden"][0]``) and
    zeroed after each step where an episode ended, the heads on the
    stacked outputs. Gradients flow through the whole loop."""
    xz = model.encode_inputs(policy_input(mb))
    h = mb["hidden"][0]
    outs = []
    for t in range(xz.shape[0]):
        h_new = model.gru_step(xz[t], h)
        outs.append(h_new)
        h = h_new * (1.0 - mb["done"][t][:, None].to(h_new.dtype))
    return model.heads(torch.stack(outs))


def ppo_loss(model, cfg: PPOConfig, mb: dict, mesh=None):
    """The clipped-surrogate loss of one minibatch (a dict of the stored
    observations, action, log_prob, adv and ret over any leading shape;
    for a recurrent policy a (mbt, B) slab with its done and hidden, see
    :func:`replay_slab`); the advantage is normalised over the minibatch.
    Returns (total, metrics) with detached metrics.

    With a ``mesh``, ``mb`` is this data rank's part of the minibatch: the
    advantage's mean and standard deviation come from all-reduced sums
    (the count and the sum, then the squared deviations), and each mean of
    the loss is the local sum over the global count, so the totals of the
    ranks (and their gradients) sum to the minibatch's."""
    if is_recurrent(model):
        logits, value = replay_slab(model, mb)
    else:
        logits, value = model(policy_input(mb))
    log_probs = torch.log_softmax(logits, -1)
    lp = selected_log_prob(log_probs, mb["action"])
    ratio = torch.exp(lp - mb["log_prob"])
    adv = mb["adv"]
    if mesh is None:
        mean, std = adv.mean(), adv.std(correction=0)
        average = torch.mean
    else:
        stats = torch.stack([adv.new_tensor(float(adv.numel())), adv.sum()])
        dist.all_reduce(stats, group=mesh.data_group)
        count, mean = stats[0], stats[1] / stats[0]
        sq = torch.square(adv - mean).sum()
        dist.all_reduce(sq, group=mesh.data_group)
        std = torch.sqrt(sq / count)
        average = lambda x: x.sum() / count  # noqa: E731
    norm_adv = (adv - mean) / (std + 1e-8)
    pg1 = ratio * norm_adv
    pg2 = torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * norm_adv
    pg_loss = -average(torch.minimum(pg1, pg2))
    v_loss = 0.5 * average(torch.square(value - mb["ret"]))
    entropy = -average((torch.exp(log_probs) * log_probs).sum(-1))
    total = pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * entropy
    metrics = {"loss": total, "pg_loss": pg_loss, "v_loss": v_loss,
               "entropy": entropy}
    return total, {k: v.detach() for k, v in metrics.items()}


def make_optimizer(model, cfg: PPOConfig) -> torch.optim.Adam:
    """Adam over the model's parameters with optax's defaults (b1 0.9, b2
    0.999, eps 1e-8). The global clip-norm that optax chains before it is
    :func:`clip_by_global_norm_`, applied by :func:`update_minibatch`."""
    return torch.optim.Adam(model.parameters(), lr=cfg.lr,
                            betas=(0.9, 0.999), eps=1e-8)


@torch.no_grad()
def clip_by_global_norm_(params, max_norm: float,
                         mesh=None) -> torch.Tensor:
    """optax's ``clip_by_global_norm``, in place on the gradients: kept
    while the global norm is below ``max_norm``, else ``g / norm *
    max_norm``. Returns the norm (a device scalar; no host sync). With a
    ``mesh`` of several model ranks, the squares of the parameters split
    over them (``parallel.shard_params``) are all-reduced over the model
    ranks, so each shard counts once and each replicated parameter
    once."""
    grads = [p.grad for p in params if p.grad is not None]
    if mesh is not None and mesh.model_size > 1:
        split = [p.grad for p in params if p.grad is not None
                 and hasattr(p, "tensor_parallel")]
        whole = [p.grad for p in params if p.grad is not None
                 and not hasattr(p, "tensor_parallel")]
        sq = sum(torch.sum(g * g) for g in split)
        dist.all_reduce(sq, group=mesh.model_group)
        norm = torch.sqrt(sq + sum(torch.sum(g * g) for g in whole))
    else:
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


@torch.no_grad()
def all_reduce_gradients_(params, group) -> None:
    """Sum every parameter's gradient over ``group`` in place: one
    all-reduce of one flattened buffer (a missing gradient counts as
    zeros)."""
    params = list(params)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    for p, g in zip(params, flat.split([g.numel() for g in grads])):
        p.grad = g.view_as(p)


def update_minibatch(model, optimizer, cfg: PPOConfig, mb: dict,
                     mesh=None) -> dict:
    """One gradient step on one minibatch: the loss, its gradient, the
    global clip-norm and the optimizer step. Returns the loss metrics.
    With a ``mesh`` the loss is the rank's part of the global one
    (:func:`ppo_loss`), and its gradients are summed over the data ranks
    before the clip, so every rank takes the same step; the metrics are
    the rank's parts."""
    optimizer.zero_grad(set_to_none=True)
    total, metrics = ppo_loss(model, cfg, mb, mesh)
    total.backward()
    params = list(model.parameters())
    if mesh is not None:
        all_reduce_gradients_(params, mesh.data_group)
    clip_by_global_norm_(params, cfg.max_grad_norm, mesh)
    optimizer.step()
    return metrics


def epoch_minibatches(data: dict, cfg: PPOConfig,
                      generator: torch.Generator, offset: int | None = None,
                      mesh=None):
    """The minibatches of one epoch over ``data`` ((T, B, ...) tensors), in
    visiting order. "rotate" yields (T/n, B, ...) views of the timestep
    slabs starting at slab ``offset`` (drawn from ``generator`` when None:
    the one host sync of an epoch); "timestep" and "sample" yield
    flattened (T*B/n, ...) gathers. With a ``mesh``, ``data`` is a data
    rank's block of envs and ``generator`` the shared one: "sample"
    permutes the global samples and yields the rank's share of each
    minibatch (its size varies; one host sync a minibatch)."""
    T, B = data["adv"].shape
    n = cfg.num_minibatches
    dev = data["adv"].device
    if cfg.shuffle == "rotate":
        mbt = T // n
        if offset is None:
            offset = int(torch.randint(0, n, (1,), generator=generator,
                                       device=dev))
        for i in range(n):
            j = (i + offset) % n
            yield {k: v[j * mbt:(j + 1) * mbt] for k, v in data.items()}
    elif cfg.shuffle == "timestep":
        mbt = T // n
        tperm = torch.randperm(T, generator=generator, device=dev)
        shuf = {k: v[tperm] for k, v in data.items()}
        for i in range(n):
            yield {k: v[i * mbt:(i + 1) * mbt].reshape(mbt * B, *v.shape[2:])
                   for k, v in shuf.items()}
    else:
        flat = {k: v.reshape(T * B, *v.shape[2:]) for k, v in data.items()}
        ranks = 1 if mesh is None else mesh.data_size
        perm = torch.randperm(T * B * ranks, generator=generator, device=dev)
        mb = T * B * ranks // n
        for i in range(n):
            idx = perm[i * mb:(i + 1) * mb]
            if mesh is not None:  # global (t, b) -> this rank's t * B + b
                lo = mesh.data_rank * B
                t, b = idx // (B * ranks), idx % (B * ranks) - lo
                mine = (b >= 0) & (b < B)
                idx = t[mine] * B + b[mine]
            yield {k: v[idx] for k, v in flat.items()}


@trace.spanned("update")
def ppo_update(model, optimizer, cfg: PPOConfig, traj: Transition,
               last_obs: dict, generator: torch.Generator,
               h: torch.Tensor | None = None, mesh=None) -> dict:
    """The update phase of a train step: GAE bootstrapped from the value of
    ``last_obs`` (for a recurrent policy, with the rollout's final hidden
    state ``h``), then ``cfg.num_epochs`` passes over the minibatches of
    ``traj``, updating ``model`` and ``optimizer`` in place. Returns the
    loss metrics averaged over the minibatches and ``mean_reward``, as
    device scalars. With a ``mesh``, ``traj`` is the data rank's block of
    envs, ``generator`` the shared one, and the update and the metrics
    are the global ones (one all-reduce for the metrics)."""
    recurrent = is_recurrent(model)
    with torch.no_grad():
        if recurrent:
            (_, last_value), _ = model(last_obs, h)
        else:
            _, last_value = model(last_obs)
    adv, ret = gae(traj.reward, traj.value, traj.done, last_value,
                   cfg.gamma, cfg.gae_lambda)
    obs = traj.obs if isinstance(traj.obs, dict) else {"obs": traj.obs}
    data = dict(obs, action=traj.action, log_prob=traj.log_prob, adv=adv,
                ret=ret)
    if recurrent:
        # a rotate slab is a view of these: its start hidden is the stored
        # hidden of its first step, traj.hidden[j * mbt] for slab j
        data.update(done=traj.done, hidden=traj.hidden)
    per_mb = [update_minibatch(model, optimizer, cfg, mb, mesh)
              for _ in range(cfg.num_epochs)
              for mb in epoch_minibatches(data, cfg, generator, mesh=mesh)]
    metrics = {k: torch.stack([m[k] for m in per_mb]).mean()
               for k in per_mb[0]}
    if mesh is None:
        metrics["mean_reward"] = traj.reward.mean()
        return metrics
    # the ranks' parts of each metric, the reward's sum and count
    reward = traj.reward
    parts = torch.stack([*metrics.values(), reward.sum(),
                         reward.new_tensor(float(reward.numel()))])
    dist.all_reduce(parts, group=mesh.data_group)
    metrics = dict(zip(metrics, parts[:-2]))
    metrics["mean_reward"] = parts[-2] / parts[-1]
    return metrics


def check_config(cfg: PPOConfig, recurrent: bool = False) -> None:
    """Raise ``ValueError`` for a shuffle the rollout shape cannot cut, or
    that a recurrent policy cannot replay (it needs contiguous timestep
    slabs: "rotate")."""
    if cfg.shuffle not in SHUFFLES:
        raise ValueError(f"shuffle must be one of {SHUFFLES}, got "
                         f"{cfg.shuffle!r}")
    if recurrent and cfg.shuffle != "rotate":
        raise ValueError("recurrent training needs contiguous timestep "
                         f"slabs: shuffle='rotate' (got {cfg.shuffle!r})")
    if cfg.shuffle in ("rotate", "timestep"):
        if cfg.rollout_len % cfg.num_minibatches:
            raise ValueError(
                f"{cfg.shuffle} shuffling needs rollout_len "
                f"({cfg.rollout_len}) divisible by num_minibatches "
                f"({cfg.num_minibatches})")
    elif (cfg.num_envs * cfg.rollout_len) % cfg.num_minibatches:
        raise ValueError(
            f"sample shuffling needs num_envs*rollout_len "
            f"({cfg.num_envs * cfg.rollout_len}) divisible by "
            f"num_minibatches ({cfg.num_minibatches})")


def make_train_step(env, model, cfg: PPOConfig, optimizer,
                    pooled: bool = False, resets: str | None = None,
                    fresh_buffer: int | None = None, mesh=None):
    """Returns ``train_step(env_state, obs, generator, pool=None) ->
    (env_state, obs, metrics)``: one rollout of
    ``cfg.rollout_len`` steps in the ``resets`` mode ("regen" by default;
    ``pooled=True`` is shorthand for "pooled", which needs ``pool``), GAE,
    and the update of ``model`` and ``optimizer`` in place. ``metrics``
    holds device scalars: the loss terms averaged over the minibatches,
    ``mean_reward`` and, with fresh resets, ``reset_overflow`` summed over
    the rollout. ``fresh_buffer`` overrides the fresh buffer's size
    (:func:`fresh_sizes`). For a recurrent ``model`` it is
    ``train_step(env_state, obs, h, generator, pool=None) -> (env_state,
    obs, h, metrics)``, ``h`` the hidden state carried across train steps
    (``model.initial_state(num_envs)`` at first).

    With a ``mesh`` (``parallel.make_mesh``) this is one data rank's step:
    ``cfg.num_envs`` is the global batch, ``env_state``, ``obs`` and ``h``
    hold the rank's block of it, ``generator`` is seeded alike on every
    rank and draws what one process draws (see the module docstring; the
    fresh buffer is the global batch's), and the metrics are global."""
    recurrent = is_recurrent(model)
    if resets is None:
        resets = "pooled" if pooled else "regen"
    if resets not in RESET_MODES:
        raise ValueError(f"resets must be one of {RESET_MODES}, got "
                         f"{resets!r}")
    check_config(cfg, recurrent)
    if resets in ("pooled", "fresh") and isinstance(env, Wrapper):
        # the model must take the stack's observations
        env.check_fast_paths()
    ranks = 1 if mesh is None else mesh.data_size
    if cfg.num_envs % ranks:
        raise ValueError(f"num_envs ({cfg.num_envs}) does not split over "
                         f"{ranks} data ranks")
    local_envs = cfg.num_envs // ranks
    n_buf, window = (fresh_sizes(env, cfg, fresh_buffer)
                     if resets == "fresh" else (None, 32))

    @trace.spanned("train_step")
    def step(env_state, obs, h, generator, pool):
        if env_state.batch_size != local_envs:
            raise ValueError(f"env_state holds {env_state.batch_size} envs, "
                             f"cfg.num_envs is {cfg.num_envs} over {ranks} "
                             "data rank(s)")
        if resets == "pooled" and pool is None:
            raise ValueError("resets='pooled' needs a LayoutPool")
        noise = sample_rollout_noise(
            generator, pool if resets == "pooled" else None, cfg.num_envs,
            cfg.rollout_len, model.num_actions, device=env_state.device)
        if mesh is not None:
            noise = noise.shard(mesh.batch_slice(cfg.num_envs))
        out = rollout(model, env, env_state, obs, noise, resets, generator,
                      n_buf, window, h, mesh)
        env_state, obs, traj, overflow = out[:4]
        h = out[4] if recurrent else None
        metrics = ppo_update(model, optimizer, cfg, traj, obs, generator, h,
                             mesh)
        if resets == "fresh":
            if mesh is not None:
                dist.all_reduce(overflow, group=mesh.data_group)
            metrics["reset_overflow"] = overflow
        return env_state, obs, h, metrics

    if recurrent:
        def train_step(env_state, obs, h, generator: torch.Generator,
                       pool: LayoutPool | None = None):
            return step(env_state, obs, h, generator, pool)
    else:
        def train_step(env_state, obs, generator: torch.Generator,
                       pool: LayoutPool | None = None):
            env_state, obs, _, metrics = step(env_state, obs, None,
                                              generator, pool)
            return env_state, obs, metrics

    return train_step


def make_train_loop(env, model, cfg: PPOConfig, optimizer,
                    steps_per_call: int = 8, **kw):
    """``steps_per_call`` train steps per call: ``train_loop(env_state,
    obs, generator, pool=None) -> (env_state, obs, metrics)`` with each
    metric stacked (K,); for a recurrent model ``train_loop(env_state, obs,
    h, generator, pool=None) -> (env_state, obs, h, metrics)``. With pooled
    resets the same pool serves all K steps. Keyword arguments (``mesh``
    among them) go to :func:`make_train_step`."""
    step = make_train_step(env, model, cfg, optimizer, **kw)

    def stacked(per_step):
        return {k: torch.stack([m[k] for m in per_step])
                for k in per_step[0]}

    if is_recurrent(model):
        def train_loop(env_state, obs, h, generator: torch.Generator,
                       pool: LayoutPool | None = None):
            per_step = []
            for _ in range(steps_per_call):
                env_state, obs, h, m = step(env_state, obs, h, generator,
                                            pool)
                per_step.append(m)
            return env_state, obs, h, stacked(per_step)

        return train_loop

    def train_loop(env_state, obs, generator: torch.Generator,
                   pool: LayoutPool | None = None):
        per_step = []
        for _ in range(steps_per_call):
            env_state, obs, m = step(env_state, obs, generator, pool)
            per_step.append(m)
        return env_state, obs, stacked(per_step)

    return train_loop
