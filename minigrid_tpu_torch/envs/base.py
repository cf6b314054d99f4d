"""Batched environment base and the pooled auto-reset.

Counterpart of ``minigrid_tpu/envs/base.py``. An env instance is static
configuration (``params``) plus the device it runs on; all episode data
lives in a batched :class:`EnvState`. Every function takes and returns
batch-leading tensors (no ``vmap``), and randomness comes from explicit
``torch.Generator``\\ s on the env's device::

    obs, state = env.reset(generator, num_envs)
    obs, state, reward, terminated, truncated, info = env.step(keys, state, a)

``keys`` is the (B, 2) int32 bit pattern of per-env step keys; the core
dynamics never read it, and the pooled auto-reset derives each reset
episode's ``rng`` from it exactly as the JAX package does.

On the card every transition is the fused CUDA kernel's
(``ops/fused_step.py``); on the CPU it is its plain version. An env without
step hooks steps and takes the pooled broadcast row in one launch. An env
that overrides ``_transform_action``, ``_pre_step`` or ``_post_step``, or
carries transition wrappers (``transitions``, see ``wrappers``)
(:func:`has_step_hooks`), runs the hook path, :func:`hooked_step`: the
action transform and ``_pre_step`` in PyTorch, the kernel's step entry
without a reset row (``extra``, ``rng`` and ``mission`` pass through it
untouched), then ``_post_step`` in PyTorch. The resets that put a different
state into each finished env (regenerated layouts, per-env pool rows, the
fresh buffer, and for a hook env the broadcast row too, since
``_post_step`` may end an episode after the kernel's done test) run in
three stages: that step, the select in PyTorch (:func:`select_reset_states`,
which takes the candidate states as an argument), and the kernel's observe
entry on the selected states.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core.actions import NUM_ACTIONS
from minigrid_tpu_torch.core.mission import detokenize, tokenize
from minigrid_tpu_torch.core.obs import packed_to_image
from minigrid_tpu_torch.core.types import (MISSION_LEN, EnvParams, EnvState,
                                           resolve_device)
from minigrid_tpu_torch.ops.fused_step import (fused_observe, fused_rollout,
                                               has_step_hooks, pack_rows,
                                               require_core_dynamics,
                                               unpack_rows)

# The XOR salt that derives a reset episode's rng from its step key
# (minigrid_tpu/envs/base.py:_apply_broadcast_reset), as int32 bit patterns.
RESET_RNG_SALT = np.array([0x5DEECE66, 0xB5297A4D], np.uint32).view(np.int32)
# the state fields an observation reads
OBSERVED = ("grid", "agent_pos", "agent_dir", "carrying")


def random_keys(generator: torch.Generator, shape, device) -> torch.Tensor:
    """Uniform random int32 bit patterns of ``shape``, e.g. (B, 2) keys."""
    return torch.randint(-2**31, 2**31, tuple(shape), generator=generator,
                         device=device, dtype=torch.int32)


@dataclasses.dataclass(frozen=True)
class LayoutPool:
    """Device-resident pool of P pre-generated reset states, in the fused
    kernel's row format: packed grid (P, W*H) and scalars (P, NSCAL) int32
    (``ops.fused_step.pack_rows``), plus the mission tokens (P, L) int32
    and the family's ``extra`` tensors (P, ...), or None. A pool of T rows
    is also what :func:`presample_reset_states` returns: one broadcast
    reset row per upcoming step."""

    grid: torch.Tensor
    scal: torch.Tensor
    mission: torch.Tensor
    width: int
    height: int
    extra: dict | None = None

    @property
    def size(self) -> int:
        return self.grid.shape[0]

    def rows(self, idx) -> "LayoutPool":
        """The pool restricted to rows ``idx`` (an int keeps one row)."""
        if isinstance(idx, int):
            idx = slice(idx, idx + 1)
        return self._map(lambda x: x[idx])

    def to(self, device) -> "LayoutPool":
        return self._map(lambda x: x.to(device))

    def _map(self, fn) -> "LayoutPool":
        extra = (None if self.extra is None
                 else {k: fn(v) for k, v in self.extra.items()})
        return dataclasses.replace(self, grid=fn(self.grid),
                                   scal=fn(self.scal),
                                   mission=fn(self.mission), extra=extra)

    def entry(self, i: int) -> EnvState:
        """Pool entry ``i`` as a batch-of-one EnvState (rng zero)."""
        return states_from_pool(self.rows(i))


def pool_from_states(states: EnvState) -> LayoutPool:
    """Serialize a batched EnvState into pool rows."""
    grid, scal = pack_rows(states)
    extra = (None if states.extra is None
             else {k: v.contiguous() for k, v in states.extra.items()})
    return LayoutPool(grid=grid, scal=scal,
                      mission=states.mission.contiguous(),
                      width=states.grid.shape[1], height=states.grid.shape[2],
                      extra=extra)


def states_from_pool(rows: LayoutPool) -> EnvState:
    """Pool rows as a batched EnvState (rng zero), one env per row."""
    core = unpack_rows(rows.grid, rows.scal, rows.width, rows.height)
    return EnvState(**core, mission=rows.mission,
                    rng=torch.zeros((rows.size, 2), dtype=torch.int32,
                                    device=rows.grid.device),
                    extra=rows.extra)


def make_layout_pool(env, generator: torch.Generator,
                     pool_size: int = 1024) -> LayoutPool:
    """A fresh pool of ``pool_size`` independent reset layouts."""
    return pool_from_states(env._gen_grid(generator, pool_size))


def refresh_layout_pool(env, generator: torch.Generator,
                        pool: LayoutPool) -> LayoutPool:
    """Regenerate every pool entry (between train steps)."""
    return make_layout_pool(env, generator, pool.size)


def presample_reset_states(generator: torch.Generator, pool: LayoutPool,
                           length: int) -> LayoutPool:
    """``length`` broadcast reset rows drawn uniformly from the pool, one
    per upcoming rollout step."""
    idx = torch.randint(0, pool.size, (length,), generator=generator,
                        device=pool.grid.device)
    return pool.rows(idx)


def draw_pool_row(generator: torch.Generator, pool: LayoutPool) -> LayoutPool:
    """The broadcast-row pool draw: ONE row for this step."""
    return presample_reset_states(generator, pool, 1)


def _apply_broadcast_reset(keys, st: EnvState, done, reset_row: LayoutPool):
    """The episode fields of the broadcast reset: finished envs take the
    row's mission and ``extra`` and a fresh rng, ``keys ^ RESET_RNG_SALT``.

    The row's grid and agent fields are selected inside the fused step
    (kernel or plain version), after the transition and before the one
    observation, the order of the JAX package's ``_apply_broadcast_reset``;
    this completes the select on the fields the kernel does not carry."""
    salt = torch.as_tensor(RESET_RNG_SALT, device=keys.device)
    d = done[:, None]
    kw = {}
    if st.extra is not None:
        kw["extra"] = {
            k: torch.where(done.reshape((-1,) + (1,) * (v.ndim - 1)),
                           reset_row.extra[k], v)
            for k, v in st.extra.items()}
    return st.replace(
        rng=torch.where(d, keys ^ salt, st.rng),
        mission=torch.where(d, reset_row.mission, st.mission), **kw)


def broadcast_candidates(keys, reset_row: LayoutPool) -> EnvState:
    """The reset states of the broadcast row for the three-stage select:
    the row (batch of one, broadcast by the select) with the fresh rng
    ``keys ^ RESET_RNG_SALT``."""
    salt = torch.as_tensor(RESET_RNG_SALT, device=keys.device)
    return states_from_pool(reset_row).replace(rng=keys ^ salt)


def autoreset_step_presampled(env, keys, states: EnvState, actions,
                              reset_row: LayoutPool):
    """BATCHED auto-resetting step with this step's broadcast reset row
    (see :func:`presample_reset_states`): for an env without step hooks one
    fused step with the row, then the episode fields; for a hook env the
    hook step, the row selected in PyTorch and the observe entry. Returns
    (obs, state, reward, terminated, truncated, info); reward and flags
    report the finishing step."""
    if has_step_hooks(env):
        return autoreset_step_select(env, states, actions,
                                     broadcast_candidates(keys, reset_row),
                                     keys)
    require_core_dynamics(env)
    st, obs, reward, term, trunc = fused_rollout(
        env.params, states, _actions(actions)[None],
        reset_grid=reset_row.grid, reset_scal=reset_row.scal)
    term, trunc = term[0], trunc[0]
    st = _apply_broadcast_reset(keys, st, term | trunc, reset_row)
    return env._obs_dict(obs[0], st), st, reward[0], term, trunc, {}


def autoreset_step_pooled(env, keys, states: EnvState, actions,
                          pool: LayoutPool, generator: torch.Generator,
                          independent: bool = False):
    """BATCHED auto-resetting step from a layout pool.

    Default, broadcast-row mode: ONE pool row drawn for this step, and every
    env finishing on it restarts from that row (per-env marginals stay
    uniform over the pool). ``independent=True``: every env draws its own
    pool row (:func:`draw_independent_rows`), so same-step finishers do not
    share a layout; it steps, selects and observes in three stages."""
    if not independent:
        return autoreset_step_presampled(env, keys, states, actions,
                                         draw_pool_row(generator, pool))
    idx = draw_independent_rows(generator, pool, states.batch_size)
    return autoreset_step_select(env, states, actions,
                                 independent_candidates(keys, pool, idx),
                                 keys)


def draw_independent_rows(generator: torch.Generator, pool: LayoutPool,
                          num_envs: int) -> torch.Tensor:
    """One uniform pool row index per env, (B,) int64."""
    return torch.randint(0, pool.size, (num_envs,), generator=generator,
                         device=pool.grid.device)


def independent_candidates(keys, pool: LayoutPool, idx) -> EnvState:
    """The reset states of the independent pool draw: pool row ``idx[b]``
    for env b, with the fresh rng ``keys ^ RESET_RNG_SALT``."""
    salt = torch.as_tensor(RESET_RNG_SALT, device=keys.device)
    return states_from_pool(pool.rows(idx)).replace(rng=keys ^ salt)


def select_reset_states(done, states: EnvState,
                        candidates: EnvState) -> EnvState:
    """Every tensor of ``candidates`` (B reset states, one per env, or one
    state broadcast to all), ``extra`` included, selected into the envs
    where ``done``."""
    new = candidates.tensors()

    def pick(cur, k):
        mask = done.reshape((-1,) + (1,) * (cur.ndim - 1))
        return torch.where(mask, new[k], cur)

    return states.with_tensors({k: pick(v, k)
                                for k, v in states.tensors().items()})


def autoreset_step_select(env, states: EnvState, actions,
                          candidates: EnvState, keys=None):
    """BATCHED auto-resetting step with one given reset state per env: the
    step without a reset row (:func:`hooked_step`; ``keys`` are the step
    keys, which only a hook env reads), ``candidates`` selected into the
    finished envs (:func:`select_reset_states`), then the observation of
    the selected states (the kernel's observe entry on the card). Returns
    (obs, state, reward, terminated, truncated, info)."""
    st, _, reward, term, trunc = hooked_step(env, keys, states, actions)
    st = select_reset_states(term | trunc, st, candidates)
    return env._observe(st), st, reward, term, trunc, {}


def autoreset_step(env, keys, states: EnvState, actions,
                   generator: torch.Generator):
    """Generic auto-resetting step through ``env.step``/``env.reset`` of
    any env-like, wrapper stacks included (``states`` an EnvState or a
    ``wrappers.WrappedState``): a finishing episode is replaced by a
    freshly generated layout, so every reset is an independent draw (the
    distribution reference path). Both the stepped and the reset
    observation are computed and selected; :meth:`MiniGridEnv.
    step_autoreset` observes once instead."""
    obs, st, reward, term, trunc, info = env.step(keys, states, actions)
    done = term | trunc
    obs_r, st_r = env.reset(generator, states.batch_size)
    return (select_obs(done, obs, obs_r), select_reset_states(done, st, st_r),
            reward, term, trunc, info)


def select_obs(done, obs, obs_r):
    """The reset observations ``obs_r`` selected into the envs where
    ``done``: a dict of (B, ...) tensors, or one tensor (a wrapper's array
    observation)."""
    def pick(cur, new):
        return torch.where(done.reshape((-1,) + (1,) * (cur.ndim - 1)), new,
                           cur)

    if isinstance(obs, dict):
        return {k: pick(v, obs_r[k]) for k, v in obs.items()}
    return pick(obs, obs_r)


# ---------------------------------------------------------------------------
# Fresh-buffer exact-distribution auto-reset (minigrid_tpu/envs/base.py
# :338-432): a rollout pre-generates N fresh layouts and consumes them
# through a cursor; the r-th env finishing a step takes row cursor + r, so
# every reset is an independent fresh layout used at most once.
# ---------------------------------------------------------------------------

def presample_fresh_reset_states(env, generator: torch.Generator,
                                 n: int) -> EnvState:
    """``n`` independent fresh layouts, stacked (size it above the chunk's
    expected consumption; see ``models.ppo.fresh_sizes``)."""
    return env._gen_grid(generator, n)


def autoreset_step_fresh(env, keys, states: EnvState, actions,
                         buffer: EnvState, cursor, window: int = 32):
    """BATCHED auto-resetting step with exact reset distribution: envs
    finishing this step are ranked (exclusive cumsum of the done mask), the
    env of rank r restarts from buffer row ``cursor + r`` and the cursor
    advances by the number of finishers. ``cursor`` is a device int32
    scalar (no host sync). Ranks beyond ``window - 1`` share the last row of
    the window, and the window start clamps at ``n_buf - window``;
    ``info["reset_overflow"]`` counts the finishers whose reset was not an
    untouched fresh row for either reason. Returns ``(obs, state, reward,
    terminated, truncated, info, new_cursor)``."""
    st, _, reward, term, trunc = hooked_step(env, keys, states, actions)
    obs, st, info, cursor = _fresh_select(env, keys, st, term | trunc,
                                          buffer, cursor, window)
    return obs, st, reward, term, trunc, info, cursor


def fresh_candidates(keys, done, buffer: EnvState, cursor, window: int):
    """The routing of the fresh reset: (candidates, reset_overflow,
    new_cursor). Candidate b is buffer row ``start + min(rank_b, window -
    1)`` with ``start = min(cursor, n_buf - window)``, gathered by device
    indices, and the fresh rng ``keys ^ RESET_RNG_SALT``."""
    n_buf = buffer.batch_size
    if not 1 <= window <= n_buf:
        raise ValueError(f"window must be in [1, {n_buf}], got {window}")
    d = done.to(torch.int32)
    rank = torch.cumsum(d, 0, dtype=torch.int32) - d
    slot = torch.clamp(rank, max=window - 1)
    start = torch.clamp(cursor, max=n_buf - window)
    rows = (start + slot).to(torch.int64)
    salt = torch.as_tensor(RESET_RNG_SALT, device=keys.device)
    cand = buffer.map(lambda x: x[rows]).replace(rng=keys ^ salt)
    overrun_rows = torch.clamp(cursor - (n_buf - window), min=0)
    overflow = (done & ((rank >= window) | (slot < overrun_rows))).sum(
        dtype=torch.int32)
    return cand, overflow, cursor + d.sum(dtype=torch.int32)


def _fresh_select(env, keys, st: EnvState, done, buffer: EnvState, cursor,
                  window: int):
    """The routing/select/observe tail of :func:`autoreset_step_fresh`.
    Returns ``(obs, state, info, new_cursor)``."""
    cand, overflow, cursor = fresh_candidates(keys, done, buffer, cursor,
                                              window)
    st = select_reset_states(done, st, cand)
    return env._observe(st), st, {"reset_overflow": overflow}, cursor


def require_bare_env(env, what: str):
    """Raise unless ``env`` is a bare :class:`MiniGridEnv`: the batched
    fast-path functions of this module run its step and observation
    directly."""
    if not isinstance(env, MiniGridEnv):
        raise NotImplementedError(
            f"{what} operates on bare envs (got {type(env).__name__})")


def hooked_step(env, keys, states: EnvState, actions):
    """One step of every env through the fused step without a reset row
    (the kernel's step entry on the card), with the env's step hooks
    around it as the JAX package's ``step_state`` orders them: the action
    transform and ``_pre_step`` (which may read ``keys``) before,
    ``_post_step`` and the replaced ``terminated`` after. ``extra``, ``rng``
    and ``mission`` pass through the fused step untouched.

    The transition wrappers composed into the env (``env.transitions``,
    outermost first; ``wrappers._composed_step_env``) wrap those hooks as
    the JAX package's composed ``step_state`` does: their action pre-maps
    outermost first before everything, their outcome post-maps innermost
    first after everything, each seeing the pre-step state and the action
    it forwarded inward.

    Returns ``(state, obs, reward, terminated, truncated)``: ``obs`` is the
    step entry's packed observation when the hooks left the grid, agent
    and carried object of the state it produced in place (``_post_step``
    returned that very state, and the outcome post-maps changed no
    observed field), else None."""
    prev = states
    action, forwarded = _actions(actions), []
    for w in env.transitions:
        action = _actions(w.transform_action(keys, prev, action))
        forwarded.append(action)
    action = _actions(env._transform_action(states, action))
    states = env._pre_step(keys, states, action)
    st, obs, reward, term, _ = fused_rollout(env.params, states, action[None])
    new, reward, term = env._post_step(prev, st, action, reward[0], term[0])
    obs = obs[0] if new is st else None
    new = new.replace(terminated=term)
    trunc = new.truncated
    for w, a in zip(env.transitions[::-1], forwarded[::-1]):
        out, reward, term, trunc = w.transform_outcome(
            keys, prev, new, a, reward, term, trunc)
        if any(getattr(out, f) is not getattr(new, f) for f in OBSERVED):
            obs = None
        new = out
    return new, obs, reward, term, trunc


def _actions(actions) -> torch.Tensor:
    return torch.as_tensor(actions).to(torch.int32).contiguous()


class MiniGridEnv:
    """Base batched env. Instances are static config (``params``) and the
    device; all episode data lives in the batched :class:`EnvState`."""

    reward_range = (0, 1)  # minigrid_env.py:61; DynamicObstacles overrides
    # transition wrappers composed into this env's step, outermost first
    # (set on a copy of the env by ``wrappers._composed_step_env``)
    transitions: tuple = ()

    @property
    def num_actions(self) -> int:
        return NUM_ACTIONS

    def __init__(self, params: EnvParams, device=None):
        self.params = params
        self.device = resolve_device(device)

    def packed(self) -> "MiniGridEnv":
        """Copy of this env emitting packed observations."""
        return self.replace_params(packed_obs=True)

    def replace_params(self, **kw) -> "MiniGridEnv":
        env = object.__new__(type(self))
        env.__dict__.update(self.__dict__)
        env.params = dataclasses.replace(self.params, **kw)
        return env

    # -- mission ---------------------------------------------------------
    def default_mission(self) -> str:
        return "get to the green goal square"

    def mission_tokens(self) -> torch.Tensor:
        return torch.as_tensor(tokenize(self.default_mission()),
                               device=self.device)

    def mission_space(self):
        """The Gymnasium mission space (the reference passes one to every
        env constructor, e.g. minigrid/envs/doorkey.py:65); envs with
        placeholder missions override with their template space."""
        from minigrid_tpu_torch.core.mission_space import (ConstantMission,
                                                           MissionSpace)

        return MissionSpace(
            mission_func=ConstantMission(self.default_mission()))

    def mission_text(self, state_or_tokens, b: int = 0) -> str:
        """The mission string of env ``b`` of a batched state, or of a
        (L,) or (B, L) token tensor."""
        tokens = getattr(state_or_tokens, "mission", state_or_tokens)
        tokens = torch.as_tensor(tokens)
        if tokens.ndim == 2:
            tokens = tokens[b]
        return detokenize(tokens.cpu().numpy())

    # -- construction ----------------------------------------------------
    def make_state(self, grid, agent_pos, agent_dir, rng,
                   mission=None, extra=None) -> EnvState:
        """A batch of fresh episodes from per-env grids and agent poses;
        ``extra`` is the family's dict of (B, ...) tensors, or None."""
        B = grid.shape[0]
        dev = grid.device
        if mission is None:
            mission = self.mission_tokens().expand(B, MISSION_LEN)
        return EnvState(
            grid=grid.contiguous(),
            agent_pos=torch.as_tensor(agent_pos, device=dev).to(
                torch.int32).expand(B, 2).contiguous(),
            agent_dir=torch.as_tensor(agent_dir, device=dev).to(
                torch.int32).expand(B).contiguous(),
            carrying=torch.as_tensor(C.EMPTY_CELL, device=dev).expand(
                B, C.NUM_CHANNELS).contiguous(),
            step_count=torch.zeros((B,), dtype=torch.int32, device=dev),
            terminated=torch.zeros((B,), dtype=torch.bool, device=dev),
            truncated=torch.zeros((B,), dtype=torch.bool, device=dev),
            mission=mission.contiguous(),
            rng=rng,
            extra=extra,
        )

    def _gen_grid(self, generator: torch.Generator, num_envs: int) -> EnvState:
        raise NotImplementedError

    # -- API -------------------------------------------------------------
    def _obs_dict(self, packed: torch.Tensor, state: EnvState) -> dict:
        view = ({"packed": packed} if self.params.packed_obs
                else {"image": packed_to_image(packed)})
        return view | {"direction": state.agent_dir,
                       "mission": state.mission}

    def _observe(self, state: EnvState) -> dict:
        """The observation of ``state`` (the kernel's observe entry on the
        card, ``gen_obs`` on the CPU)."""
        return self._obs_dict(fused_observe(self.params, state), state)

    def reset(self, generator: torch.Generator, num_envs: int):
        state = self._gen_grid(generator, num_envs)
        return self._observe(state), state

    def reset_staggered(self, generator: torch.Generator, num_envs: int):
        """Reset with a uniform random initial ``step_count`` in
        [0, max_steps) per env, so episode ends spread over the steps
        instead of arriving in batch-wide truncation waves (essential for
        the broadcast-row pooled reset)."""
        obs, state = self.reset(generator, num_envs)
        off = torch.randint(0, self.params.max_steps, (num_envs,),
                            generator=generator, device=self.device,
                            dtype=torch.int32)
        return obs, state.replace(step_count=off)

    def _transform_action(self, state: EnvState, action):
        return action

    def _pre_step(self, keys, state: EnvState, action) -> EnvState:
        return state

    def _post_step(self, prev: EnvState, state: EnvState, action, reward,
                   terminated):
        return state, reward, terminated

    def step_state(self, keys, state: EnvState, action):
        """The state transition alone, hooks included: the fused step (the
        kernel on the card) between the hooks, :func:`hooked_step`.
        Returns (state, reward, terminated, truncated)."""
        st, _, reward, term, trunc = hooked_step(self, keys, state, action)
        return st, reward, term, trunc

    def step(self, keys, state: EnvState, action):
        """One step of every env through the fused step (the kernel on the
        card) and the env's hooks. The step entry's observation is kept
        when ``_post_step`` left the state alone, else the state is
        observed again. Returns (obs, state, reward, terminated, truncated,
        info)."""
        st, obs, reward, term, trunc = hooked_step(self, keys, state, action)
        if obs is None:
            obs = fused_observe(self.params, st)
        return self._obs_dict(obs, st), st, reward, term, trunc, {}

    def step_autoreset(self, keys, states: EnvState, actions,
                       generator: torch.Generator):
        """Step with the regen auto-reset: a fresh ``_gen_grid`` batch is
        generated every step and selected into the finished envs, whose
        observation is then taken once on the selected state. Reward and
        flags report the finishing step."""
        return autoreset_step_select(
            self, states, actions,
            self._gen_grid(generator, states.batch_size), keys)

    def step_autoreset_presampled(self, keys, states: EnvState, actions,
                                  reset_row: LayoutPool):
        return autoreset_step_presampled(self, keys, states, actions,
                                         reset_row)

    def step_autoreset_pooled(self, keys, states: EnvState, actions,
                              pool: LayoutPool, generator: torch.Generator,
                              independent: bool = False):
        return autoreset_step_pooled(self, keys, states, actions, pool,
                                     generator, independent)

    def step_autoreset_fresh(self, keys, states: EnvState, actions,
                             buffer: EnvState, cursor, window: int = 32):
        return autoreset_step_fresh(self, keys, states, actions, buffer,
                                    cursor, window)

    def presample_fresh(self, generator: torch.Generator,
                        n: int) -> EnvState:
        return presample_fresh_reset_states(self, generator, n)

    def make_pool(self, generator: torch.Generator,
                  pool_size: int = 1024) -> LayoutPool:
        return make_layout_pool(self, generator, pool_size)

    def generator(self, seed: int) -> torch.Generator:
        """A ``torch.Generator`` on this env's device, seeded."""
        return torch.Generator(device=self.device).manual_seed(seed)
