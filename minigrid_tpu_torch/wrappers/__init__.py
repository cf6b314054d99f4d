"""The wrapper layer, batched.

Counterpart of ``minigrid_tpu/wrappers/__init__.py`` (the reference's 15
Gymnasium wrappers, ``minigrid/wrappers.py:15-882``): composable transforms
of a batched env. Observation transforms are functions of the batched
(obs, state); wrappers that carry memory (seed cycling, visit counts, a goal
cache) keep it in a :class:`WrappedState` whose ``wrapper`` tensor has a
leading batch axis, beside the ``inner`` state it wraps.

Every method takes and returns batch-leading tensors, as the bare envs'
do: ``reset(generator, num_envs)``, ``step(keys, state, action)``,
``step_autoreset(keys, state, action, generator)`` (the exact path: a fresh
layout per reset) and the batched fast paths ``step_autoreset_presampled``,
``step_autoreset_pooled`` and ``step_autoreset_fresh``.

On the fast paths a stack runs as its base env (``_fast_plan``):

- stateless observation wrappers apply their transforms to the base env's
  observation of the post-select states;
- transition wrappers (NoDeath, StochasticActionWrapper) are composed into
  a copy of the base env (:func:`_composed_step_env`) whose ``transitions``
  ``envs/base.py::hooked_step`` applies around the env's own hooks, so a
  stack with one steps on the hook path: the kernel's step entry without a
  reset row, the select in PyTorch, then the observe entry (the broadcast
  row entry would reset a lava death inside the launch, before NoDeath
  could cancel it);
- one stateful wrapper, outermost (ActionBonus, PositionBonus,
  DirectionObsWrapper; :class:`_StatefulFastPath`), threads its
  WrappedState batch: the step without a row, its bookkeeping on the
  post-step states, the select, the observe entry.

ReseedWrapper dictates its reset layouts, so it stays on the exact path.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import mission as M
from minigrid_tpu_torch.core.actions import Actions
from minigrid_tpu_torch.core.obs import packed_to_image
from minigrid_tpu_torch.core.step import front_cell
from minigrid_tpu_torch.core.types import EnvState
from minigrid_tpu_torch.envs.base import (_actions, _fresh_select,
                                          autoreset_step,
                                          broadcast_candidates,
                                          draw_pool_row, hooked_step,
                                          select_obs, select_reset_states)
from minigrid_tpu_torch.envs.common import hash_scores
from minigrid_tpu_torch.ops.fused_step import check_view_size, fused_observe
from minigrid_tpu_torch.render import get_frame

INNER = "inner."


@dataclasses.dataclass(frozen=True)
class WrappedState:
    """A wrapper's per-env state beside the state it wraps, batched:
    ``inner`` is the wrapped stack's state (an EnvState or another
    WrappedState), ``wrapper`` this wrapper's (B, ...) tensor (visit
    counts, a goal cache, a seed cycle index). It names its tensors as
    :class:`EnvState` does (``inner.`` before the inner state's names, and
    ``wrapper``), so the selects and ``map`` carry it alike."""

    inner: Any
    wrapper: torch.Tensor

    def replace(self, **kw) -> "WrappedState":
        return dataclasses.replace(self, **kw)

    @property
    def batch_size(self) -> int:
        return self.inner.batch_size

    @property
    def device(self) -> torch.device:
        return self.inner.device

    def tensors(self) -> dict:
        out = {INNER + k: v for k, v in self.inner.tensors().items()}
        out["wrapper"] = self.wrapper
        return out

    def with_tensors(self, tensors: dict) -> "WrappedState":
        inner = self.inner.with_tensors({k[len(INNER):]: v
                                         for k, v in tensors.items()
                                         if k.startswith(INNER)})
        return self.replace(inner=inner,
                            wrapper=tensors.get("wrapper", self.wrapper))

    def map(self, fn) -> "WrappedState":
        return self.with_tensors({k: fn(v)
                                  for k, v in self.tensors().items()})


def _inner_env_state(state) -> EnvState:
    while isinstance(state, WrappedState):
        state = state.inner
    return state


def _replace_inner(state, new_env_state):
    if isinstance(state, WrappedState):
        return state.replace(inner=_replace_inner(state.inner,
                                                  new_env_state))
    return new_env_state


def _reset_from(env, states: EnvState):
    """``env``'s reset (a wrapper stack's or a bare env's) with the given
    bare layouts in place of generated ones."""
    if isinstance(env, Wrapper):
        return env.reset_from(states)
    return env._observe(states), states


class Wrapper:
    """Base pass-through wrapper; attributes it lacks come from the env it
    wraps."""

    def __init__(self, env):
        self.env = env

    def __getattr__(self, name):
        if name == "env":  # not yet set (e.g. mid-copy): don't recurse
            raise AttributeError(name)
        return getattr(self.env, name)

    def _on_reset(self, obs, state):
        """This wrapper's part of a reset, on the reset (obs, state) of the
        stack it wraps."""
        return obs, state

    def reset(self, generator: torch.Generator, num_envs: int):
        return self._on_reset(*self.env.reset(generator, num_envs))

    def reset_from(self, states: EnvState):
        """This stack's reset with the given bare layouts (what
        :class:`ReseedWrapper` resets to)."""
        return self._on_reset(*_reset_from(self.env, states))

    def step(self, keys, state, action):
        return self.env.step(keys, state, action)

    def step_autoreset(self, keys, state, action, generator):
        return autoreset_step(self, keys, state, action, generator)

    def reset_staggered(self, generator: torch.Generator, num_envs: int):
        """This stack's reset (so that wrapper state is initialised), then
        a uniform random initial ``step_count`` in [0, max_steps) per env
        on the innermost state (see ``MiniGridEnv.reset_staggered``)."""
        obs, state = self.reset(generator, num_envs)
        off = torch.randint(0, self.params.max_steps, (num_envs,),
                            generator=generator, device=self.device,
                            dtype=torch.int32)
        e = _inner_env_state(state)
        return obs, _replace_inner(state, e.replace(step_count=off))

    # -- batched fast paths ----------------------------------------------
    def _fast_plan(self):
        """(base env, [observation wrappers, innermost first], [transition
        wrappers, outermost first]). Raises NotImplementedError for a
        stack holding a wrapper that is neither a stateless
        :class:`ObservationWrapper` nor a :class:`TransitionWrapper` (one
        stateful wrapper, outermost, overrides this)."""
        obs_chain, trans_chain, env = [], [], self
        while isinstance(env, Wrapper):
            if isinstance(env, ObservationWrapper):
                obs_chain.append(env)
            elif isinstance(env, TransitionWrapper):
                trans_chain.append(env)
            else:
                raise NotImplementedError(
                    f"{type(env).__name__} carries per-env wrapper state; "
                    "the pooled/fresh fast paths compose stacks of "
                    "stateless ObservationWrappers and TransitionWrappers, "
                    "under at most one stateful wrapper, outermost: use "
                    "step_autoreset (exact resets)")
            env = env.env
        return env, obs_chain[::-1], trans_chain

    def _fast_base(self):
        """(the env the batched reset paths step, the observation chain):
        the base env, or a copy carrying the stack's transition wrappers
        (:func:`_composed_step_env`). A stack does not change once built,
        so both are made on first use and kept (in this wrapper's own
        ``__dict__``: a lookup through ``__getattr__`` would find an inner
        wrapper's)."""
        fast = self.__dict__.get("_fast")
        if fast is None:
            base, obs_chain, trans = self._fast_plan()
            fast = (_composed_step_env(base, trans), tuple(obs_chain))
            self.__dict__["_fast"] = fast
        return fast

    def check_fast_paths(self) -> None:
        """Raises NotImplementedError if the batched pooled/fresh paths
        cannot run this stack (stacked stateful wrappers, ReseedWrapper)."""
        self._fast_base()

    def _apply_obs_chain(self, obs, states):
        for w in self._fast_base()[1]:
            obs = w.observation(obs, states)
        return obs

    def step_autoreset_presampled(self, keys, states, actions, reset_row):
        base, _ = self._fast_base()
        obs, st, r, te, tr, i = base.step_autoreset_presampled(
            keys, states, actions, reset_row)
        return self._apply_obs_chain(obs, st), st, r, te, tr, i

    def step_autoreset_pooled(self, keys, states, actions, pool, generator,
                              independent: bool = False):
        base, _ = self._fast_base()
        obs, st, r, te, tr, i = base.step_autoreset_pooled(
            keys, states, actions, pool, generator, independent)
        return self._apply_obs_chain(obs, st), st, r, te, tr, i

    def step_autoreset_fresh(self, keys, states, actions, buffer, cursor,
                             window: int = 32):
        base, _ = self._fast_base()
        obs, st, r, te, tr, i, cur = base.step_autoreset_fresh(
            keys, states, actions, buffer, cursor, window)
        return self._apply_obs_chain(obs, st), st, r, te, tr, i, cur

    def make_pool(self, generator: torch.Generator, pool_size: int = 1024):
        base, _, _ = self._fast_plan()  # validates the stack
        return base.make_pool(generator, pool_size)

    def presample_fresh(self, generator: torch.Generator, n: int):
        base, _, _ = self._fast_plan()
        return base.presample_fresh(generator, n)

    def packed(self) -> "Wrapper":
        """This stack over a packed-observation base env. Wrappers that
        read the uint8 image fail (no "image" key); mission and direction
        transforms and :class:`ImgObsWrapper` compose."""
        w = copy.copy(self)
        w.env = self.env.packed()
        w.__dict__.pop("_fast", None)  # the plan of the unpacked stack
        return w

    def unwrapped(self):
        """The innermost bare environment."""
        env = self.env
        while isinstance(env, Wrapper):
            env = env.env
        return env


class ObservationWrapper(Wrapper):
    """Stateless observation transform; override :meth:`observation`
    (batched obs, the batched bare state)."""

    def observation(self, obs, state):
        raise NotImplementedError

    def _on_reset(self, obs, state):
        return self.observation(obs, _inner_env_state(state)), state

    def step(self, keys, state, action):
        obs, state, r, te, tr, i = self.env.step(keys, state, action)
        return (self.observation(obs, _inner_env_state(state)), state, r, te,
                tr, i)


# per-layer salts of the transforms' draws (the JAX package's fold_in
# salts), so that a transform's draws never repeat the step's own
_TA_SALT = 0x7A11AC  # action pre-map stream
_TO_SALT = 0x0A71C0  # outcome post-map stream


class TransitionWrapper(Wrapper):
    """Memoryless per-env action/outcome transform over bare EnvStates
    (the shape of the reference's ``StochasticActionWrapper`` and
    ``NoDeath``, minigrid/wrappers.py:785-882). Override either hook; both
    default to identity:

    - ``transform_action(keys, env_state, action) -> action`` runs before
      the transition, on the pre-step state;
    - ``transform_outcome(keys, prev_env_state, env_state, action, reward,
      terminated, truncated) -> (env_state, reward, terminated,
      truncated)`` runs after it, seeing the pre-step state, the post-step
      state and the action this wrapper forwarded inward.

    ``keys`` are the step's (B, 2) int32 keys; a transform that draws
    hashes them with its layer's salt, ``_TA_SALT + _t_depth`` (or
    ``_TO_SALT + _t_depth``), so stacked transforms draw apart. In a stack
    the action pre-maps apply outermost first and the outcome post-maps
    innermost first, the order nested ``step`` calls give; the fast paths
    compose them into the base env's step (:func:`_composed_step_env`)."""

    def __init__(self, env):
        super().__init__(env)
        # the layer's draw index: the TransitionWrappers beneath it
        d, e = 0, env
        while isinstance(e, Wrapper):
            d += isinstance(e, TransitionWrapper)
            e = e.env
        self._t_depth = d

    def transform_action(self, keys, env_state, action):
        return action

    def transform_outcome(self, keys, prev_env_state, env_state, action,
                          reward, terminated, truncated):
        return env_state, reward, terminated, truncated

    def step(self, keys, state, action):
        e_prev = _inner_env_state(state)
        a = _actions(self.transform_action(keys, e_prev, _actions(action)))
        obs, new_state, r, te, tr, i = self.env.step(keys, state, a)
        e_new = _inner_env_state(new_state)
        e2, r, te, tr = self.transform_outcome(keys, e_prev, e_new, a, r, te,
                                               tr)
        if e2 is not e_new:
            new_state = _replace_inner(new_state, e2)
        return obs, new_state, r, te, tr, i


def _composed_step_env(base, trans_chain):
    """A copy of ``base`` carrying the transition wrappers ``trans_chain``
    (outermost first) as its ``transitions``: ``envs/base.py::hooked_step``
    applies their transforms around the env's own hooks, and
    ``ops.fused_step.has_step_hooks`` sends every step of it down the hook
    path (``require_core_dynamics`` refuses it the reset-row entry)."""
    if not trans_chain:
        return base
    env = object.__new__(type(base))
    env.__dict__.update(base.__dict__)
    env.transitions = tuple(trans_chain)
    return env


class ReseedWrapper(Wrapper):
    """Deterministic seed cycling on reset (wrappers.py:15-66). Each seed's
    layout is generated once, from a generator seeded with that seed, into
    ``layouts`` (one row per seed); a reset ignores its generator, env b
    takes row ``idx_b`` and the next index, ``(idx_b + 1) % len(seeds)``,
    goes into ``WrappedState.wrapper`` for its next auto-reset."""

    def __init__(self, env, seeds=(0,), seed_idx=0):
        super().__init__(env)
        base = self.unwrapped()
        rows = [base._gen_grid(torch.Generator(device=base.device)
                               .manual_seed(int(s)), 1) for s in seeds]
        self.layouts = rows[0].with_tensors(
            {k: torch.cat([r.tensors()[k] for r in rows])
             for k in rows[0].tensors()})
        self.seed_idx = seed_idx

    def reset(self, generator, num_envs: int, _idx=None):
        if _idx is None:
            _idx = torch.full((num_envs,), self.seed_idx, dtype=torch.int32,
                              device=self.layouts.device)
        layouts = self.layouts.map(lambda x: x[_idx.to(torch.int64)])
        obs, state = _reset_from(self.env, layouts)
        n = self.layouts.batch_size
        return obs, WrappedState(inner=state,
                                 wrapper=((_idx + 1) % n).to(torch.int32))

    def reset_from(self, states: EnvState):
        return self.reset(None, states.batch_size)  # the seeds dictate

    def step(self, keys, state, action):
        obs, inner, r, te, tr, i = self.env.step(keys, state.inner, action)
        return obs, state.replace(inner=inner), r, te, tr, i

    def step_autoreset(self, keys, state, action, generator):
        obs, st, r, te, tr, i = self.step(keys, state, action)
        done = te | tr
        obs_r, st_r = self.reset(None, st.batch_size, _idx=state.wrapper)
        return (select_obs(done, obs, obs_r),
                select_reset_states(done, st, st_r), r, te, tr, i)


class _StatefulFastPath(Wrapper):
    """The batched fast paths of ONE stateful wrapper, outermost: its
    WrappedState batch steps through the inner stack's base env (the
    kernel's step entry without a reset row, transition wrappers
    composed), then three hooks place the wrapper's bookkeeping around the
    reset select:

    - ``_post_step(wrapper, st, r, actions) -> (r, wrapper')`` on the
      post-step, pre-select states (a bonus records the visit of the step
      just taken, which belongs to the finishing episode; this is why the
      step cannot take the reset-row entry, which selects inside the
      launch);
    - ``_post_select(wrapper', st_selected) -> wrapper''`` on the
      post-select states;
    - ``_augment_obs(obs, st_selected, wrapper'') -> obs`` after the inner
      observation chain."""

    def _fast_plan(self):
        if isinstance(self.env, _StatefulFastPath):
            raise NotImplementedError(
                f"{type(self).__name__} wraps {type(self.env).__name__}: "
                "the batched fast paths support ONE stateful wrapper, "
                "outermost: use step_autoreset (exact resets) for stacked "
                "stateful wrappers")
        if not isinstance(self.env, Wrapper):
            return self.env, [], []
        return self.env._fast_plan()

    def _post_step(self, wrapper, st, r, actions):
        return r, wrapper

    def _post_select(self, wrapper, st):
        return wrapper

    def _augment_obs(self, obs, st, wrapper):
        return obs

    def _batched_step(self, keys, states, actions):
        if not isinstance(states, WrappedState):
            raise TypeError(
                f"{type(self).__name__} batched fast paths take the "
                "WrappedState batch of this wrapper's reset")
        env, _ = self._fast_base()
        st, _, r, te, tr = hooked_step(env, keys, states.inner, actions)
        r, w = self._post_step(states.wrapper, st, r, actions)
        return env, st, r, te, tr, w

    def _finish(self, obs, st, w):
        w = self._post_select(w, st)
        obs = self._augment_obs(self._apply_obs_chain(obs, st), st, w)
        return obs, WrappedState(inner=st, wrapper=w)

    def step_autoreset_presampled(self, keys, states, actions, reset_row):
        env, st, r, te, tr, w = self._batched_step(keys, states, actions)
        st = select_reset_states(te | tr, st,
                                 broadcast_candidates(keys, reset_row))
        obs, ws = self._finish(env._observe(st), st, w)
        return obs, ws, r, te, tr, {}

    def step_autoreset_pooled(self, keys, states, actions, pool, generator,
                              independent: bool = False):
        if independent:
            raise NotImplementedError(
                f"{type(self).__name__} fast path supports the "
                "broadcast-row pooled mode only")
        return self.step_autoreset_presampled(
            keys, states, actions, draw_pool_row(generator, pool))

    def step_autoreset_fresh(self, keys, states, actions, buffer, cursor,
                             window: int = 32):
        env, st, r, te, tr, w = self._batched_step(keys, states, actions)
        obs, st, info, cursor = _fresh_select(env, keys, st, te | tr, buffer,
                                              cursor, window)
        obs, ws = self._finish(obs, st, w)
        return obs, ws, r, te, tr, info, cursor


class _CountBonus(_StatefulFastPath):
    """Exploration bonus ``scale / sqrt(N)`` from per-env visit counts in
    the WrappedState ((B, *table) int32), counts persisting across
    auto-resets (the reference keeps them in an instance dict,
    wrappers.py:104/:164). Subclasses give the table's shape and each
    env's flat index into it. A visit is one ``scatter_add`` (the JAX
    package's dense one-hot accumulate is a TPU shape; counts and rewards
    are the same)."""

    scale = 1.0

    def _table_shape(self) -> tuple:
        raise NotImplementedError

    def _visit_index(self, env_state, action) -> torch.Tensor:
        raise NotImplementedError

    def _on_reset(self, obs, state):
        counts = torch.zeros((state.batch_size,) + self._table_shape(),
                             dtype=torch.int32, device=state.device)
        return obs, WrappedState(inner=state, wrapper=counts)

    def reset(self, generator, num_envs: int, _counts=None):
        obs, state = super().reset(generator, num_envs)
        if _counts is not None:
            state = state.replace(wrapper=_counts)
        return obs, state

    def _visit(self, counts, env_state, actions, reward):
        """(reward plus the bonus, counts with this step's visits)."""
        B = counts.shape[0]
        idx = self._visit_index(env_state, _actions(actions))[:, None]
        flat = counts.reshape(B, -1).clone()
        flat.scatter_add_(1, idx, torch.ones_like(idx, dtype=torch.int32))
        n = flat.gather(1, idx)[:, 0].to(torch.float32)
        bonus = torch.full_like(n, self.scale) / torch.sqrt(n)
        return reward + bonus, flat.reshape(counts.shape)

    def step(self, keys, state, action):
        obs, inner, r, te, tr, i = self.env.step(keys, state.inner, action)
        r, counts = self._visit(state.wrapper, _inner_env_state(inner),
                                action, r)
        return obs, state.replace(inner=inner, wrapper=counts), r, te, tr, i

    def step_autoreset(self, keys, state, action, generator):
        # the reset keeps this wrapper's counts; the stack beneath it
        # resets whole, so an inner stacked bonus's counts restart (the
        # JAX package's behaviour, kept)
        obs, st, r, te, tr, i = self.step(keys, state, action)
        done = te | tr
        obs_r, st_r = self.reset(generator, st.batch_size,
                                 _counts=st.wrapper)
        return (select_obs(done, obs, obs_r),
                select_reset_states(done, st, st_r), r, te, tr, i)

    def _post_step(self, counts, st, r, actions):
        return self._visit(counts, st, actions, r)


class ActionBonus(_CountBonus):
    """1/sqrt(N(s, a)) exploration bonus (wrappers.py:68-123) over a (W,
    H, 4, 7) table of (position, direction, action) visits per env."""

    def _table_shape(self):
        p = self.params
        return (p.width, p.height, 4, 7)

    def _visit_index(self, e, action):
        p = self.params
        pos = e.agent_pos.to(torch.int64)
        cell = pos[:, 0] * p.height + pos[:, 1]
        return (cell * 4 + e.agent_dir.to(torch.int64)) * 7 + action.to(
            torch.int64)


class PositionBonus(_CountBonus):
    """1/sqrt(N(pos)) bonus (wrappers.py:126-185). The reference accepts a
    ``scale`` argument but sets ``self.scale = 1`` (wrappers.py:161); so
    does this."""

    def __init__(self, env, scale=1):
        super().__init__(env)
        self.scale = 1  # reference wrappers.py:161 ignores the argument

    def _table_shape(self):
        p = self.params
        return (p.width, p.height)

    def _visit_index(self, e, action):
        pos = e.agent_pos.to(torch.int64)
        return pos[:, 0] * self.params.height + pos[:, 1]


class ImgObsWrapper(ObservationWrapper):
    """Image-only observation (wrappers.py:187-214); on a packed env the
    packed view plays the image's role."""

    def observation(self, obs, state):
        return obs["image"] if "image" in obs else obs["packed"]


class OneHotPartialObsWrapper(ObservationWrapper):
    """One-hot type/color/state planes, 20 uint8 bits a cell
    (wrappers.py:217-285)."""

    def observation(self, obs, state):
        img = obs["image"].to(torch.int64)
        planes = [F.one_hot(img[..., 0], C.NUM_OBJECTS),
                  F.one_hot(img[..., 1], C.NUM_COLORS),
                  F.one_hot(img[..., 2], 3)]
        return {**obs, "image": torch.cat(planes, -1).to(torch.uint8)}


class RGBImgObsWrapper(ObservationWrapper):
    """Full-frame RGB image observation (wrappers.py:287-332)."""

    def __init__(self, env, tile_size=8, highlight=True):
        super().__init__(env)
        self.tile_size = tile_size
        self.highlight = highlight

    def observation(self, obs, state):
        img = get_frame(self.env.params, state, highlight=self.highlight,
                        tile_size=self.tile_size)
        return {**obs, "image": img}


class RGBImgPartialObsWrapper(ObservationWrapper):
    """POV RGB image observation (wrappers.py:334-381)."""

    def __init__(self, env, tile_size=8):
        super().__init__(env)
        self.tile_size = tile_size

    def observation(self, obs, state):
        img = get_frame(self.env.params, state, tile_size=self.tile_size,
                        agent_pov=True)
        return {**obs, "image": img}


class FullyObsWrapper(ObservationWrapper):
    """The full symbolic grid with the agent's cell stamped (AGENT, red,
    direction) (wrappers.py:383-426)."""

    def observation(self, obs, state):
        grid = state.grid[..., :3].clone()
        b = torch.arange(state.batch_size, device=state.device)
        pos = state.agent_pos.to(torch.int64)
        d = state.agent_dir.to(torch.uint8)
        grid[b, pos[:, 0], pos[:, 1]] = torch.stack(
            [torch.full_like(d, C.AGENT),
             torch.full_like(d, C.COLOR_TO_IDX["red"]), d], -1)
        return {**obs, "image": grid}


class DictObservationSpaceWrapper(ObservationWrapper):
    """Mission as word indices (wrappers.py:429-553): the native tokens
    (the reference's vocabulary order, ids offset by 1, 0 = pad) cut or
    padded to ``max_words_in_mission``."""

    def __init__(self, env, max_words_in_mission=50):
        super().__init__(env)
        self.max_words = max_words_in_mission

    def observation(self, obs, state):
        m = obs["mission"]
        L = m.shape[-1]
        m = (m[..., :self.max_words] if L >= self.max_words
             else F.pad(m, (0, self.max_words - L)))
        return {**obs, "mission": m}


def _char_tables():
    """Per-vocabulary-word character one-hot blocks for FlatObsWrapper:
    (blocks (VOCAB, max_len, 28) uint8, lens (VOCAB,) int64, max_len)."""
    max_len = max(len(w) for w in M.WORDS) + 1  # + trailing space
    blocks = np.zeros((M.VOCAB_SIZE, max_len, 28), np.uint8)
    lens = np.zeros(M.VOCAB_SIZE, np.int64)
    for word, wid in M.WORD_TO_ID.items():
        for i, ch in enumerate(word):
            if "a" <= ch <= "z":
                ch_no = ord(ch) - ord("a")
            elif ch == ",":
                ch_no = 27
            else:
                raise ValueError(ch)
            blocks[wid, i, ch_no] = 1
        blocks[wid, len(word), 26] = 1  # space separator
        lens[wid] = len(word) + 1
    return blocks, lens, max_len


class FlatObsWrapper(ObservationWrapper):
    """Image + character one-hot mission, flattened (wrappers.py:556-625).

    The characters are reassembled from the mission tokens: each word adds
    its letters and a separating space at its offset, the exclusive cumsum
    of the word lengths. As in the JAX package's ``dynamic_update_slice``,
    a block whose offset runs past the buffer is placed at its last start
    (max-combined with what is there); the last word's trailing space is
    dropped."""

    def __init__(self, env, maxStrLen=96):
        super().__init__(env)
        self.max_str_len = maxStrLen
        self.num_char_codes = 28
        self._blocks, self._lens, self._max_word = _char_tables()

    def observation(self, obs, state):
        tokens = obs["mission"].to(torch.int64)
        dev = tokens.device
        B, L = tokens.shape
        mw, R = self._max_word, self.max_str_len + self._max_word
        n = torch.as_tensor(self._lens, device=dev)[tokens]        # (B, L)
        end = torch.cumsum(n, 1)
        start = (end - n).clamp(max=R - mw)
        rows = start[:, :, None] + torch.arange(mw, device=dev)    # (B, L, mw)
        idx = rows[..., None] * 28 + torch.arange(28, device=dev)
        blocks = torch.as_tensor(self._blocks, device=dev)[tokens]
        out = torch.zeros((B, R * 28), dtype=torch.int32, device=dev)
        out.scatter_reduce_(1, idx.reshape(B, -1),
                            blocks.reshape(B, -1).to(torch.int32), "amax")
        out = out.reshape(B, R, 28)
        offset = end[:, -1]
        last = ((torch.arange(R, device=dev) == (offset - 1).clamp(min=0)
                 [:, None]) & (offset > 0)[:, None])
        out[..., 26] = torch.where(last, 0, out[..., 26])
        out = out[:, :self.max_str_len].to(torch.uint8)
        return torch.cat([obs["image"].reshape(B, -1), out.reshape(B, -1)],
                         1)


class ViewSizeWrapper(ObservationWrapper):
    """The egocentric image observed again at another view size
    (wrappers.py:629-673): the kernel's observe entry at that size on the
    card, plain ``gen_obs`` on the CPU. The kernel takes odd sizes 3-31
    (``ops.fused_step.check_view_size``), and a larger size raises
    ``ValueError`` on both devices."""

    def __init__(self, env, agent_view_size=7):
        super().__init__(env)
        check_view_size(agent_view_size)
        self.agent_view_size = agent_view_size

    @property
    def view_params(self):
        return dataclasses.replace(self.env.params,
                                   view_size=self.agent_view_size)

    def observation(self, obs, state):
        packed = fused_observe(self.view_params, state)
        return {**obs, "image": packed_to_image(packed)}


class DirectionObsWrapper(_StatefulFastPath):
    """Slope (or angle) towards the goal (wrappers.py:676-726). The goal
    coordinate is cached at reset; the reference's (row, col) arithmetic,
    which swaps x and y (wrappers.py:703-709), is kept, and so are its
    divisions by zero (+-inf, NaN). On the fast paths the cache is taken
    again from the post-select states (a goal never moves within an
    episode)."""

    def __init__(self, env, type="slope"):
        super().__init__(env)
        self.type = type

    def _post_select(self, w, st):
        return self._goal_position(st)

    def _augment_obs(self, obs, st, w):
        return self._augment(obs, st, w)

    def _goal_position(self, state):
        """The first goal in the reference's row-major list order (index
        ``j * W + i``), as ``(idx // H, idx % W)``; (0, 0) without one."""
        is_goal = (state.grid[..., 0] == C.GOAL).transpose(1, 2)  # [b, j, i]
        B, H, W = is_goal.shape
        idx = is_goal.reshape(B, -1).to(torch.uint8).argmax(1)
        return torch.stack([idx // H, idx % W], -1).to(torch.int32)

    def _augment(self, obs, state, goal):
        dy = (goal[:, 1] - state.agent_pos[:, 1]).to(torch.float32)
        dx = (goal[:, 0] - state.agent_pos[:, 0]).to(torch.float32)
        slope = dy / dx
        value = torch.atan(slope) if self.type == "angle" else slope
        return {**obs, "goal_direction": value}

    def _on_reset(self, obs, state):
        e = _inner_env_state(state)
        goal = self._goal_position(e)
        return self._augment(obs, e, goal), WrappedState(inner=state,
                                                         wrapper=goal)

    def step(self, keys, state, action):
        obs, inner, r, te, tr, i = self.env.step(keys, state.inner, action)
        obs = self._augment(obs, _inner_env_state(inner), state.wrapper)
        return obs, state.replace(inner=inner), r, te, tr, i


class SymbolicObsWrapper(ObservationWrapper):
    """(x, y, object type) planes over the full grid (wrappers.py:729-782):
    int32, -1 at empty cells and AGENT (10) at the agent's cell."""

    def observation(self, obs, state):
        t = state.grid[..., 0].to(torch.int32)
        B, W, H = t.shape
        objects = torch.where(t == C.EMPTY, -1, t)
        xs = torch.arange(W, dtype=torch.int32, device=t.device)
        ys = torch.arange(H, dtype=torch.int32, device=t.device)
        img = torch.stack([xs[:, None].expand(B, W, H),
                           ys[None, :].expand(B, W, H), objects], -1)
        pos = state.agent_pos.to(torch.int64)
        img[torch.arange(B, device=t.device), pos[:, 0], pos[:, 1], 2] = \
            C.AGENT
        return {**obs, "image": img}


class StochasticActionWrapper(TransitionWrapper):
    """Keep the intended action with probability ``prob``, else take a
    random one (wrappers.py:785-806; replacements uniform over 0-5, i.e.
    never ``done``, or ``random_action``). Its draws hash the step keys
    with this layer's salt (``envs/common.py::hash_scores``):
    the same keys give the same actions on the CPU and on the card. The
    JAX package draws from threefry, which the port cannot replay; the two
    agree in distribution."""

    def __init__(self, env, prob=0.9, random_action=None):
        super().__init__(env)
        self.prob = prob
        self.random_action = random_action

    def transform_action(self, keys, env_state, action):
        s = hash_scores(keys, _TA_SALT + self._t_depth, 2)
        keep = s[:, 0] < int(self.prob * 2 ** 32)
        if self.random_action is None:
            replacement = (s[:, 1] % 6).to(torch.int32)
        else:
            replacement = torch.full_like(action, self.random_action)
        return torch.where(keep, action, replacement)


class NoDeath(TransitionWrapper):
    """Replace a deadly termination with a penalty (wrappers.py:809-882):
    walking into, or standing on, a cell of ``no_death_types`` ends no
    episode and adds ``death_cost`` to the reward."""

    def __init__(self, env, no_death_types: tuple[str, ...],
                 death_cost: float = -1.0):
        if "goal" in no_death_types:
            raise ValueError("the goal cannot be a death type")
        super().__init__(env)
        self.death_types = tuple(C.OBJECT_TO_IDX[t] for t in no_death_types)
        self.death_cost = death_cost

    def _deadly(self, types):
        out = torch.zeros_like(types, dtype=torch.bool)
        for t in self.death_types:
            out = out | (types == t)
        return out & (types != C.EMPTY)

    def transform_outcome(self, keys, prev, st, action, r, te, tr):
        ftype = front_cell(self.params, prev)[2][:, 0].to(torch.int32)
        going_to_death = (action == Actions.forward) & self._deadly(ftype)
        b = torch.arange(st.batch_size, device=st.device)
        pos = st.agent_pos.to(torch.int64)
        cur = st.grid[b, pos[:, 0], pos[:, 1], 0].to(torch.int32)
        cancel = te & (going_to_death | self._deadly(cur))
        r = torch.where(cancel, r + self.death_cost, r)
        st = st.replace(terminated=st.terminated & ~cancel)
        return st, r, te & ~cancel, tr


__all__ = [
    "Wrapper", "ObservationWrapper", "TransitionWrapper", "WrappedState",
    "ReseedWrapper",
    "ActionBonus", "PositionBonus", "ImgObsWrapper",
    "OneHotPartialObsWrapper", "RGBImgObsWrapper", "RGBImgPartialObsWrapper",
    "FullyObsWrapper", "DictObservationSpaceWrapper", "FlatObsWrapper",
    "ViewSizeWrapper", "DirectionObsWrapper", "SymbolicObsWrapper",
    "StochasticActionWrapper", "NoDeath",
]
