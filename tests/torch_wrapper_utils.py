"""Shared helpers of the wrapper tests (tests/test_torch_wrappers.py,
tests/test_torch_wrapper_paths.py): the stacks compared, the JAX layouts,
base trajectories and jitted JAX functions they share (module caches, so
that each is built and compiled once per process), and the comparisons."""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
import torch

import minigrid_tpu
from minigrid_tpu import wrappers as JW

import minigrid_tpu_torch
from minigrid_tpu_torch import wrappers as PW

from tests.torch_port_utils import (ALL_FIELDS, CPU, action_stream,
                                    assert_state_equal, export_state)

DOORKEY = "MiniGrid-DoorKey-8x8-v0"
LAVA = "MiniGrid-LavaGapS5-v0"
NB = 32  # envs per comparison
T_STEPS = 6
_CACHE: dict = {}


class JMirror(JW.TransitionWrapper):
    """A deterministic transition wrapper (left and right swapped), to
    stack with NoDeath."""

    uses_rng = False

    def transform_action(self, key, env_state, action):
        return jnp.where(action == 0, 1, jnp.where(action == 1, 0, action))


class PMirror(PW.TransitionWrapper):
    def transform_action(self, keys, env_state, action):
        return torch.where(action == 0, 1, torch.where(action == 1, 0,
                                                       action))


def mirror(W, e):
    return (JMirror if W is JW else PMirror)(e)


def nodeath(W, e):
    return W.NoDeath(e, no_death_types=("lava",), death_cost=-0.2)


# the stateless observation wrappers: name -> (env id, packed, stack)
OBSERVATION = {
    "ImgObs": (DOORKEY, True, lambda W, e: W.ImgObsWrapper(e)),
    "OneHotPartialObs": (DOORKEY, False,
                         lambda W, e: W.OneHotPartialObsWrapper(e)),
    "RGBImgObs": (DOORKEY, True, lambda W, e: W.RGBImgObsWrapper(e)),
    "RGBImgObs no highlight": (DOORKEY, False, lambda W, e:
                               W.RGBImgObsWrapper(e, 8, highlight=False)),
    "RGBImgPartialObs": (DOORKEY, False,
                         lambda W, e: W.RGBImgPartialObsWrapper(e)),
    "FullyObs": (DOORKEY, False, lambda W, e: W.FullyObsWrapper(e)),
    "DictObservationSpace": (DOORKEY, True, lambda W, e:
                             W.DictObservationSpaceWrapper(e, 50)),
    "DictObservationSpace padded": (DOORKEY, True, lambda W, e:
                                    W.DictObservationSpaceWrapper(e, 100)),
    "FlatObs": (DOORKEY, False, lambda W, e: W.FlatObsWrapper(e)),
    "ViewSize": (DOORKEY, False, lambda W, e: W.ViewSizeWrapper(e, 9)),
    "SymbolicObs": (DOORKEY, True, lambda W, e: W.SymbolicObsWrapper(e)),
}
# the others and stacks, stepped through their own JAX step
STEPPED = {
    "DirectionObs": (DOORKEY, True, lambda W, e: W.DirectionObsWrapper(e)),
    "ActionBonus": (DOORKEY, True, lambda W, e: W.ActionBonus(e)),
    "PositionBonus": (DOORKEY, True, lambda W, e: W.PositionBonus(e)),
    "NoDeath": (LAVA, True, nodeath),
    "NoDeath(Mirror)": (LAVA, True, lambda W, e: nodeath(W, mirror(W, e))),
    "ImgObs(NoDeath)": (LAVA, True,
                        lambda W, e: W.ImgObsWrapper(nodeath(W, e))),
    "ActionBonus(PositionBonus)": (
        DOORKEY, True, lambda W, e: W.ActionBonus(W.PositionBonus(e))),
}
CASES = OBSERVATION | STEPPED


def envs(env_id, packed):
    """(JAX env, port env on the CPU), shared."""
    key = ("env", env_id, packed)
    if key not in _CACHE:
        jenv = minigrid_tpu.make(env_id)
        penv = minigrid_tpu_torch.make(env_id, device=CPU)
        if packed:
            jenv, penv = jenv.packed(), penv.packed()
        _CACHE[key] = jenv, penv
    return _CACHE[key]


def stacks(name, fresh_port_env=False):
    """(JAX stack, port stack) of CASES[name], shared; with
    ``fresh_port_env`` the port stack wraps a base env of its own."""
    env_id, packed, wrap = CASES[name]
    jenv, penv = envs(env_id, packed)
    if fresh_port_env:
        penv = minigrid_tpu_torch.make(env_id, device=CPU)
        return wrap(JW, jenv), wrap(PW, penv.packed() if packed else penv)
    key = ("stack", name)
    if key not in _CACHE:
        _CACHE[key] = wrap(JW, jenv), wrap(PW, penv)
    return _CACHE[key]


def jitted(name, kind, fn):
    """``jax.jit(fn(JAX stack))``, compiled once per (stack, kind)."""
    key = ("jit", name, kind)
    if key not in _CACHE:
        _CACHE[key] = jax.jit(fn(stacks(name)[0]))
    return _CACHE[key]


def base_layouts(env_id, packed, n=NB, seed=0):
    """(keys, obs, states) of ``jax.vmap(env.reset)`` on ``n`` keys of
    ``seed``, shared."""
    key = ("layouts", env_id, packed, n, seed)
    if key not in _CACHE:
        jenv, _ = envs(env_id, packed)
        keys = jax.random.split(jax.random.PRNGKey(seed), n)
        _CACHE[key] = (keys, *jax.jit(jax.vmap(jenv.reset))(keys))
    return _CACHE[key]


def keys_of(seed, n=NB):
    """(JAX uint32 keys, the port's int32 view of the same bits)."""
    k = np.array(jax.random.split(jax.random.PRNGKey(seed), n))
    return jnp.asarray(k), torch.from_numpy(k.view(np.int32))


def actions_for(name, T, seed=1):
    """(T, NB) actions: the interaction stream, mostly forward on lava."""
    acts = action_stream("interact", T, NB, seed=seed)
    if CASES[name][0] == LAVA:
        fwd = np.random.default_rng(seed).random((T, NB)) < 0.6
        acts = np.where(fwd, 2, acts).astype(np.int32)
    return acts


def reset_both(name, seed=0):
    """The stack's JAX reset on the keys of ``seed``, and the port's reset
    from the same layouts: ((JAX obs, state), (port obs, state))."""
    jw, pw = stacks(name)
    env_id, packed, _ = CASES[name]
    keys, _, layouts = base_layouts(env_id, packed, seed=seed)
    j = jitted(name, "reset", lambda w: jax.vmap(w.reset))(keys)
    return j, pw.reset_from(export_state(layouts))


def staggered(name):
    """Both resets with each env's innermost step_count a few steps below
    max_steps, so that episodes end (and reset) within six steps:
    (JAX state, port state)."""
    (_, jst), _ = reset_both(name)
    jw, _ = stacks(name)
    ms = jw.params.max_steps
    sc = jnp.asarray(ms - 1 - (np.arange(NB) % 6), jnp.int32)
    jst = JW._replace_inner(jst, JW._inner_env_state(jst).replace(
        step_count=sc))
    return jst, export_state(jst)


def assert_obs_equal(port, ref, msg=""):
    """Observations (a dict of arrays, or one array) equal, dtypes
    included; NaNs compare equal."""
    if isinstance(ref, dict):
        assert set(port) == set(ref), msg
        for k in ref:
            assert_obs_equal(port[k], ref[k], f"{msg} {k}")
        return
    want, got = np.asarray(ref), port.numpy()
    assert got.dtype == want.dtype, f"{msg}: {got.dtype} vs {want.dtype}"
    np.testing.assert_array_equal(got, want, err_msg=msg)


def assert_wrapped_equal(port, ref, msg=""):
    """Port state == JAX state, WrappedState layers and all fields."""
    if isinstance(ref, JW.WrappedState):
        assert isinstance(port, PW.WrappedState), msg
        want = np.asarray(ref.wrapper)
        assert port.wrapper.numpy().dtype == want.dtype, msg
        np.testing.assert_array_equal(port.wrapper.numpy(), want,
                                      err_msg=f"{msg} wrapper")
        assert_wrapped_equal(port.inner, ref.inner, msg)
    else:
        assert_state_equal(port, ref, ALL_FIELDS, msg=msg)


def assert_outputs(p, j, msg):
    """(obs, state, reward, terminated, truncated) of a step equal; the
    reward within rtol 1e-6 (XLA:CPU contracts the goal reward ``1 - 0.9 *
    t / max_steps`` into a fused multiply-add in some JAX programs)."""
    assert_obs_equal(p[0], j[0], f"{msg} obs")
    assert_wrapped_equal(p[1], j[1], f"{msg} state")
    np.testing.assert_allclose(p[2].numpy(), np.asarray(j[2]), rtol=1e-6,
                               err_msg=f"{msg} reward")
    for i, name in ((3, "terminated"), (4, "truncated")):
        np.testing.assert_array_equal(p[i].numpy(), np.asarray(j[i]),
                                      err_msg=f"{msg} {name}")
