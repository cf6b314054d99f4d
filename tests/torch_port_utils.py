"""Shared helpers for the tests of the PyTorch port (tests/test_torch_*.py).

Data crosses between the two packages as numpy arrays: JAX states are
exported with ``jax.tree.map(np.asarray, ...)`` and rebuilt on the CPU by
``minigrid_tpu_torch.convert``."""

from __future__ import annotations

import numpy as np

import jax

import minigrid_tpu
from minigrid_tpu_torch.convert import env_state_from_numpy

CPU = "cpu"

# interaction-biased action stream of tests/test_fused_step.py
INTERACT = np.array([0, 1, 2, 2, 3, 4, 5, 5], np.int32)


def jax_states(env_id: str, batch: int, seed: int = 0, packed: bool = True):
    """(JAX env, batched JAX states) from ``jax.vmap(env.reset)``."""
    env = minigrid_tpu.make(env_id)
    if packed:
        env = env.packed()
    _, states = jax.jit(jax.vmap(env.reset))(
        jax.random.split(jax.random.PRNGKey(seed), batch))
    return env, states


def export(states):
    """Batched JAX EnvState -> the port's EnvState on the CPU."""
    return env_state_from_numpy(jax.tree.map(np.asarray, states), CPU)


def action_stream(kind: str, T: int, B: int, seed: int = 1) -> np.ndarray:
    """(T, B) int32 actions: uniform over the 7 actions, or the
    interaction-biased stream."""
    rng = np.random.default_rng(seed)
    if kind == "interact":
        return INTERACT[rng.integers(0, len(INTERACT), (T, B))]
    return rng.integers(0, 7, (T, B)).astype(np.int32)


def assert_state_equal(port, ref, fields=("grid", "agent_pos", "agent_dir",
                                          "carrying", "step_count",
                                          "terminated", "truncated"),
                       msg=""):
    """Port EnvState == JAX EnvState on ``fields``, bit for bit."""
    for k in fields:
        want = np.asarray(getattr(ref, k))
        got = getattr(port, k).numpy()
        if k == "rng":
            want = want.view(np.int32)
        np.testing.assert_array_equal(got, want, err_msg=f"{msg} {k}")
