"""Carrying parameters and state across from the JAX package, as numpy.

Imports no JAX: callers hand over numpy arrays (e.g.
``jax.tree.map(np.asarray, params)``).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from minigrid_tpu_torch.core.types import (STATE_FIELDS, EnvState,
                                           resolve_device)
from minigrid_tpu_torch.envs.base import LayoutPool, pool_from_states
from minigrid_tpu_torch.wrappers import WrappedState

# Flax Dense layers (kernel, bias) and bias-free ones, and plain arrays, of
# each policy
DENSE_LAYERS = ("img_in", "trunk1", "trunk2", "policy", "value")
RNN_DENSE_LAYERS = ("img_in", "trunk1", "gru_x", "policy", "value")
RNN_KERNELS = ("gru_h",)
RNN_ARRAYS = ("mission_table", "bhn")


def _from_flax(params_np, dense, kernels, arrays) -> dict:
    p = params_np.get("params", params_np)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32))

    sd = {}
    for name in dense + kernels:
        sd[f"{name}.weight"] = t(np.asarray(p[name]["kernel"]).T)
        if name in dense:
            sd[f"{name}.bias"] = t(p[name]["bias"])
    for name in arrays:
        sd[name] = t(p[name])
    return sd


def _to_flax(state_dict, dense, kernels, arrays) -> dict:
    def arr(name):
        return state_dict[name].detach().cpu().numpy()

    p = {name: {"kernel": arr(f"{name}.weight").T.copy()}
         for name in dense + kernels}
    for name in dense:
        p[name]["bias"] = arr(f"{name}.bias")
    p.update({name: arr(name) for name in arrays})
    return {"params": p}


def actor_critic_from_flax(params_np) -> dict:
    """Flax ``ActorCritic`` params (the ``model.init`` tree, numpy leaves)
    -> a ``state_dict`` for ``models.actor_critic.ActorCritic``. Dense
    kernels are (in, out) in Flax and (out, in) in ``nn.Linear``."""
    return _from_flax(params_np, DENSE_LAYERS, (), ("mission_embed",))


def actor_critic_to_flax(state_dict) -> dict:
    """The inverse of :func:`actor_critic_from_flax`: an ``ActorCritic``
    ``state_dict`` (or any mapping of the same names, e.g. Adam moments)
    -> the Flax ``{"params": ...}`` tree with numpy leaves."""
    return _to_flax(state_dict, DENSE_LAYERS, (), ("mission_embed",))


def actor_critic_rnn_from_flax(params_np) -> dict:
    """Flax ``ActorCriticRNN`` params (numpy leaves) -> a ``state_dict``
    for ``models.actor_critic.ActorCriticRNN``: the dense layers, the
    bias-free ``gru_h``, ``mission_table`` and ``bhn``."""
    return _from_flax(params_np, RNN_DENSE_LAYERS, RNN_KERNELS, RNN_ARRAYS)


def actor_critic_rnn_to_flax(state_dict) -> dict:
    """The inverse of :func:`actor_critic_rnn_from_flax`."""
    return _to_flax(state_dict, RNN_DENSE_LAYERS, RNN_KERNELS, RNN_ARRAYS)


def adam_state_from_optax(optimizer: torch.optim.Adam, model, mu, nu,
                          count) -> torch.optim.Adam:
    """Load optax Adam moments (``mu``, ``nu``: Flax trees of ``model``'s
    kind, ``ActorCritic`` or ``ActorCriticRNN``, with numpy leaves;
    ``count``: the step count) into ``optimizer``, a ``torch.optim.Adam``
    over ``model.parameters()``, in place. Returns the optimizer."""
    from_flax = (actor_critic_rnn_from_flax
                 if getattr(model, "is_recurrent", False)
                 else actor_critic_from_flax)
    mu_sd, nu_sd = from_flax(mu), from_flax(nu)
    sd = optimizer.state_dict()
    for i, (name, p) in enumerate(model.named_parameters()):
        sd["state"][i] = {
            "step": torch.tensor(float(np.asarray(count))),
            "exp_avg": mu_sd[name].to(p.device),
            "exp_avg_sq": nu_sd[name].to(p.device)}
    optimizer.load_state_dict(sd)
    return optimizer


def _field(src, name):
    return src[name] if isinstance(src, Mapping) else getattr(src, name)


def _extra(src):
    """The ``extra`` of an exported state: None, or a (nested) mapping of
    arrays."""
    if isinstance(src, Mapping):
        return src.get("extra")
    return getattr(src, "extra", None)


def flatten_extra(extra, prefix: str = "") -> dict:
    """A nested JAX ``extra`` (mappings and dataclasses, e.g. Flax struct
    dataclasses, of numpy-convertible arrays) as one flat dict under dotted
    keys, the port's layout: ``{"instr": InstrState(descs=Descs(...)),
    "max_steps": m}`` -> ``{"instr.descs.mask_objs": ..., ...,
    "max_steps": m}``. uint32 arrays (the packed masks) keep their bits as
    int32."""
    if isinstance(extra, Mapping):
        items = extra.items()
    elif dataclasses.is_dataclass(extra):
        items = ((f.name, getattr(extra, f.name))
                 for f in dataclasses.fields(extra))
    else:
        a = np.array(extra)  # a writable copy
        return {prefix[:-1]: a.view(np.int32) if a.dtype == np.uint32 else a}
    out = {}
    for k, v in items:
        out.update(flatten_extra(v, f"{prefix}{k}."))
    return out


def env_state_from_numpy(src, device=None) -> EnvState:
    """A batched EnvState exported from JAX (an object or mapping with the
    EnvState fields as numpy-convertible arrays, batch-leading, and
    ``extra`` None or a mapping of such arrays, nested mappings and
    dataclasses flattened by :func:`flatten_extra`). JAX keys (uint32) keep
    their bit pattern as int32, as do uint32 arrays of ``extra``; its other
    arrays keep their dtypes."""
    dev = resolve_device(device)

    def t(name, dtype):
        return torch.as_tensor(np.asarray(_field(src, name)).astype(dtype),
                               device=dev)

    rng = np.array(_field(src, "rng"))  # a writable copy
    extra = _extra(src)
    if extra is not None:
        extra = {k: torch.as_tensor(v, device=dev)
                 for k, v in flatten_extra(extra).items()}
    return EnvState(
        grid=t("grid", np.uint8),
        agent_pos=t("agent_pos", np.int32),
        agent_dir=t("agent_dir", np.int32),
        carrying=t("carrying", np.uint8),
        step_count=t("step_count", np.int32),
        terminated=t("terminated", np.bool_),
        truncated=t("truncated", np.bool_),
        mission=t("mission", np.int32),
        rng=torch.as_tensor(rng.view(np.int32), device=dev),
        extra=extra,
    )


def state_from_numpy(src, device=None):
    """A batched state exported from JAX, wrapped or not: a JAX
    ``WrappedState`` (an object or mapping with ``inner`` and ``wrapper``;
    ``inner`` nested to any depth) becomes the port's
    ``wrappers.WrappedState``, its ``wrapper`` array (visit counts, a goal
    cache, seed indices) a tensor of the same dtype; an EnvState goes
    through :func:`env_state_from_numpy`."""
    try:
        inner, wrapper = _field(src, "inner"), _field(src, "wrapper")
    except (KeyError, AttributeError):
        return env_state_from_numpy(src, device)
    return WrappedState(
        inner=state_from_numpy(inner, device),
        wrapper=torch.as_tensor(np.array(wrapper),
                                device=resolve_device(device)))


def layout_pool_from_entries(entries, device=None) -> LayoutPool:
    """JAX pool entries (``LayoutPool.entry(i)``, one unbatched EnvState
    each) -> the port's pool with the same rows in the same order."""
    stacked = {n: np.stack([np.asarray(_field(e, n)) for e in entries])
               for n in STATE_FIELDS}
    extras = [_extra(e) for e in entries]
    if extras[0] is not None:
        flat = [flatten_extra(x) for x in extras]
        stacked["extra"] = {k: np.stack([x[k] for x in flat])
                            for k in flat[0]}
    return pool_from_states(env_state_from_numpy(stacked, device))
