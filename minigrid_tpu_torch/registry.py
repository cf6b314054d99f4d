"""Environment registry (counterpart of ``minigrid_tpu/registry.py``).

Every ID maps to a factory; ``make(env_id, device=...)`` builds the env on
``device``, the card when none is given (and raises when there is none)."""

from __future__ import annotations

from typing import Callable

_REGISTRY: dict[str, Callable] = {}


def register(env_id: str, factory: Callable, **default_kwargs) -> None:
    if default_kwargs:
        base = factory

        def factory(_base=base, _kw=default_kwargs, **overrides):
            return _base(**(_kw | overrides))

    _REGISTRY[env_id] = factory


def make(env_id: str, device=None, **kwargs):
    if env_id not in _REGISTRY:
        raise KeyError(
            f"Unknown environment id {env_id!r}; {len(_REGISTRY)} registered.")
    return _REGISTRY[env_id](device=device, **kwargs)


def registered_ids() -> list[str]:
    return sorted(_REGISTRY)
