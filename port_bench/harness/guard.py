"""The benchmark measures the PyTorch port alone: no JAX in the process.

The port's package name, ``minigrid_tpu_torch``, begins with the JAX
package's, ``minigrid_tpu``; so a module is judged by the whole of its
top-level name, the part before the first dot, never by a prefix.
"""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "minigrid_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """The loaded modules (``sys.modules`` by default) whose top-level name
    is one of :data:`FORBIDDEN`, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)
