"""Checkpoint / resume of nested trees of tensors.

Counterpart of the ``.npz`` path of ``minigrid_tpu/utils/checkpoint.py``. A
tree is any nesting of mappings (a model's or an optimizer's
``state_dict``), lists, tuples and dataclasses (:class:`EnvState`) whose
leaves are tensors, numpy arrays or Python scalars; ``None`` holds no leaf.
The file stores each leaf beside its key path (``['model']['img_in.weight']``,
``.grid``, ``[0]``), and a restore checks the key paths and shapes against
the tree it restores into, so leaves can never land in the wrong place.

    save_pytree("ckpt/step_100", {"model": model.state_dict(),
                                  "optimizer": optimizer.state_dict()})
    like = {"model": model.state_dict(), "optimizer": optimizer.state_dict()}
    tree = restore_pytree("ckpt/step_100", like)
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections.abc import Mapping
from typing import Any

import numpy as np
import torch


def _is_dataclass(tree) -> bool:
    return dataclasses.is_dataclass(tree) and not isinstance(tree, type)


def _children(tree):
    """(key path suffix, child) pairs of an inner node, in flattening
    order (sorted mapping keys, as JAX flattens dicts), or None for a
    leaf."""
    if isinstance(tree, Mapping):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    if _is_dataclass(tree):
        return [(f".{f.name}", getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    return None


def flatten_with_paths(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """The (key path, leaf) pairs of ``tree``, in flattening order."""
    if tree is None:
        return []
    children = _children(tree)
    if children is None:
        return [(prefix, tree)]
    return [pair for suffix, child in children
            for pair in flatten_with_paths(child, prefix + suffix)]


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_pytree(path: str, tree) -> None:
    """Save ``tree`` to ``path`` (``.npz`` appended when missing)."""
    pairs = flatten_with_paths(tree)
    np.savez(_npz(path),
             keypaths=np.array([p for p, _ in pairs], dtype=str),
             **{f"leaf_{i}": _to_numpy(x) for i, (_, x) in enumerate(pairs)})


def _rebuild(like, leaves):
    """``like`` with its leaves replaced, in order, from ``leaves``."""
    if like is None:
        return None
    if isinstance(like, Mapping):
        new = {k: _rebuild(like[k], leaves) for k in sorted(like)}
        return type(like)((k, new[k]) for k in like)
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, leaves) for v in like)
    if _is_dataclass(like):
        new = {f.name: _rebuild(getattr(like, f.name), leaves)
               for f in dataclasses.fields(like)}
        return dataclasses.replace(like, **new)
    arr = next(leaves)
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(arr).to(device=like.device, dtype=like.dtype)
    if isinstance(like, np.ndarray):
        return arr.astype(like.dtype)
    return type(like)(arr.item())


def restore_pytree(path: str, like):
    """Restore a tree saved by :func:`save_pytree` into the structure of
    ``like`` (tensors take ``like``'s device and dtype). Raises
    ``ValueError`` when the key paths or a leaf's shape differ."""
    with np.load(_npz(path)) as npz:
        saved_paths = [str(s) for s in npz["keypaths"]]
        pairs = flatten_with_paths(like)
        like_paths = [p for p, _ in pairs]
        if saved_paths != like_paths:
            diff = [f"  {a!r} -> {b!r}" for a, b in
                    zip(saved_paths, like_paths) if a != b][:8]
            raise ValueError(
                "checkpoint key paths do not match the restore target "
                "(leaves would be mis-assigned):\n" + "\n".join(
                    diff or [f"  (leaf count differs: {len(saved_paths)} "
                             f"saved, {len(like_paths)} expected)"]))
        leaves = []
        for i, (p, ref) in enumerate(pairs):
            leaf = npz[f"leaf_{i}"]
            want = tuple(np.shape(ref) if not isinstance(ref, torch.Tensor)
                         else ref.shape)
            if tuple(leaf.shape) != want:
                raise ValueError(f"checkpoint leaf {p} has shape "
                                 f"{leaf.shape}, expected {want}")
            leaves.append(leaf)
    return _rebuild(like, iter(leaves))


def state_fingerprint(state) -> str:
    """sha256 fingerprint (16 hex digits) of a state's leaves, in
    flattening order; the same bytes as the JAX package's fingerprint of
    the same batch."""
    h = hashlib.sha256()
    for _, leaf in flatten_with_paths(state):
        h.update(_to_numpy(leaf).tobytes())
    return h.hexdigest()[:16]
