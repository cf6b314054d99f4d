"""The program's spans and counters: where the host's time goes, by layer.

A span is a named interval of the host's clock (``time.perf_counter_ns``)
at a layer boundary, kept in memory with the span it opened under. Spans
are on

- while a ``torch.profiler`` session is active: each span then also
  enters ``record_function("mg.<name>")``, so the program's names sit on
  the profiler's timeline beside the device's kernels;
- after :func:`enable`, the light mode: the records alone, no profiler
  ranges.

Off, a span site costs a test of two flags and stores nothing. Spans never
synchronise the device: they time the host, which on the host-bound paths
(a launch at a time) is what keeps the device idle. The recorder is one per
process and follows one thread, the one that steps the envs.

The spans, by name (``mg.`` prefixed in the profiler):

- ``train_step``: one train step (``models/ppo.py::make_train_step``);
- ``rollout``: the rollout (``models/ppo.py::rollout``);
- ``policy``: a rollout step's observation encoding, forward, Gumbel argmax
  and log-probability (on the card, mostly one CUDA graph replay:
  ``models/policy_step.py``);
- ``env.step``: one auto-resetting step at an env's or a wrapper stack's
  ``step_autoreset``, ``step_autoreset_presampled`` or
  ``step_autoreset_fresh``;
- ``env.kernel``: a call of ``ops/fused_step.py::fused_rollout`` or
  ``fused_observe``: the launch's argument marshalling and its ``ctypes``
  call on the card, the plain version on the CPU;
- ``env.hooks``: the step hooks before and after the kernel
  (``envs/base.py::hooked_step``): the action transforms, ``_pre_step``,
  ``_post_step`` (BabyAI's verifier) and the transition wrappers' outcome
  maps;
- ``env.select``: the reset select: the broadcast row's episode fields,
  the fresh routing and select (on the card one kernel launch,
  ``ops/fresh_select.py``), ``select_reset_states``, ``select_obs``;
- ``gen``: a ``_gen_grid`` batch: a reset, a pool, a fresh buffer, a regen
  draw;
- ``update``: the PPO update (``models/ppo.py::ppo_update``);
- ``pool_refresh``: ``envs/base.py::refresh_layout_pool``.

A span opened inside an open span of the same name is not recorded: a
wrapper's entry that delegates to the env's counts once.

Operator use::

    from minigrid_tpu_torch.utils import trace
    trace.enable()
    model, history = train("MiniGrid-DoorKey-8x8-v0", cfg)
    trace.disable()
    for name, row in trace.summary().items():
        print(name, row)   # calls, inclusive ms, self ms

or run under ``torch.profiler`` and export the chrome trace
(``prof.export_chrome_trace``), where the ``mg.*`` ranges sit beside the
kernels. :func:`counters` is one flat snapshot of the program's counters.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import itertools
import time
from typing import NamedTuple

import torch.autograd.profiler as _profiler

PREFIX = "mg."
MAX_RECORDS = 1 << 20  # the store keeps the newest this many spans


class Record(NamedTuple):
    name: str
    id: int
    parent: int | None  # the id of the span it opened under; None: a root
    start_ns: int
    end_ns: int


_records: collections.deque = collections.deque(maxlen=MAX_RECORDS)
_open: list = []  # the open spans, innermost last
_ids = itertools.count()
_enabled = False


def enable() -> None:
    """Record spans from now on, with no profiler running."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Stop :func:`enable`'s recording (a profiler session still turns
    spans on)."""
    global _enabled
    _enabled = False


class _Span:
    __slots__ = ("name", "id", "parent", "start", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.parent = _open[-1].id if _open else None
        self.id = next(_ids)
        _open.append(self)
        self.range = None
        if _profiler._is_profiler_enabled:
            self.range = _profiler.record_function(PREFIX + self.name)
            self.range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        _open.pop()
        _records.append(Record(self.name, self.id, self.parent, self.start,
                               end))
        return False


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str):
    """A context manager that records the span ``name`` while spans are
    on (see the module docstring), and does nothing while they are off."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return _OFF
    if any(s.name == name for s in _open):
        return _OFF
    return _Span(name)


def spanned(name: str):
    """Decorator: the span ``name`` around each call of the function."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not (_enabled or _profiler._is_profiler_enabled):
                return fn(*args, **kwargs)
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def records() -> list[Record]:
    """The stored spans, in the order they closed (a child before the span
    it opened under)."""
    return list(_records)


def clear() -> None:
    """Forget the stored spans."""
    _records.clear()


def summary(of=None) -> dict:
    """``{name: {"calls", "ms", "self_ms"}}`` over the records ``of`` (all
    stored ones by default): calls, inclusive milliseconds summed over
    them, and self milliseconds, each span's time less its child spans'."""
    recs = records() if of is None else of
    child_ns = collections.Counter()
    for r in recs:
        if r.parent is not None:
            child_ns[r.parent] += r.end_ns - r.start_ns
    out = {}
    for r in recs:
        row = out.setdefault(r.name, {"calls": 0, "ms": 0.0, "self_ms": 0.0})
        ns = r.end_ns - r.start_ns
        row["calls"] += 1
        row["ms"] += ns / 1e6
        row["self_ms"] += (ns - child_ns[r.id]) / 1e6
    return out


def counters() -> dict:
    """One flat snapshot of the program's counters: ``gen.*`` the RoomGrid
    and BabyAI generators' (``core/roomgrid.py::COUNTERS``), ``wfc.*`` the
    WFC solver's (``envs/wfc/solver.py::COUNTERS``), ``policy.*`` how the
    rollout's policy steps ran (``models/policy_step.py::POLICY``: graph
    captures, graph replays, eager steps) and ``kernel.*`` the launch
    counts of the hand-written kernels (``ops/native.py::COUNTERS``)."""
    # imported here: the env and kernel modules import this one
    from minigrid_tpu_torch.core import roomgrid
    from minigrid_tpu_torch.envs.wfc import solver
    from minigrid_tpu_torch.models.policy_step import POLICY
    from minigrid_tpu_torch.ops import native

    return {f"{prefix}.{f.name}": getattr(obj, f.name)
            for prefix, obj in (("gen", roomgrid.COUNTERS),
                                ("wfc", solver.COUNTERS), ("policy", POLICY),
                                ("kernel", native.COUNTERS))
            for f in dataclasses.fields(obj)}
