"""The fresh reset's routing and select on the card: the CUDA kernel.

The fresh reset (``envs/base.py::autoreset_step_fresh``) ranks a step's
finishers, gives the env of rank r buffer row ``min(cursor, n_buf - window)
+ min(r, window - 1)``, selects those rows into the finished envs with the
fresh rng ``keys ^ RESET_RNG_SALT``, counts the overflow and advances the
cursor. Its plain version, ``envs/base.py::fresh_candidates`` then
``select_reset_states``, is ~36 launches a DoorKey step and ~75 a BabyAI
level's on the card; ``csrc/fresh_select.cu`` does all of it in one. The
JAX package has no kernel here: its ``_fresh_select`` is ``jnp`` under
``jit``, which XLA fuses.

The kernel copies byte rows, so one kernel serves every bare env's state:
the field table (:func:`field_table`: each field's name, dtype, row shape
and bytes a row, in ``EnvState.tensors()`` order, ``extra`` included) is
read from the state. The host time of a call is what the kernel saves, so

- the buffer is packed once, at its first select, into one device slab
  (:class:`PackedBuffer`; a buffer is written once a rollout and only read
  after that);
- the stepped state's fields are checked every call, against specs built
  once a field table and batch size;
- the outputs are views of chunks shared by several calls, as the
  post-step's are (``envs/babyai/core/post_step.py::_Outputs``): a call
  never writes a tensor of the state it was given, and the next step's
  checks find contiguous fields.

Routing is by device, in ``envs/base.py::_fresh_select``: CUDA tensors take
:func:`fresh_select_cuda`, CPU tensors the plain version; nothing falls
back. The kernel is :data:`LIBRARY`, built, loaded, checked, called and
counted (``kernel.select_launches``) through ``ops/native.py``.
"""

from __future__ import annotations

import dataclasses
import math
import weakref

import torch

from minigrid_tpu_torch.core.types import EXTRA_PREFIX, STATE_FIELDS, EnvState
from minigrid_tpu_torch.ops import native

SOURCE = native.CSRC / "fresh_select.cu"
MAX_FIELDS = 48  # fields a state may have: csrc/fresh_select.cu kMaxFields
# the entry's (device pointers, ints): csrc/fresh_select.cu kPointers
LIBRARY = native.Library(SOURCE, {"fresh_select_launch":
                                  (8 + 2 * MAX_FIELDS, 7)})
RNG = STATE_FIELDS.index("rng")  # the field that takes keys ^ salt
ALIGN = 256  # bytes: where each part of a slab starts
# outputs are allocated for up to CHUNK_CALLS calls and CHUNK_BYTES at once
# (the post-step's chunking: an allocation costs 3-7 us of an H100's host,
# and a chunk four Python calls a field, so a BossLevel state, 18 MB at
# B=4096, takes 14 calls a chunk here and would take 3 at 64 MB)
CHUNK_CALLS, CHUNK_BYTES = 16, 256 << 20


@dataclasses.dataclass(frozen=True)
class Field:
    """One tensor of a state as the kernel copies it: its name in
    ``EnvState.tensors()``, dtype, one env's shape and bytes."""

    name: str
    dtype: torch.dtype
    shape: tuple
    row_bytes: int


def field_table(state: EnvState) -> tuple:
    """The :class:`Field` of each of ``state``'s tensors, in
    ``EnvState.tensors()`` order."""
    return tuple(Field(k, v.dtype, tuple(v.shape[1:]),
                       math.prod(v.shape[1:]) * v.element_size())
                 for k, v in state.tensors().items())


def _aligned(nbytes: int) -> int:
    return -(-nbytes // ALIGN) * ALIGN


class _Layout:
    """One field table's per-call parts: its names, the specs of a state of
    B envs, and the unused outputs of the last chunk. One object a table
    (:func:`_layout`), so that a call compares by identity."""

    def __init__(self, fields: tuple):
        if len(fields) > MAX_FIELDS:
            raise ValueError(f"the kernel takes states of up to {MAX_FIELDS} "
                             f"tensors, got {len(fields)}")
        if fields[RNG].dtype != torch.int32 or fields[RNG].shape != (2,):
            raise ValueError("rng must be int32 (B, 2)")
        self.fields = fields
        self.names = tuple(f.name for f in fields)
        self.extra_keys = tuple(n[len(EXTRA_PREFIX):]
                                for n in self.names[len(STATE_FIELDS):])
        self.pad = [0] * (MAX_FIELDS - len(fields))
        self._specs: dict = {}
        self._buffers: dict = {}
        self._key, self._left = None, []

    def buffer(self, n_buf: int, dev) -> tuple:
        """A packed buffer's layout for ``n_buf`` rows: (the byte offset of
        each field's rows, the slab's bytes, its header on ``dev``). The
        header is copied to the device once a shape, so that packing a
        buffer waits for nothing on the host."""
        key = (n_buf, dev)
        if key not in self._buffers:
            offsets, size = [], _aligned(16 * len(self.fields))
            for f in self.fields:
                offsets.append(size)
                size += _aligned(n_buf * f.row_bytes)
            header = torch.tensor([v for f, o in zip(self.fields, offsets)
                                   for v in (f.row_bytes, o)],
                                  dtype=torch.int64, device=dev)
            self._buffers[key] = tuple(offsets), size, header
        return self._buffers[key]

    def specs(self, B: int) -> list:
        """(name, dtype, shape) of each input tensor the kernel reads: the
        keys, done, cursor, offset and total, then the state's fields."""
        if B not in self._specs:
            i32 = torch.int32
            self._specs[B] = [
                ("keys", i32, (B, 2)), ("done", torch.bool, (B,)),
                ("cursor", i32, ()), ("offset", i32, ()), ("total", i32, ())
            ] + [(f.name, f.dtype, (B, *f.shape)) for f in self.fields]
        return self._specs[B]

    def take(self, B: int, dev, stream: int) -> tuple:
        """The next call's outputs: (the state's fields, their pointers,
        overflow, new cursor, the pointer of those two)."""
        key = (B, dev, stream)
        if key != self._key or not self._left:
            self._key, self._left = key, self._chunk(B, dev)
        return self._left.pop()

    def _chunk(self, B: int, dev) -> list:
        sizes = [B * f.row_bytes for f in self.fields]
        K = max(1, min(CHUNK_CALLS, CHUNK_BYTES // (sum(sizes) + 8)))
        offsets, total = [], 0
        for n in sizes + [8]:   # each field's K calls, then K (2,) int32
            offsets.append(total)
            total += _aligned(K * n)
        slab = torch.empty((total,), dtype=torch.uint8, device=dev)
        ptr = slab.data_ptr()
        fields = [slab[o:o + K * n].view(f.dtype).view(K, B, *f.shape)
                  .unbind(0)
                  for f, o, n in zip(self.fields, offsets, sizes)]
        scalars = slab[offsets[-1]:offsets[-1] + 8 * K].view(
            torch.int32).unbind(0)
        return [(tuple(f[k] for f in fields),
                 [ptr + o + k * n for o, n in zip(offsets, sizes)],
                 scalars[2 * k], scalars[2 * k + 1],
                 ptr + offsets[-1] + 8 * k)
                for k in reversed(range(K))]


_LAYOUTS: dict = {}


def _layout(fields: tuple) -> _Layout:
    if fields not in _LAYOUTS:
        _LAYOUTS[fields] = _Layout(fields)
    return _LAYOUTS[fields]


class PackedBuffer:
    """A fresh buffer packed into one slab on its device, field-major: a
    header of int64 pairs, each field's bytes a row and the byte offset of
    its rows, then each field's ``n_buf`` rows, every part starting at a
    multiple of :data:`ALIGN` bytes. The kernel reads the field table from
    the header."""

    def __init__(self, buffer: EnvState):
        self.layout = _layout(field_table(buffer))
        self.n_buf = buffer.batch_size
        self.device = buffer.device
        self.offsets, size, header = self.layout.buffer(self.n_buf,
                                                        self.device)
        self.slab = torch.empty((size,), dtype=torch.uint8,
                                device=self.device)
        self.slab[:8 * len(header)].view(torch.int64).copy_(header)
        for (name, view), t in zip(self.views().items(),
                                   buffer.tensors().values()):
            if t.device != self.device:
                raise ValueError(f"buffer field {name} must be on "
                                 f"{self.device}, got {t.device}")
            view.copy_(t)
        self.ptr = self.slab.data_ptr()

    def views(self) -> dict:
        """Each field's rows in the slab, by name, as (n_buf, ...) tensors
        of its dtype."""
        return {f.name: self.slab[o:o + self.n_buf * f.row_bytes]
                .view(f.dtype).view(self.n_buf, *f.shape)
                for f, o in zip(self.layout.fields, self.offsets)}


class _Packed:
    """The last buffer packed, by identity (a weak reference: a buffer
    dropped is not kept)."""

    ref, packed = None, None

    @classmethod
    def of(cls, buffer: EnvState) -> PackedBuffer:
        if cls.ref is None or cls.ref() is not buffer:
            cls.packed = PackedBuffer(buffer)
            cls.ref = weakref.ref(buffer)
        return cls.packed


def fresh_select_cuda(keys, done, state: EnvState, buffer: EnvState, cursor,
                      window: int, finishers, salt: tuple):
    """The fresh reset's routing and select of CUDA tensors, one launch:
    (the selected state, reset_overflow, new cursor), as
    ``envs/base.py::fresh_candidates`` then ``select_reset_states`` compute
    them. ``finishers`` as for ``fresh_candidates``: the block's finisher
    count (one ``sum``) goes to it, and its offset and total to the kernel;
    ``salt``: ``RESET_RNG_SALT``'s two words as ints."""
    packed = _Packed.of(buffer)
    if not 1 <= window <= packed.n_buf:
        raise ValueError(f"window must be in [1, {packed.n_buf}], got "
                         f"{window}")
    layout = packed.layout
    tensors = state.tensors()
    if tuple(tensors) != layout.names:
        raise ValueError(f"the state's tensors {tuple(tensors)} are not the "
                         f"buffer's {layout.names}")
    offset = total = None
    if finishers is not None:
        offset, total = finishers(done.sum(dtype=torch.int32))
    inputs = [keys, done, cursor, offset, total, *tensors.values()]
    B = state.batch_size
    native.check(inputs, layout.specs(B))
    dev = keys.device
    if packed.device != dev:
        raise ValueError(f"the buffer must be on {dev}, got {packed.device}")
    stream = native.stream(dev)
    fields, out, overflow, new_cursor, scalars = layout.take(B, dev, stream)
    LIBRARY.launch("fresh_select_launch", [
        packed.ptr, *(0 if t is None else t.data_ptr() for t in inputs[:5]),
        scalars, scalars + 4, *(t.data_ptr() for t in inputs[5:]),
        *layout.pad, *out, *layout.pad],
        (B, packed.n_buf, window, len(fields), RNG, *salt), stream)
    native.COUNTERS.select_launches += 1
    extra = (None if state.extra is None
             else dict(zip(layout.extra_keys, fields[len(STATE_FIELDS):])))
    return (EnvState(*fields[:len(STATE_FIELDS)], extra=extra), overflow,
            new_cursor)
