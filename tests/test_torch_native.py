"""The port's one route to its hand-written kernels
(minigrid_tpu_torch/ops/native.py), on the CPU: the input check names the
tensor at fault for every fault and every input of the kernels, and each
C entry's pointer table, as the ``.cu`` declares it, is the table its
wrapper passes. The kernels themselves run only on the card
(tests/test_torch_kernel_gpu.py)."""

from __future__ import annotations

import re

import pytest
import torch

import minigrid_tpu_torch
from minigrid_tpu_torch.envs import base
from minigrid_tpu_torch.envs.babyai.core import post_step as PS
from minigrid_tpu_torch.ops import fresh_select as FS
from minigrid_tpu_torch.ops import fused_step as F
from minigrid_tpu_torch.ops import native

from tests.torch_port_utils import share_cpu  # noqa: F401
from tests.torch_port_utils import CPU

pytestmark = pytest.mark.usefixtures("share_cpu")

B, T = 4, 2


@pytest.fixture(scope="module")
def doorkey():
    """(params, states, actions (T, B), reset rows (T, ...)) of DoorKey."""
    env = minigrid_tpu_torch.make("MiniGrid-DoorKey-8x8-v0", device=CPU)
    _, st = env.reset(env.generator(0), B)
    grid, scal = F.pack_rows(st)
    actions = torch.zeros((T, B), dtype=torch.int32)
    return env.params, st, actions, grid[:T], scal[:T]


@pytest.fixture(scope="module")
def level():
    """(params, the post-step's arguments) of one PutNextLocal step."""
    env = minigrid_tpu_torch.make("BabyAI-PutNextLocal-v0",
                                  device=CPU).packed()
    st = env._gen_grid(env.generator(0), B)
    a = torch.zeros(B, dtype=torch.int32)
    new, _, reward, term, _ = F.fused_rollout(env.params, st, a[None])
    return env.params, (st, new, a, reward[0], term[0])


def _select_inputs(st) -> list:
    """The fresh select's inputs (keys, done, cursor, offset, total, then
    the state's tensors) for a state that is its own buffer."""
    i32 = torch.int32
    return [torch.zeros((B, 2), dtype=i32), torch.ones(B, dtype=torch.bool),
            torch.zeros((), dtype=i32), torch.zeros((), dtype=i32),
            torch.full((), B, dtype=i32), *st.tensors().values()]


def _inputs(kernel, doorkey, level):
    """(tensors, specs) of ``kernel``'s inputs, in its table's order."""
    if kernel == "fresh_select":
        st = doorkey[1]
        return _select_inputs(st), FS.PackedBuffer(st).layout.specs(B)
    if kernel == "babyai_post_step":
        params, args = level
        return (PS._inputs(*args),
                PS._specs(B, params.width, params.height))
    params, st, actions, grid, scal = doorkey
    specs = F._specs(T, B, params.width, params.height)
    if kernel == "fused_observe":
        return F._inputs(st, None, None, None)[:4], specs
    return F._inputs(st, actions, grid, scal), specs


FAULTS = {
    "device": (lambda t: t.to("meta"), "must be on cpu"),
    "dtype": (lambda t: t.to(torch.int64), "must be torch"),
    "shape": (lambda t: torch.cat([t, t]) if t.ndim else t.reshape(1),
              "must be torch"),
    "contiguity": (lambda t: torch.stack([t, t], -1)[..., 0],
                   "must be contiguous"),
}


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("kernel", ["fused_step", "fused_observe",
                                    "babyai_post_step", "fresh_select"])
def test_check_names_the_tensor_at_fault(kernel, fault, doorkey, level):
    """``native.check`` passes a kernel's inputs as its wrapper gathers
    them (a null reset row too) and, for each input in turn given on
    another device, in another dtype or shape, or strided, raises
    ``ValueError`` naming that input. The first input sets the device."""
    tensors, specs = _inputs(kernel, doorkey, level)
    native.check(tensors, specs)
    if kernel == "fused_step":
        native.check(tensors[:6] + [None, None], specs)
    make, says = FAULTS[fault]
    for i in range(fault == "device", len(tensors)):
        if fault == "contiguity" and tensors[i].ndim == 0:
            continue  # a scalar is contiguous whatever its view
        bad = list(tensors)
        bad[i] = make(tensors[i])
        with pytest.raises(ValueError, match=re.escape(specs[i][0])
                           + " " + says):
            native.check(bad, specs)


def _empty(t):
    return t[:0]


EMPTY_LAUNCHES = {
    "fused_step B=0": lambda p, st, a, lv: F._fused_rollout_cuda(
        p, st.map(_empty), a[:, :0], False, None, None),
    "fused_step T=0": lambda p, st, a, lv: F._fused_rollout_cuda(
        p, st, a[:0], False, None, None),
    "fused_observe B=0": lambda p, st, a, lv: F._fused_observe_cuda(
        p, st.map(_empty)),
    "babyai_post_step B=0": lambda p, st, a, lv: PS._babyai_post_step_cuda(
        lv[0], *(x.map(_empty) for x in lv[1][:2]),
        *map(_empty, lv[1][2:]), False),
    "fresh_select B=0": lambda p, st, a, lv: FS.fresh_select_cuda(
        *map(_empty, _select_inputs(st)[:2]), st.map(_empty), st,
        *_select_inputs(st)[2:3], 4, None, base._SALT_WORDS),
}


@pytest.mark.parametrize("launch", list(EMPTY_LAUNCHES))
def test_wrappers_refuse_empty_launches(launch, doorkey, level):
    """An empty batch, or no steps, is refused by ``native.check`` before
    any stream, allocation or launch: no kernel takes an empty grid."""
    params, st, actions = doorkey[:3]
    with pytest.raises(ValueError, match="must not be empty"):
        EMPTY_LAUNCHES[launch](params, st, actions, level)


def _declared(source, entry) -> tuple[int, int]:
    """(device pointers, ints) of a C entry as its ``.cu`` declares them:
    the table's constant, which its ``static_assert`` ties to the argument
    struct, and the ints between the table and the stream."""
    src = source.read_text()
    sig = re.search(rf"int {entry}\(([^)]*)\)\s*\{{(.*?)\n\}}", src, re.S)
    params = [p.strip() for p in sig.group(1).split(",")]
    assert params[0] == "const void* const* pointers"
    assert params[-1] == "void* stream"
    assert all(p.startswith("int ") for p in params[1:-1])
    const = re.search(r"sizeof\(void\*\) \* (k\w+)", sig.group(2))
    assert sig.group(2).count(f"sizeof(void*) * {const.group(1)}") == 2
    count = re.search(rf"constexpr int {const.group(1)} = (\d+);", src)
    return int(count.group(1)), len(params) - 2


class _Recorder:
    """A stand-in library that records the calls made of it."""

    def __init__(self, real):
        self.entries, self.calls = real.entries, []

    def call(self, entry, tensors, ints, stream):
        self.calls.append((entry, list(tensors), tuple(ints), stream))

    def launch(self, entry, pointers, ints, stream):
        self.calls.append((entry, list(pointers), tuple(ints), stream))


@pytest.mark.parametrize("entry", ["fused_step_launch",
                                   "fused_step_launch (reset row)",
                                   "fused_observe_launch",
                                   "babyai_post_step_launch"])
def test_pointer_tables_match_the_sources(entry, doorkey, level,
                                          monkeypatch):
    """Each C entry's pointer and int counts, as the ``.cu`` declares them,
    are its library's, and its wrapper passes a table of exactly that many
    pointers on the CPU (a stand-in library, stream and SM count): the
    inputs ``native.check`` checked first, in order, then the outputs."""
    entry, _, reset = entry.partition(" ")
    module = PS if entry.startswith("babyai") else F
    monkeypatch.setattr(module, "LIBRARY", _Recorder(module.LIBRARY))
    monkeypatch.setattr(native, "stream", lambda device: 7)
    monkeypatch.setattr(native, "COUNTERS", native.KernelCounters())
    monkeypatch.setattr(F, "sm_count", lambda device: 132)
    assert _declared(module.SOURCE, entry) == module.LIBRARY.entries[entry]
    pointers, ints = module.LIBRARY.entries[entry]
    if entry == "babyai_post_step_launch":
        params, args = level
        PS._babyai_post_step_cuda(params, *args, False)
        inputs = PS._inputs(*args)
    elif entry == "fused_observe_launch":
        params, st = doorkey[:2]
        F._fused_observe_cuda(params, st)
        inputs = F._inputs(st, None, None, None)[:4]
    else:
        params, st, actions, grid, scal = doorkey
        rows = (grid, scal) if reset else (None, None)
        F._fused_rollout_cuda(params, st, actions, False, *rows)
        inputs = F._inputs(st, actions, *rows)
    [(called, table, got_ints, stream)] = module.LIBRARY.calls
    assert (called, len(table), len(got_ints), stream) == (entry, pointers,
                                                           ints, 7)
    assert all(t is u for t, u in zip(table, inputs))
    assert all(t is not None for t in table[len(inputs):])
    assert sum(vars(native.COUNTERS).values()) == 1


@pytest.mark.parametrize("sharded", [False, True])
def test_select_pointer_table_matches_the_source(sharded, doorkey,
                                                 monkeypatch):
    """The fresh select's C entry takes the pointer and int counts its
    ``.cu`` declares, and its wrapper passes that many on the CPU (a
    stand-in library and stream): the packed buffer, the inputs in
    ``native.check``'s order (null offset and total for a whole batch),
    overflow and cursor, the state's fields, then the outputs, which are
    the tensors it returns, each group padded with nulls to
    ``MAX_FIELDS``."""
    entry = "fresh_select_launch"
    monkeypatch.setattr(FS, "LIBRARY", _Recorder(FS.LIBRARY))
    monkeypatch.setattr(native, "stream", lambda device: 7)
    monkeypatch.setattr(native, "COUNTERS", native.KernelCounters())
    assert _declared(FS.SOURCE, entry) == FS.LIBRARY.entries[entry]
    st = doorkey[1]
    inputs = _select_inputs(st)
    finishers = (lambda count: tuple(inputs[3:5])) if sharded else None
    new, overflow, cursor = FS.fresh_select_cuda(
        *inputs[:2], st, st, inputs[2], 4, finishers, base._SALT_WORDS)
    [(called, table, ints, stream)] = FS.LIBRARY.calls
    n, pad = len(inputs) - 5, [0] * (FS.MAX_FIELDS - len(inputs) + 5)
    assert (called, len(table), stream) == (entry, 8 + 2 * FS.MAX_FIELDS, 7)
    assert ints == (B, B, 4, n, FS.RNG, *base._SALT_WORDS)
    ptr = [0 if t is None or (not sharded and i in (3, 4)) else t.data_ptr()
           for i, t in enumerate(inputs)]
    assert table[0] == FS._Packed.packed.ptr
    assert table[1:6] == ptr[:5]
    assert table[6:8] == [overflow.data_ptr(), cursor.data_ptr()]
    assert table[8:8 + FS.MAX_FIELDS] == ptr[5:] + pad
    assert table[8 + FS.MAX_FIELDS:] == [
        t.data_ptr() for t in new.tensors().values()] + pad
    assert sum(vars(native.COUNTERS).values()) == 1
