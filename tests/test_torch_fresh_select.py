"""The fresh reset's select kernel (minigrid_tpu_torch/ops/fresh_select.py)
on the CPU: the field table it reads from a state, the packed buffer it
builds once a buffer, and the routing that keeps CPU tensors on the plain
version (``envs/base.py::fresh_candidates`` then ``select_reset_states``),
looked up through the module. The kernel runs only on the card
(tests/test_torch_kernel_gpu.py)."""

from __future__ import annotations

import pytest
import torch

import minigrid_tpu_torch
from minigrid_tpu_torch.core.types import STATE_FIELDS
from minigrid_tpu_torch.envs import base
from minigrid_tpu_torch.ops import fresh_select as FS
from minigrid_tpu_torch.ops import native

from tests.torch_port_utils import share_cpu  # noqa: F401
from tests.torch_port_utils import CPU

pytestmark = pytest.mark.usefixtures("share_cpu")

# each env's bytes a row, summed over its fields: DoorKey-8x8 has no
# ``extra``; a BabyAI level adds 19 entries, whose two masks are (8, H)
# int32
ROW_BYTES = {"MiniGrid-DoorKey-8x8-v0": 735, "BabyAI-PutNextLocal-v0": 1431,
             "BabyAI-BossLevel-v0": 4427}
_CASES: dict = {}


def _case(env_id: str):
    """(env, a state of 3 envs, a fresh buffer of 5 rows), made once."""
    if env_id not in _CASES:
        env = minigrid_tpu_torch.make(env_id, device=CPU).packed()
        g = env.generator(0)
        _CASES[env_id] = env, env.reset(g, 3)[1], env.presample_fresh(g, 5)
    return _CASES[env_id]


@pytest.mark.parametrize("env_id", list(ROW_BYTES))
def test_field_table_order_and_row_bytes(env_id):
    """The field table lists the state's tensors in ``tensors()`` order,
    the fields first and ``extra`` after, each with its dtype, one env's
    shape and its bytes."""
    _, st, _ = _case(env_id)
    table = FS.field_table(st)
    tensors = st.tensors()
    assert tuple(f.name for f in table) == tuple(tensors)
    assert tuple(f.name for f in table[:len(STATE_FIELDS)]) == STATE_FIELDS
    assert len(table) == (9 if st.extra is None else 28)
    for f, t in zip(table, tensors.values()):
        assert (f.dtype, f.shape) == (t.dtype, tuple(t.shape[1:]))
        assert f.row_bytes == t[0].numel() * t.element_size()
    assert sum(f.row_bytes for f in table) == ROW_BYTES[env_id]
    assert table[FS.RNG].name == "rng" and table[FS.RNG].row_bytes == 8


@pytest.mark.parametrize("env_id", list(ROW_BYTES))
def test_packed_buffer_views_equal_its_fields(env_id):
    """The packed buffer's views are its fields, each starting at a
    multiple of ``ALIGN`` bytes of the slab, and its header holds each
    field's bytes a row and the offset of its rows."""
    _, _, buffer = _case(env_id)
    packed = FS.PackedBuffer(buffer)
    views, tensors = packed.views(), buffer.tensors()
    assert tuple(views) == tuple(tensors)
    for k, t in tensors.items():
        assert views[k].dtype == t.dtype and torch.equal(views[k], t), k
    table = packed.layout.fields
    header = packed.slab[:16 * len(table)].view(torch.int64).tolist()
    assert header[0::2] == [f.row_bytes for f in table]
    assert header[1::2] == list(packed.offsets)
    assert all(o % FS.ALIGN == 0 for o in packed.offsets)


def test_cpu_fresh_step_takes_the_plain_path(monkeypatch):
    """A fresh step of CPU tensors calls ``base.fresh_candidates`` (the name
    the benchmark's fault test replaces) and ``select_reset_states``, never
    the kernel's wrapper, and launches nothing."""
    env, st, buffer = _case("MiniGrid-DoorKey-8x8-v0")
    calls = []

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        monkeypatch.setattr(base, name, wrapped)

    spy("fresh_candidates", base.fresh_candidates)
    spy("select_reset_states", base.select_reset_states)
    monkeypatch.setattr(FS, "fresh_select_cuda", None)
    launches = native.COUNTERS.select_launches
    st = st.replace(step_count=torch.full((3,), 639, dtype=torch.int32))
    keys = torch.zeros((3, 2), dtype=torch.int32)
    a = torch.zeros(3, dtype=torch.int32)
    out = env.step_autoreset_fresh(keys, st, a, buffer,
                                   torch.zeros((), dtype=torch.int32), 4)
    assert calls == ["fresh_candidates", "select_reset_states"]
    assert native.COUNTERS.select_launches == launches
    assert out[4].all() and int(out[6]) == 3
    assert torch.equal(out[1].grid, buffer.grid[:3])


def test_select_refuses_a_state_that_is_not_the_buffers():
    """The kernel's wrapper raises, before any launch, for a window
    outside [1, n_buf] and for a state whose tensors are not the buffer's
    (another family's)."""
    _, st, buffer = _case("MiniGrid-DoorKey-8x8-v0")
    _, level, _ = _case("BabyAI-PutNextLocal-v0")
    keys = torch.zeros((3, 2), dtype=torch.int32)
    done = torch.ones(3, dtype=torch.bool)
    cursor = torch.zeros((), dtype=torch.int32)
    for window in (0, 6):
        with pytest.raises(ValueError, match="window must be in"):
            FS.fresh_select_cuda(keys, done, st, buffer, cursor, window,
                                 None, base._SALT_WORDS)
    with pytest.raises(ValueError, match="are not the buffer's"):
        FS.fresh_select_cuda(keys, done, level, buffer, cursor, 4, None,
                             base._SALT_WORDS)
