"""The port's one route to its hand-written CUDA kernels: the build, the
load, the input checks, the stream, the call, its errors and the count of
launches.

A kernel is a ``.cu`` file under ``csrc/`` with a plain C interface. Each
of its entries takes a host table of device pointers, the pointer fields of
its argument struct in order (a constant in the ``.cu`` counts them, and a
``static_assert`` on ``offsetof`` holds the struct to it), then its ints
and the raw CUDA stream, and returns 0 or a code that the library's own
``<stem>_error_string`` names. A :class:`Library` is compiled with ``nvcc``
at its first call, never at import, into a shared library under
``minigrid_tpu_torch/_build/`` (named by a hash of the source and flags, so
an edited source is rebuilt), and loaded with ``ctypes``.
"""

from __future__ import annotations

import array
import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def build(sources: tuple) -> tuple[Path, str]:
    """Compile ``sources`` (``.cu`` files) into one library, named after the
    first, under :data:`BUILD_DIR` (once per sources and flag set), and
    return (library path, compiler output). The output carries ptxas's
    register, shared-memory and spill report; empty when already built."""
    src = b"".join(Path(path).read_bytes() for path in sources)
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{Path(sources[0]).stem}_{tag}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


@dataclasses.dataclass
class KernelCounters:
    """Launches of the hand-written kernels: the fused step's step entry
    (``launches``) and observe entry (``observe_launches``), of those the
    launches at views wider than ``fused_step.NARROW_VIEW`` (the 64-bit-row
    family: ``wide_launches``, ``wide_observe_launches``), the BabyAI
    post-step's (``verify_launches``) and the fresh reset's select
    (``select_launches``); plain ints that only the launches add to."""

    launches: int = 0
    observe_launches: int = 0
    wide_launches: int = 0
    wide_observe_launches: int = 0
    verify_launches: int = 0
    select_launches: int = 0


COUNTERS = KernelCounters()


def stream(device: torch.device) -> int:
    """The raw handle of ``device``'s current stream
    (``torch.cuda.current_stream`` builds a Stream object, ~4 us of host a
    call on an H100's host); raises ``ValueError`` for a device that is not
    CUDA's."""
    if device.type != "cuda":
        raise ValueError(f"the kernels take CUDA tensors, got {device}")
    return torch._C._cuda_getCurrentRawStream(device.index)


def check(tensors, specs) -> None:
    """Raise ``ValueError``, naming the tensor at fault, unless each of
    ``tensors`` (None: a null pointer, not checked) lies on the device of
    the first, contiguous, with the dtype and shape of its
    ``(name, dtype, shape)`` in ``specs``, and holds an element (no kernel
    takes an empty launch)."""
    device = tensors[0].device
    for t, (name, dtype, shape) in zip(tensors, specs):
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{name} must be on {device}, got {t.device}")
        if t.dtype != dtype or t.shape != shape:
            raise ValueError(f"{name} must be {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if 0 in shape:
            raise ValueError(f"{name} must not be empty")


class Library:
    """One kernel's library: its ``source`` and its C ``entries``, each with
    the number of device pointers in its table and of ints after it.
    ``build_log`` is the compiler's output of the build that made it (empty
    when it was already built)."""

    def __init__(self, source: Path, entries: dict[str, tuple[int, int]]):
        self.source, self.entries = source, entries
        self.build_log = ""
        self._lib = None

    def load(self) -> ctypes.CDLL:
        """The library, built where needed, loaded and its functions
        declared at the first call."""
        if self._lib is None:
            path, self.build_log = build((self.source,))
            lib = ctypes.CDLL(str(path))
            for name, (_, ints) in self.entries.items():
                fn = getattr(lib, name)
                fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * ints
                               + [ctypes.c_void_p])
                fn.restype = ctypes.c_int
            error = getattr(lib, f"{self.source.stem}_error_string")
            error.argtypes = [ctypes.c_int]
            error.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def call(self, entry: str, tensors, ints, stream: int) -> None:
        """Launch ``entry`` on ``stream`` with the table of ``tensors``'
        device pointers (None: a null pointer) and ``ints``; raise
        ``RuntimeError`` with the library's own error string when it
        returns nonzero."""
        self.launch(entry, [0 if t is None else t.data_ptr()
                            for t in tensors], ints, stream)

    def launch(self, entry: str, pointers: list, ints, stream: int) -> None:
        """:meth:`call` with the table given as device pointers (ints, 0
        for null): a caller that keeps its outputs' pointers passes them
        without a ``data_ptr`` a call."""
        count, int_count = self.entries[entry]
        if len(pointers) != count or len(ints) != int_count:
            raise ValueError(f"{entry} takes {count} pointers and "
                             f"{int_count} ints, got {len(pointers)} and "
                             f"{len(ints)}")
        lib = self.load()
        table = array.array("q", pointers)
        code = getattr(lib, entry)(table.buffer_info()[0], *ints, stream)
        if code != 0:
            error = getattr(lib, f"{self.source.stem}_error_string")
            raise RuntimeError(f"{entry} failed: {error(code).decode()}")
