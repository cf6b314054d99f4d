"""The (data, model) grid of ranks and the sharding layout, on
``torch.distributed``.

Counterpart of ``minigrid_tpu/parallel/mesh.py``. Where the JAX package lays
one program over a 2-D device mesh and lets GSPMD insert the collectives,
here each rank is a process stepping its own shard, and the few collectives
are explicit:

- ``data``: batched env states and rollout tensors split their batch axis
  over the data ranks (contiguous blocks of B/n envs); the learner
  all-reduces its gradients and its statistics over them
  (``models/ppo.py``), and the fresh reset all-reduces a step's finisher
  counts over them to route one global buffer. Nothing else in the env
  path communicates.
- ``model``: dense kernels and embedding tables split their output features
  over the model ranks (tensor parallelism, :func:`param_spec`); each
  sharded layer's output is gathered before the next layer reads it.

Rank ``r`` of ``n`` sits at ``(r // m, r % m)`` for ``model_parallel=m``,
as JAX's ``devices.reshape(n // m, m)`` places it. :func:`init_ranks` joins
a process group, :func:`spawn` starts one, and ``torchrun`` users bring
their own. Backends: ``"nccl"`` with one card per rank, ``"gloo"`` on the
CPU or for several ranks sharing one card. Only ``all_reduce`` runs (gloo
runs it on CUDA tensors too).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import queue as queue_module
import tempfile
import traceback
from typing import Any, Callable

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

DATA_AXIS = "data"
MODEL_AXIS = "model"
BACKENDS = ("nccl", "gloo")
# how long a collective may wait for the other ranks
COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=10)


# --------------------------------------------------------------------------
# process groups
# --------------------------------------------------------------------------

def rank_device(n: int, backend: str | None = None, device=None,
                rank: int = 0) -> tuple[str, torch.device]:
    """(backend, device) of rank ``rank`` in a world of ``n``. ``device``
    None means the cards. ``"nccl"`` (the default on cards) puts rank r on
    ``cuda:r`` and needs a card a rank; ``"gloo"`` (the default on the CPU)
    puts rank r on ``cuda:(r % cards)``, or on the one card ``device``
    names, so several ranks can share a card."""
    dev = torch.device(device if device is not None else "cuda")
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if dev.type != "cuda":
        if backend == "nccl":
            raise ValueError(f"backend='nccl' needs CUDA devices, got "
                             f"device={str(dev)!r}; use backend='gloo'")
        return backend, dev
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "explicitly to run the ranks on the CPU")
    cards = torch.cuda.device_count()
    if backend == "nccl":
        if dev.index is not None and n > 1:
            raise ValueError(
                f"backend='nccl' puts rank r on cuda:r; {n} ranks cannot all "
                f"run on {dev} (pass device='cuda', or backend='gloo' for "
                "ranks sharing one card)")
        if n > cards:
            raise ValueError(
                f"backend='nccl' needs a card a rank: {n} ranks, {cards} "
                "card(s); pass backend='gloo' for ranks sharing a card")
        return backend, torch.device("cuda", rank if dev.index is None
                                     else dev.index)
    return backend, torch.device("cuda", rank % cards if dev.index is None
                                 else dev.index)


# the device of this process's rank, set by :func:`init_ranks`
_RANK_DEVICE = None


def init_ranks(n: int, backend: str | None = None, device=None,
               rank: int = 0, store: str | None = None) -> torch.device:
    """Join this process to a world of ``n`` ranks as rank ``rank`` and
    return its device (:func:`rank_device`; a card becomes the current
    one; :func:`joined_device` returns it later). ``store``: the path of
    the ranks' shared ``FileStore``; a world of one may leave it None (an
    in-memory store). Leave the group with
    ``torch.distributed.destroy_process_group()``."""
    global _RANK_DEVICE
    backend, dev = rank_device(n, backend, device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if store is None:
        if n != 1:
            raise ValueError("a world of more than one rank needs a store "
                             "path that every rank shares")
        st = dist.HashStore()
    else:
        st = dist.FileStore(store, n)
    dist.init_process_group(backend, store=st, rank=rank, world_size=n,
                            timeout=COLLECTIVE_TIMEOUT)
    _RANK_DEVICE = dev
    return dev


def joined_device() -> torch.device:
    """The device :func:`init_ranks` gave this process's rank (in a rank
    that :func:`spawn` started, the device its function runs on)."""
    if _RANK_DEVICE is None:
        raise RuntimeError("this process joined no group through init_ranks")
    return _RANK_DEVICE


# the queue of the spawn that started this process (set in a spawned rank
# only): :func:`report` posts to it
_REPORT_QUEUE = None


def report(obj) -> None:
    """Hand ``obj`` to the ``on_message`` callback of the :func:`spawn`
    that started this rank (a no-op in a process that spawn did not
    start)."""
    if _REPORT_QUEUE is not None:
        _REPORT_QUEUE.put(("message", dist.get_rank(), obj))


def _rank_main(fn, rank, n, backend, device, store, args, out):
    global _REPORT_QUEUE
    _REPORT_QUEUE = out
    try:
        init_ranks(n, backend, device, rank, store)
        out.put(("result", rank, fn(*args)))
    except BaseException:  # reported to the parent, which raises it
        out.put(("error", rank, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, n: int, backend: str | None = None, device=None,
          args: tuple = (), on_message: Callable | None = None,
          timeout: float | None = None) -> list:
    """Run ``fn(*args)`` on ``n`` new ranks (processes started with the
    ``spawn`` method, each joined by :func:`init_ranks` to a world of
    ``n`` over a ``FileStore`` in a temporary directory) and return their
    results in rank order. ``fn`` must be importable by name, and its
    arguments and result picklable (return CPU tensors or numpy). A rank's
    :func:`report` calls ``on_message`` here. A rank that fails, or dies,
    stops the others, and this raises ``RuntimeError`` with its traceback;
    ``timeout`` (seconds) bounds the wait."""
    import multiprocessing

    rank_device(n, backend, device)  # refuse a bad layout before starting
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    results, procs = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        try:
            for r in range(n):
                p = ctx.Process(target=_rank_main, daemon=True, args=(
                    fn, r, n, backend, device, store, args, out))
                p.start()
                procs.append(p)
            waited = 0.0
            while len(results) < n:
                try:
                    kind, rank, value = out.get(timeout=1.0)
                except queue_module.Empty:
                    waited += 1.0
                    dead = [(r, p.exitcode) for r, p in enumerate(procs)
                            if r not in results and p.exitcode is not None]
                    if dead:
                        raise RuntimeError(f"rank(s) exited without a "
                                           f"result (rank, exit code): "
                                           f"{dead}")
                    if timeout is not None and waited > timeout:
                        raise TimeoutError(f"ranks did not finish in "
                                           f"{timeout} s")
                    continue
                if kind == "error":
                    raise RuntimeError(f"rank {rank} of {n} failed:\n{value}")
                if kind == "message":
                    if on_message is not None:
                        on_message(value)
                    continue
                results[rank] = value
            for p in procs:
                p.join(timeout=60)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join()
            out.close()
    return [results[r] for r in range(n)]


# --------------------------------------------------------------------------
# the mesh
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the ``(data, model)`` grid and its two groups:
    ``data_group``, the ranks holding the same model shard (gradients and
    statistics are all-reduced over it), and ``model_group``, the ranks
    holding the same envs (the tensor-parallel gathers run over it)."""

    shape: tuple[int, int]
    rank: int
    data_group: Any
    model_group: Any

    @property
    def data_size(self) -> int:
        return self.shape[0]

    @property
    def model_size(self) -> int:
        return self.shape[1]

    @property
    def data_rank(self) -> int:
        return self.rank // self.shape[1]

    @property
    def model_rank(self) -> int:
        return self.rank % self.shape[1]

    def batch_slice(self, num_envs: int) -> slice:
        """This data rank's envs of a global batch of ``num_envs``."""
        return batch_sharding(self).rows(num_envs)


def make_mesh(n_devices: int | None = None,
              model_parallel: int | None = None) -> Mesh:
    """The 2-D ``(data, model)`` mesh over the initialised process group of
    ``n_devices`` ranks (the world size by default). ``model_parallel``
    defaults to 1 (pure data parallelism), as in JAX: the flagship
    ActorCritic is ~1.3 MB of parameters, and tensor parallelism adds
    collectives to every layer. Every rank must call it alike (it creates
    the groups)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(init_ranks, spawn or torchrun)")
    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}")
    m = model_parallel or 1
    if n % m:
        raise ValueError(f"model_parallel={m} does not divide {n} ranks")
    rows = n // m
    data_groups = [dist.new_group([i * m + j for i in range(rows)])
                   for j in range(m)]
    model_groups = [dist.new_group([i * m + j for j in range(m)])
                    for i in range(rows)]
    rank = dist.get_rank()
    return Mesh((rows, m), rank, data_groups[rank % m],
                model_groups[rank // m])


# --------------------------------------------------------------------------
# parameters: the tensor-parallel layout
# --------------------------------------------------------------------------

def param_spec(name: str, tensor: torch.Tensor) -> tuple:
    """Tensor-parallel layout of the parameter ``name`` of an
    ``ActorCritic`` or ``ActorCriticRNN``: per dimension, the mesh axis it
    is split over or None (``()``: replicated). As JAX's ``param_spec``:
    the policy and value heads replicate; every 2-D kernel splits its
    output features (dim 0 of an ``nn.Linear`` weight, JAX's kernel
    columns) and every table its feature dim; a 1-D bias of 64 or more
    entries splits; the rest replicates."""
    if "policy" in name or "value" in name:
        return ()
    if tensor.ndim == 2:
        return ((MODEL_AXIS, None) if name.endswith(".weight")
                else (None, MODEL_AXIS))
    if tensor.ndim == 1 and tensor.shape[0] >= 64:
        return (MODEL_AXIS,)
    return ()


def param_shardings(mesh: Mesh, model: nn.Module) -> dict:
    """Every parameter's :func:`param_spec`, by name (``model`` unsharded
    or sharded)."""
    return {name: param_spec(name, _full(p)) for name, p in
            model.named_parameters()}


def _full(p: torch.Tensor) -> torch.Tensor:
    """A tensor of the unsharded parameter's shape (for its spec)."""
    tp = getattr(p, "tensor_parallel", None)
    if tp is None:
        return p
    shape = list(p.shape)
    shape[p.shard_dim] *= tp.size
    return torch.empty(shape, device="meta")


class TensorParallel:
    """The gathers of the layers split over ``model``: a sharded layer
    computes its slice of the output features, which :meth:`gather`
    assembles on every model rank. Its input passes through
    :meth:`sum_grad` first, so that the input's gradient, a partial sum on
    each rank, is summed over the ranks."""

    def __init__(self, group, rank: int, size: int):
        self.group, self.rank, self.size = group, rank, size

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """(..., k) on each rank -> (..., k * size), rank r's slice at
        r*k; the backward keeps this rank's slice of the gradient."""
        return _Gather.apply(x, self)

    def sum_grad(self, x: torch.Tensor) -> torch.Tensor:
        """The identity, whose backward all-reduces the gradient."""
        return _SumGrad.apply(x, self)

    def linear(self, x, weight, bias=None) -> torch.Tensor:
        """``F.linear`` of a layer whose weight rows (output features) are
        split: the bias added before the gather where it is split too,
        after it where it is replicated."""
        split_bias = bias is not None and bias.shape[0] == weight.shape[0]
        y = self.gather(F.linear(self.sum_grad(x), weight,
                                 bias if split_bias else None))
        if bias is not None and not split_bias:
            y = y + bias
        return y


def _all_reduce_exact(x: torch.Tensor, group) -> torch.Tensor:
    """SUM all-reduce in float32 (bf16 and f16 widen exactly), in x's
    dtype."""
    buf = x.to(torch.float32) if x.dtype != torch.float32 else x
    dist.all_reduce(buf, group=group)
    return buf.to(x.dtype)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        k = x.shape[-1]
        full = x.new_zeros((*x.shape[:-1], k * tp.size))
        full[..., tp.rank * k:(tp.rank + 1) * k] = x
        # zeros elsewhere: the sum is the concatenation, exactly
        return _all_reduce_exact(full, tp.group)

    @staticmethod
    def backward(ctx, grad):
        tp = ctx.tp
        k = grad.shape[-1] // tp.size
        return grad[..., tp.rank * k:(tp.rank + 1) * k].contiguous(), None


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_exact(grad.contiguous(), ctx.tp.group), None


def shard_params(mesh: Mesh, model: nn.Module) -> nn.Module:
    """Replace, in place, each parameter that :func:`param_spec` splits by
    this model rank's slice, and mark the sharded parameters and layers
    (attribute ``tensor_parallel``) so that the forward gathers their
    outputs and ``clip_by_global_norm_`` counts their shards once. A mesh
    without model parallelism leaves the model as it is. Call it before
    making the optimizer. Returns ``model``."""
    if mesh.model_size == 1:
        return model
    tp = TensorParallel(mesh.model_group, mesh.model_rank, mesh.model_size)
    for name, p in model.named_parameters():
        spec = param_spec(name, p)
        if MODEL_AXIS not in spec:
            continue
        dim = spec.index(MODEL_AXIS)
        if p.shape[dim] % tp.size:
            raise ValueError(f"{name} {tuple(p.shape)} does not split over "
                             f"{tp.size} model ranks")
        k = p.shape[dim] // tp.size
        with torch.no_grad():
            p.data = p.data.narrow(dim, tp.rank * k, k).clone()
        p.tensor_parallel, p.shard_dim = tp, dim
    for module in model.modules():
        if (isinstance(module, nn.Linear)
                and hasattr(module.weight, "tensor_parallel")):
            module.tensor_parallel = tp
    return model


# --------------------------------------------------------------------------
# batches
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BatchSharding:
    """The split of a batch axis over the data ranks: this data rank takes
    the contiguous block :meth:`rows`; the model ranks of one data row
    hold the same envs (JAX's ``PS(DATA_AXIS)`` replicates over
    ``model``)."""

    data_rank: int
    data_size: int

    def rows(self, num_envs: int) -> slice:
        if num_envs % self.data_size:
            raise ValueError(f"a batch of {num_envs} envs does not split "
                             f"over {self.data_size} data ranks")
        k = num_envs // self.data_size
        return slice(self.data_rank * k, (self.data_rank + 1) * k)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return x[self.rows(x.shape[0])]


def batch_sharding(mesh: Mesh) -> BatchSharding:
    return BatchSharding(mesh.data_rank, mesh.data_size)


def shard_batch(mesh: Mesh, tree):
    """This data rank's block of every leaf's leading (batch) axis: a
    tensor, a dict, list or tuple of them, or an ``EnvState`` /
    ``WrappedState`` (through its ``map``)."""
    sh = batch_sharding(mesh)

    def go(x):
        if isinstance(x, torch.Tensor):
            return sh(x)
        if isinstance(x, dict):
            return {k: go(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(go(v) for v in x)
        if x is None:
            return None
        return x.map(sh)

    return go(tree)
