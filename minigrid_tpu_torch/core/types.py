"""Core state/params types, batch-leading.

Counterpart of ``minigrid_tpu/core/types.py``. Where the JAX package keeps one
episode per pytree and batches with ``vmap``, an :class:`EnvState` here holds a
whole batch: every field carries a leading ``B`` axis. Field layouts and dtypes
match the JAX state exactly (grid ``(B, W, H, 5)`` uint8 indexed ``[x, y]``),
so states cross between the two packages as numpy arrays (see ``convert.py``).
"""

from __future__ import annotations

import dataclasses

import torch

from minigrid_tpu_torch.core import constants as C

# Fixed token length for tokenized mission strings (the JAX package's value).
MISSION_LEN = 96


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the
    card. With no device given and no card present this raises: the port
    never falls back to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' explicitly to "
            "run on the CPU")
    return torch.device("cuda")


def device_of(*values, device=None) -> torch.device:
    """The device of an entry point that takes tensors or plain values:
    ``device`` when given, else the first tensor's, else the card
    (:func:`resolve_device`)."""
    if device is None:
        for v in values:
            if isinstance(v, torch.Tensor):
                return v.device
    return resolve_device(device)


@dataclasses.dataclass(frozen=True)
class EnvState:
    """Batched environment state: B episodes, one per leading index."""

    grid: torch.Tensor        # (B, W, H, 5) uint8 — constants.NUM_CHANNELS
    agent_pos: torch.Tensor   # (B, 2) int32 — (x, y)
    agent_dir: torch.Tensor   # (B,) int32 — 0..3
    carrying: torch.Tensor    # (B, 5) uint8 — EMPTY_CELL when empty
    step_count: torch.Tensor  # (B,) int32
    terminated: torch.Tensor  # (B,) bool
    truncated: torch.Tensor   # (B,) bool
    mission: torch.Tensor     # (B, MISSION_LEN) int32 token ids (0 = pad)
    rng: torch.Tensor         # (B, 2) int32 — bit pattern of a JAX-style key
    # family-specific state, a dict of batch-leading tensors (e.g. Memory's
    # success_pos (B, 2) int32), or None: JAX's ``extra`` pytree, batched
    extra: dict | None = None

    def replace(self, **kw) -> "EnvState":
        return dataclasses.replace(self, **kw)

    @property
    def batch_size(self) -> int:
        return self.agent_dir.shape[0]

    @property
    def device(self) -> torch.device:
        return self.grid.device

    def tensors(self) -> dict:
        """Every tensor by name: the fields, then each entry of ``extra``
        as ``"extra.<key>"``."""
        out = {f: getattr(self, f) for f in STATE_FIELDS}
        for k, v in (self.extra or {}).items():
            out[EXTRA_PREFIX + k] = v
        return out

    def with_tensors(self, tensors: dict) -> "EnvState":
        """This state with the tensors named as :meth:`tensors` names them
        replaced; ``extra`` keeps its keys."""
        kw = {k: v for k, v in tensors.items() if k in STATE_FIELDS}
        if self.extra is not None:
            kw["extra"] = {k: tensors.get(EXTRA_PREFIX + k, v)
                           for k, v in self.extra.items()}
        return self.replace(**kw)

    def map(self, fn) -> "EnvState":
        """Apply ``fn`` to every tensor, ``extra``'s included (e.g. index
        or move)."""
        return self.with_tensors({k: fn(v)
                                  for k, v in self.tensors().items()})


STATE_FIELDS = ("grid", "agent_pos", "agent_dir", "carrying", "step_count",
                "terminated", "truncated", "mission", "rng")
EXTRA_PREFIX = "extra."


@dataclasses.dataclass(frozen=True)
class EnvParams:
    """Static configuration shared by every environment; the same fields
    and defaults as the JAX package's ``EnvParams``."""

    width: int = 8
    height: int = 8
    view_size: int = 7
    max_steps: int = 100
    see_through_walls: bool = False
    # False: {image: (B, V, V, 3) uint8}; True: {packed: (B, V, V) int32},
    # 9 bits per cell = type | color << 4 | state << 7
    packed_obs: bool = False

    def __post_init__(self):
        if self.view_size % 2 != 1 or self.view_size < 3:
            raise ValueError(f"view_size must be odd and >= 3, got "
                             f"{self.view_size}")


def is_carrying(state: EnvState) -> torch.Tensor:
    """(B,) bool: whether each agent carries an object."""
    return state.carrying[..., 0] != C.EMPTY


def pack_cell(type_idx, color_idx=0, state_idx=0, cont_type=0, cont_color=0,
              device=None) -> torch.Tensor:
    """A (..., 5) uint8 cell from its channels, each an int or a tensor:
    ints give one (5,) cell, (B,) tensors one cell per env (JAX
    ``pack_cell``, under ``vmap``). On ``device``, else on the tensors'
    (:func:`device_of`)."""
    chans = (type_idx, color_idx, state_idx, cont_type, cont_color)
    dev = device_of(*chans, device=device)
    chans = [torch.as_tensor(c, device=dev).to(torch.uint8) for c in chans]
    shape = torch.broadcast_shapes(*(c.shape for c in chans))
    return torch.stack([c.expand(shape) for c in chans], dim=-1)
