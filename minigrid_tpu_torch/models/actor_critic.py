"""Actor-critic policy networks.

Counterpart of ``minigrid_tpu/models/actor_critic.py``. ``ActorCritic``: the
symbolic view as one-hot type/color/state planes padded to 12/8/4 = 24
features per cell, the mission as a masked mean of token embeddings
(computed from vocabulary counts), the direction one-hot, a two-layer dense
trunk in ``dtype`` (bfloat16 by default) and float32 policy/value heads.
``ActorCriticRNN``: the same inputs through one dense layer into a GRU whose
hidden state the caller carries across steps. Weights are float32 masters,
cast to ``dtype`` at forward, as Flax's ``nn.Dense(dtype=bf16)`` does;
``convert.actor_critic_from_flax`` and ``actor_critic_rnn_from_flax`` load
the JAX package's parameters. ``parallel.shard_params`` may split a
model's layers over tensor-parallel ranks: it marks them with a
``tensor_parallel`` attribute, and the forward gathers their outputs.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core.actions import NUM_ACTIONS
from minigrid_tpu_torch.core.mission import VOCAB_SIZE
from minigrid_tpu_torch.core.types import resolve_device

N_TYPE, N_COLOR, N_STATE = 12, 8, 4
assert N_TYPE >= C.NUM_OBJECTS and N_COLOR >= C.NUM_COLORS and N_STATE >= 3
CELL_FEATURES = N_TYPE + N_COLOR + N_STATE  # 24


def _encode_planes(t, c, s, dtype):
    """(..., V, V) index planes -> (..., V*V*CELL_FEATURES) one-hot."""
    dev = t.device
    feat = torch.cat([
        t[..., None] == torch.arange(N_TYPE, device=dev),
        c[..., None] == torch.arange(N_COLOR, device=dev),
        s[..., None] == torch.arange(N_STATE, device=dev),
    ], dim=-1)
    return feat.reshape(*feat.shape[:-3], -1).to(dtype)


def encode_image(image: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """(..., V, V, 3) uint8 -> (..., V*V*24) one-hot features."""
    image = image.to(torch.int64)
    return _encode_planes(image[..., 0], image[..., 1], image[..., 2], dtype)


def encode_packed(cells: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """(..., V, V) packed int32 -> the same (..., V*V*24) features."""
    return _encode_planes(cells & 15, (cells >> 4) & 7, (cells >> 7) & 3,
                          dtype)


def mission_counts(tokens: torch.Tensor) -> torch.Tensor:
    """(..., L) token ids -> (..., VOCAB_SIZE) uint8 token counts."""
    vocab = torch.arange(VOCAB_SIZE, device=tokens.device)
    return (tokens[..., None] == vocab).sum(-2).to(torch.uint8)


def encode_obs(obs: dict, dtype=torch.uint8) -> dict:
    """Raw observation -> the policy's parameter-free input encoding
    ``{"img_feat": (..., V*V*24), "mission_counts": uint8 (..., VOCAB),
    "direction"}``: the form the rollout stores."""
    if "img_feat" in obs:
        return obs
    if "packed" in obs:
        feat = encode_packed(obs["packed"], dtype)
    else:
        feat = encode_image(obs["image"], dtype)
    counts = (obs["mission_counts"] if "mission_counts" in obs
              else mission_counts(obs["mission"]))
    return {"img_feat": feat, "mission_counts": counts,
            "direction": obs["direction"]}


def _dense(layer: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    bias = None if layer.bias is None else layer.bias.to(dtype)
    tp = getattr(layer, "tensor_parallel", None)
    if tp is not None:  # its output features split over the model ranks
        return tp.linear(x.to(dtype), layer.weight.to(dtype), bias)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def _gathered(param: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x``, computed from a parameter whose last dim may be split over
    the model ranks, gathered where it is."""
    tp = getattr(param, "tensor_parallel", None)
    return x if tp is None else tp.gather(x)


def _trunk_input(obs: dict, img_in: nn.Linear, table: torch.Tensor,
                 dt) -> torch.Tensor:
    """The encoder front both policies share: the view features through
    ``img_in`` (ReLU), the mission's mean token embedding from ``table``,
    the direction one-hot, concatenated."""
    if "img_feat" in obs:
        img = obs["img_feat"].to(dt)
    elif "packed" in obs:
        img = encode_packed(obs["packed"], dt)
    else:
        img = encode_image(obs["image"], dt)
    x = F.relu(_dense(img_in, img, dt))

    counts = (obs["mission_counts"] if "mission_counts" in obs
              else mission_counts(obs["mission"]))
    not_pad = torch.arange(VOCAB_SIZE, device=counts.device) != 0
    counts = counts.to(dt) * not_pad
    n = counts.sum(-1, keepdim=True)
    pooled = _gathered(table, counts @ table.to(dt)) / n.clamp(min=1)

    d = F.one_hot(obs["direction"].to(torch.int64), 4).to(dt)
    return torch.cat([x, pooled, d], dim=-1)


class ActorCritic(nn.Module):
    """MLP actor-critic; ``forward(obs) -> (logits (B, A) f32, value (B,)
    f32)`` on raw ("packed"/"image" + "mission" + "direction") or encoded
    observations."""

    def __init__(self, view_size: int = 7, hidden: int = 256,
                 mission_dim: int = 64, num_actions: int = NUM_ACTIONS,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        device = resolve_device(device)
        self.hidden = hidden
        self.mission_dim = mission_dim
        self.num_actions = num_actions
        self.dtype = dtype
        img = view_size * view_size * CELL_FEATURES
        self.img_in = nn.Linear(img, hidden, device=device)
        self.mission_embed = nn.Parameter(
            torch.empty(VOCAB_SIZE, mission_dim, device=device))
        self.trunk1 = nn.Linear(hidden + mission_dim + 4, hidden,
                                device=device)
        self.trunk2 = nn.Linear(hidden, hidden, device=device)
        self.policy = nn.Linear(hidden, num_actions, device=device)
        self.value = nn.Linear(hidden, 1, device=device)
        init_params(self, None)

    def forward(self, obs: dict):
        dt = self.dtype
        x = _trunk_input(obs, self.img_in, self.mission_embed, dt)
        x = F.relu(_dense(self.trunk1, x, dt))
        x = F.relu(_dense(self.trunk2, x, dt))
        logits = _dense(self.policy, x, torch.float32)
        value = _dense(self.value, x, torch.float32)
        return logits, value.squeeze(-1)


def _init_dense(layers, generator):
    """Flax's Dense initialisation: kernels LeCun-normal (truncated at 2
    sigma), biases zero."""
    for layer in layers:
        std = math.sqrt(1.0 / layer.in_features) / .87962566103423978
        nn.init.trunc_normal_(layer.weight, std=std, a=-2 * std, b=2 * std,
                              generator=generator)
        if layer.bias is not None:
            nn.init.zeros_(layer.bias)


def init_params(model: ActorCritic, generator: torch.Generator | None):
    """Draw fresh parameters as Flax initializes them: Dense kernels
    LeCun-normal (truncated at 2 sigma), biases zero, the mission table
    standard normal. Returns ``model``."""
    with torch.no_grad():
        _init_dense((model.img_in, model.trunk1, model.trunk2, model.policy,
                     model.value), generator)
        nn.init.normal_(model.mission_embed, generator=generator)
    return model


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``1 / (1 + exp(-x))`` in x's dtype, one rounding per operation: the
    form XLA gives ``jax.nn.sigmoid`` (in bf16 ``torch.sigmoid``, which
    rounds once, differs in the last bit for ~30% of the gates)."""
    return 1 / (1 + torch.exp(-x))


class ActorCriticRNN(nn.Module):
    """Recurrent actor-critic (JAX ``ActorCriticRNN``): the encoder front of
    :class:`ActorCritic`, one dense layer, and a GRU whose hidden state the
    caller carries: ``forward(obs, h) -> ((logits, value), h)``, with
    ``h = model.initial_state(B)`` at the start and zeroed per env at an
    episode's end (``models/ppo.py``).

    The GRU is JAX's canonical split: the input side (``gru_x``) holds the
    r, z, n biases, the hidden side (``gru_h``) none but the candidate's
    ``bhn`` inside ``r * (W_hn h + bhn)``; gates r, z, n; output ``(1-z) * n
    + z * h``. Every dense layer, the gates and the hidden state run in
    ``dtype``, the heads in float32, as Flax computes them (``nn.GRUCell``
    would fix one dtype and another bias layout). The cell is factored as
    JAX's is: :meth:`encode_inputs` holds every projection that does not
    read ``h`` (run once over a whole (T, B) slab in the update),
    :meth:`gru_step` the recurrence, :meth:`heads` the outputs."""

    is_recurrent = True

    def __init__(self, view_size: int = 7, hidden: int = 256,
                 mission_dim: int = 64, num_actions: int = NUM_ACTIONS,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        device = resolve_device(device)
        H = hidden
        self.hidden = hidden
        self.mission_dim = mission_dim
        self.num_actions = num_actions
        self.dtype = dtype
        img = view_size * view_size * CELL_FEATURES
        self.img_in = nn.Linear(img, H, device=device)
        self.mission_table = nn.Parameter(
            torch.empty(VOCAB_SIZE, mission_dim, device=device))
        self.trunk1 = nn.Linear(H + mission_dim + 4, H, device=device)
        self.gru_x = nn.Linear(H, 3 * H, device=device)
        self.gru_h = nn.Linear(H, 3 * H, bias=False, device=device)
        self.bhn = nn.Parameter(torch.zeros(H, device=device))
        self.policy = nn.Linear(H, num_actions, device=device)
        self.value = nn.Linear(H, 1, device=device)
        init_params_rnn(self, None)

    def encode_inputs(self, obs: dict) -> torch.Tensor:
        """Every projection that does not read ``h``: observations over any
        leading shape -> (..., 3H) GRU input pre-activations."""
        dt = self.dtype
        x = _trunk_input(obs, self.img_in, self.mission_table, dt)
        x = F.relu(_dense(self.trunk1, x, dt))
        return _dense(self.gru_x, x, dt)

    def gru_step(self, xz: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        """One recurrent step: (..., 3H) input pre-activations and (..., H)
        hidden -> the new hidden."""
        H, dt = self.hidden, self.dtype
        hz = _dense(self.gru_h, h, dt)
        r = _sigmoid(xz[..., :H] + hz[..., :H])
        z = _sigmoid(xz[..., H:2 * H] + hz[..., H:2 * H])
        bhn = _gathered(self.bhn, self.bhn.to(hz.dtype))
        n = torch.tanh(xz[..., 2 * H:] + r * (hz[..., 2 * H:] + bhn))
        return (1.0 - z) * n + z * h

    def heads(self, h: torch.Tensor):
        """Policy logits and value (float32) from (stacked) hidden states."""
        return (_dense(self.policy, h, torch.float32),
                _dense(self.value, h, torch.float32).squeeze(-1))

    def forward(self, obs: dict, h: torch.Tensor):
        h = self.gru_step(self.encode_inputs(obs), h)
        return self.heads(h), h

    def initial_state(self, batch: int) -> torch.Tensor:
        return torch.zeros((batch, self.hidden), dtype=self.dtype,
                           device=self.bhn.device)


def init_params_rnn(model: ActorCriticRNN,
                    generator: torch.Generator | None):
    """Fresh :class:`ActorCriticRNN` parameters as Flax initializes them:
    Dense kernels LeCun-normal (truncated at 2 sigma), biases and ``bhn``
    zero, the mission table standard normal. Returns ``model``."""
    with torch.no_grad():
        _init_dense((model.img_in, model.trunk1, model.gru_x, model.gru_h,
                     model.policy, model.value), generator)
        nn.init.normal_(model.mission_table, generator=generator)
        nn.init.zeros_(model.bhn)
    return model
