"""The rollout's policy step, and its replay as one CUDA graph on the card.

A step of the policy (:func:`act`) is the observation's parameter-free
encoding (``encode_obs``), the forward, the Gumbel-argmax action and its
log-probability: some 45 small launches, whose host dispatch costs far more
than their device time. On the card ``models/ppo.py::rollout`` runs the
step of a feed-forward policy on the standard observation dict as the
replay of one captured CUDA graph (:class:`GraphedPolicy`): per step the
host copies the step's inputs into the graph's static buffers and replays
it; the graph reads the step's row of the rollout's Gumbel noise at a
device step index, writes the encoding, action, log-probability and value
into (T, B, ...) trajectory buffers at that index and advances it. The
graph holds the very ops of :func:`act`, in their order and dtypes, so it
gives the eager step's results bit for bit.

:func:`graphed_policy` decides from what it observes: the graph runs where
the noise is on a CUDA device, the observation is the standard dict, the
model is an ``nn.Module`` that is neither recurrent nor ``takes_raw_obs``
and no parameter is split over tensor-parallel ranks (their forwards run
collectives); everything else (the CPU, recurrent policies, raw-observation
models, tensor-parallel shards) steps eagerly through :func:`act`.

One graph is kept per model, weakly (a dropped model frees its graph and
its memory pool), and captured again when the batch, T, the number of
actions, the inputs' shapes, dtypes or keys, the device or the parameters'
storage change (a ``load_state_dict`` that reallocates, a new batch).
Optimizers that update the parameters in place (``torch.optim.Adam``) need
no capture: each replay casts the current weights. The model's forward runs
in Python only while the graph is warmed up and captured, so its forward
hooks run then and not at each replay.

:data:`POLICY` counts captures, replays and eager steps
(``trace.counters()``'s ``policy.*``).
"""

from __future__ import annotations

import dataclasses
import weakref

import torch
from torch import nn

from minigrid_tpu_torch.models.actor_critic import encode_obs

GRAPH_WARMUP = 3  # eager steps on a side stream before the capture


@dataclasses.dataclass
class PolicyCounters:
    """How the rollout's policy steps ran: ``graph_captures``,
    ``graph_replays`` (one a graphed step) and ``eager_steps`` (plain ints
    that only the policy step adds to)."""

    graph_captures: int = 0
    graph_replays: int = 0
    eager_steps: int = 0


POLICY = PolicyCounters()


def selected_log_prob(log_probs, action):
    """log_probs[..., action]."""
    return torch.gather(log_probs, -1,
                        action[..., None].to(torch.int64)).squeeze(-1)


def act(model, obs, gumbel: torch.Tensor, encode: bool = True,
        h: torch.Tensor | None = None):
    """One policy step on ``obs`` (encoded first where ``encode``) with the
    step's Gumbel noise: ``(enc, action, log_prob, value, h)``, ``h`` the
    recurrent model's next hidden state (None for a feed-forward one)."""
    enc = encode_obs(obs) if encode else obs
    if h is None:
        logits, value = model(enc)
    else:
        (logits, value), h = model(enc, h)
    action = torch.argmax(logits + gumbel, dim=-1)
    log_prob = selected_log_prob(torch.log_softmax(logits, -1), action)
    return enc, action, log_prob, value, h


class GraphedPolicy:
    """:func:`act` of one model, captured as a CUDA graph over a rollout of
    T steps: :meth:`begin` at each rollout, :meth:`step` at each step,
    :meth:`trajectory` at the end."""

    def __init__(self, model: nn.Module, inputs: dict, gumbel: torch.Tensor,
                 key: tuple):
        self.key = key
        dev = gumbel.device
        T = gumbel.shape[0]
        self.inputs = {k: torch.empty_like(v) for k, v in inputs.items()}
        self.gumbel = torch.empty_like(gumbel)
        self.index = torch.zeros((), dtype=torch.int64, device=dev)
        self.t = 0
        for k, v in inputs.items():
            self.inputs[k].copy_(v)
        self.gumbel.copy_(gumbel)
        # one eager step gives the outputs' shapes and dtypes
        enc, action, log_prob, value, _ = act(model, self.inputs, gumbel[0])
        self.enc = {k: torch.empty((T, *v.shape), dtype=v.dtype, device=dev)
                    for k, v in enc.items()}
        self.action, self.log_prob, self.value = (
            torch.empty((T, *x.shape), dtype=x.dtype, device=dev)
            for x in (action, log_prob, value))

        def graphed_step():
            enc, action, log_prob, value, _ = act(
                model, self.inputs, self.gumbel.index_select(0, self.index)[0])
            outs = [(self.enc[k], v) for k, v in enc.items()]
            outs += [(self.action, action), (self.log_prob, log_prob),
                     (self.value, value)]
            for buf, x in outs:
                buf.index_copy_(0, self.index, x[None])
            self.index.add_(1)

        with torch.cuda.device(dev):
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for _ in range(GRAPH_WARMUP):
                    self.index.zero_()
                    graphed_step()
            torch.cuda.current_stream(dev).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                graphed_step()
        POLICY.graph_captures += 1

    def begin(self, gumbel: torch.Tensor) -> None:
        """Start a rollout: its noise into the graph's buffer, step 0."""
        self.gumbel.copy_(gumbel)
        self.index.zero_()
        self.t = 0

    def step(self, inputs: dict) -> torch.Tensor:
        """One replay on ``inputs`` (the dict :func:`act` encodes); returns
        the step's actions (B,) int64, a row of the trajectory's buffer."""
        for k, v in inputs.items():
            self.inputs[k].copy_(v)
        self.graph.replay()
        POLICY.graph_replays += 1
        self.t += 1
        return self.action[self.t - 1]

    def trajectory(self):
        """The rollout's (T, B, ...) ``(enc, action int32, log_prob,
        value)``, each a copy that owns its memory."""
        return ({k: v.clone() for k, v in self.enc.items()},
                self.action.to(torch.int32), self.log_prob.clone(),
                self.value.clone())


_GRAPHS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def graphed_policy(model, inputs: dict,
                   gumbel: torch.Tensor) -> GraphedPolicy | None:
    """The graph of ``model``'s step for a rollout with this noise (T, B, A)
    and these first-step ``inputs`` (the standard observation dict that
    :func:`act` encodes), captured where there is none for these keys, and
    begun; or None where the step runs eagerly (see the module
    docstring)."""
    dev = gumbel.device
    if (dev.type != "cuda" or not isinstance(model, nn.Module)
            or getattr(model, "is_recurrent", False)
            or getattr(model, "takes_raw_obs", False)):
        return None
    params = list(model.parameters())
    if any(hasattr(p, "tensor_parallel") or p.device != dev for p in params):
        return None
    if any(v.device != dev for v in inputs.values()):
        return None
    key = (tuple(gumbel.shape),
           tuple((k, tuple(v.shape), v.dtype) for k, v in inputs.items()),
           dev, tuple((p.data_ptr(), p.dtype) for p in params))
    graph = _GRAPHS.get(model)
    if graph is None or graph.key != key:
        del graph  # the old graph and its pool go before the new capture
        _GRAPHS.pop(model, None)
        graph = _GRAPHS[model] = GraphedPolicy(model, inputs, gumbel, key)
    graph.begin(gumbel)
    return graph
