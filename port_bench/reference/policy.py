"""Plain reference of the learner a train cell runs: the actor-critic's
forward, GAE, the clipped-surrogate PPO loss, the global clip-norm and Adam,
written from the published descriptions (CleanRL's ``ppo.py`` loss and GAE;
optax's ``clip_by_global_norm``; Kingma and Ba's Adam as ``torch.optim.Adam``
states it) and the configuration's widths. It imports nothing of the
program.

The configuration states the precision: float32 master weights, the view
encoder, mission table and trunk computed in bfloat16, the heads in float32.
``quant="fp8"`` computes the bfloat16 products from float8 (e4m3) copies of
their inputs and weights, each scaled to its own range: the control, one
precision below the stated one.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
FP8_MAX = 448.0


def param_shapes(p: dict) -> dict:
    """Parameter name -> shape, in the policy's order (its state dict's)."""
    H, M, A = p["hidden"], p["mission_dim"], p["num_actions"]
    cells = p["view_size"] ** 2 * (p["type_planes"] + p["color_planes"]
                                   + p["state_planes"])
    return {"img_in.weight": (H, cells), "img_in.bias": (H,),
            "mission_embed": (p["vocab_size"], M),
            "trunk1.weight": (H, H + M + 4), "trunk1.bias": (H,),
            "trunk2.weight": (H, H), "trunk2.bias": (H,),
            "policy.weight": (A, H), "policy.bias": (A,),
            "value.weight": (1, H), "value.bias": (1,)}


def init_weights(p: dict, generator: torch.Generator, device) -> dict:
    """Fresh weights on ``device`` in the master precision, in two draws from
    ``generator``: every dense kernel LeCun-normal truncated at two sigma
    (as Flax initialises ``nn.Dense``), biases zero, the mission table
    standard normal."""
    if p["class"] != "ActorCritic":
        raise ValueError(f"policy {p['class']!r}: the reference implements "
                         "ActorCritic")
    if p["master_dtype"] != "float32":
        raise ValueError(f"master_dtype {p['master_dtype']!r}: the "
                         "reference implements float32")
    shapes = param_shapes(p)
    kernels = [k for k in shapes if k.endswith(".weight")]
    sizes = [math.prod(shapes[k]) for k in kernels]
    flat = torch.empty(sum(sizes), device=device)
    torch.nn.init.trunc_normal_(flat, a=-2.0, b=2.0, generator=generator)
    table = torch.empty(shapes["mission_embed"], device=device)
    torch.nn.init.normal_(table, generator=generator)
    out = {}
    for k, part in zip(kernels, flat.split(sizes)):
        fan_in = shapes[k][1]
        out[k] = part.reshape(shapes[k]) * (
            math.sqrt(1.0 / fan_in) / .87962566103423978)
    for k, shape in shapes.items():
        if k == "mission_embed":
            out[k] = table
        elif k not in out:
            out[k] = torch.zeros(shape, device=device)
    return {k: out[k] for k in shapes}


def encode(packed, mission, direction, p: dict) -> dict:
    """The policy's input from (N, V, V) packed view cells, (N, L) mission
    tokens and (N,) directions: one-hot type, colour and state planes per
    cell (cell after cell), the count of each vocabulary token, and the
    direction."""
    dev = packed.device
    planes = torch.cat([
        (packed & 15)[..., None] == torch.arange(p["type_planes"], device=dev),
        ((packed >> 4) & 7)[..., None] == torch.arange(p["color_planes"],
                                                        device=dev),
        ((packed >> 7) & 3)[..., None] == torch.arange(p["state_planes"],
                                                        device=dev)], -1)
    img = planes.reshape(packed.shape[0], -1).to(torch.uint8)
    vocab = torch.arange(p["vocab_size"], device=dev)
    counts = (mission.long()[..., None] == vocab).sum(-2).to(torch.uint8)
    return {"img_feat": img, "mission_counts": counts,
            "direction": direction}


def _q(t, quant):
    """``t`` as the product's operand: itself, or its value through float8
    e4m3 at its own scale (the gradient passes straight through, as the
    backward of a float8 forward runs at the wider precision)."""
    if quant != "fp8":
        return t
    x = t.detach()
    scale = FP8_MAX / x.abs().amax().float().clamp(min=1e-30)
    q = ((x.float() * scale).to(torch.float8_e4m3fn).float()
         / scale).to(t.dtype)
    return t + (q - x)


def _linear(x, w, b, dt, quant=None):
    return F.linear(_q(x.to(dt), quant), _q(w.to(dt), quant), b.to(dt))


def forward(w: dict, enc: dict, p: dict, quant=None):
    """(logits (N, A) float32, value (N,) float32)."""
    dt = DTYPES[p["trunk_dtype"]]
    hd = DTYPES[p["head_dtype"]]
    x = F.relu(_linear(enc["img_feat"], w["img_in.weight"],
                       w["img_in.bias"], dt, quant))
    counts = enc["mission_counts"].to(dt)
    counts = counts * (torch.arange(counts.shape[-1],
                                    device=counts.device) != 0)
    n = counts.sum(-1, keepdim=True)
    pooled = (_q(counts, quant) @ _q(w["mission_embed"].to(dt), quant)
              / n.clamp(min=1))
    d = F.one_hot(enc["direction"].long(), 4).to(dt)
    h = torch.cat([x, pooled, d], -1)
    h = F.relu(_linear(h, w["trunk1.weight"], w["trunk1.bias"], dt, quant))
    h = F.relu(_linear(h, w["trunk2.weight"], w["trunk2.bias"], dt, quant))
    logits = F.linear(h.to(hd), w["policy.weight"].to(hd),
                      w["policy.bias"].to(hd))
    value = F.linear(h.to(hd), w["value.weight"].to(hd),
                     w["value.bias"].to(hd))
    return logits.float(), value.float().squeeze(-1)


def gae(reward, value, done, last_value, gamma, lam):
    """Advantages and returns over (T, B), backwards from ``last_value``."""
    adv = torch.zeros_like(value)
    running = torch.zeros_like(last_value)
    next_value = last_value
    for t in reversed(range(value.shape[0])):
        live = 1.0 - done[t].float()
        delta = reward[t] + gamma * next_value * live - value[t]
        running = delta + gamma * lam * live * running
        adv[t] = running
        next_value = value[t]
    return adv, adv + value


def ppo_loss(w: dict, mb: dict, p: dict, c: dict, quant=None):
    """(total, its terms) of one minibatch: the clipped surrogate on the
    minibatch-normalised advantage, half the squared value error, and the
    entropy bonus."""
    logits, value = forward(w, mb, p, quant)
    logp = torch.log_softmax(logits, -1)
    lp = logp.gather(-1, mb["action"].long()[:, None]).squeeze(-1)
    ratio = torch.exp(lp - mb["log_prob"])
    adv = mb["adv"]
    adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    eps = c["clip_eps"]
    pg = -torch.minimum(ratio * adv,
                        torch.clamp(ratio, 1 - eps, 1 + eps) * adv).mean()
    v = 0.5 * torch.square(value - mb["ret"]).mean()
    ent = -(torch.exp(logp) * logp).sum(-1).mean()
    total = pg + c["vf_coef"] * v - c["ent_coef"] * ent
    return total, (pg, v, ent)


class Adam:
    """Adam as ``torch.optim.Adam`` (no weight decay, no amsgrad) over a
    dict of float32 tensors."""

    def __init__(self, w: dict, lr, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = {k: torch.zeros_like(v) for k, v in w.items()}
        self.v = {k: torch.zeros_like(v) for k, v in w.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, w: dict, grads: dict):
        self.t += 1
        c1 = 1 - self.b1 ** self.t
        c2 = math.sqrt(1 - self.b2 ** self.t)
        for k in w:
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (self.v[k].sqrt() / c2).add_(self.eps)
            w[k].addcdiv_(self.m[k], denom, value=-self.lr / c1)


def clip_global_norm(grads: dict, max_norm: float) -> dict:
    """optax's ``clip_by_global_norm``: the gradients scaled by ``max_norm
    / norm`` where their global norm is at least ``max_norm``."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    if norm < max_norm:
        return grads
    return {k: g / norm * max_norm for k, g in grads.items()}
