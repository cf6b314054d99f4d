"""Behavioural cloning from the BabyAI bot's demonstrations.

Counterpart of ``minigrid_tpu/models/bc.py``: a
:class:`~minigrid_tpu_torch.utils.demos.DemoBatch` from
``utils/demos.generate_demos`` fits the policy logits of an actor-critic with
masked cross-entropy and Adam (optax's defaults); the value head gets no
gradient. The samples are shuffled once and cut into minibatches;
:func:`bc_epoch` runs one pass over pre-cut minibatches.

    from minigrid_tpu_torch.utils.demos import generate_demos
    from minigrid_tpu_torch.models.bc import behavior_clone
    demos = generate_demos(env, num_episodes=100)
    history = behavior_clone(model, demos)    # model updated in place
"""

from __future__ import annotations

import numpy as np
import torch

OBS_KEYS = ("image", "direction", "mission")


def flatten_demos(demos) -> dict:
    """DemoBatch (N episodes, padded to T) -> flat sample arrays
    {image, direction, mission, action} of the M valid timesteps, in
    ``np.nonzero`` order of the mask."""
    mask = np.asarray(demos.mask)
    idx_n, idx_t = np.nonzero(mask)
    return {
        "image": np.asarray(demos.image)[idx_n, idx_t],
        "direction": np.asarray(demos.direction)[idx_n, idx_t],
        "mission": np.asarray(demos.mission)[idx_n],
        "action": np.asarray(demos.action)[idx_n, idx_t],
    }


def bc_minibatches(flat: dict, perm, batch_size: int, device) -> dict:
    """The flat samples in the order of ``perm`` (its first ``n *
    batch_size`` entries) as (n, batch_size, ...) tensors on ``device``."""
    perm = np.asarray(perm)
    n = len(perm) // batch_size
    keep = perm[:n * batch_size]
    return {k: torch.from_numpy(np.ascontiguousarray(v[keep])).to(
        device).reshape(n, batch_size, *v.shape[1:])
        for k, v in flat.items()}


def bc_loss(model, batch: dict):
    """(masked cross-entropy of the demo actions under the policy logits,
    imitation accuracy) of one minibatch."""
    logits, _ = model({k: batch[k] for k in OBS_KEYS})
    logp = torch.log_softmax(logits, -1)
    action = batch["action"].to(torch.int64)
    ce = -torch.gather(logp, -1, action[:, None]).squeeze(-1).mean()
    acc = (torch.argmax(logits, -1) == action).to(torch.float32).mean()
    return ce, acc


def bc_epoch(model, optimizer, batches: dict):
    """One pass over pre-cut minibatches (:func:`bc_minibatches`), one Adam
    step each. Returns the epoch's mean loss and accuracy as device
    scalars."""
    ces, accs = [], []
    for i in range(batches["action"].shape[0]):
        optimizer.zero_grad(set_to_none=True)
        ce, acc = bc_loss(model, {k: v[i] for k, v in batches.items()})
        ce.backward()
        optimizer.step()
        ces.append(ce.detach())
        accs.append(acc)
    return torch.stack(ces).mean(), torch.stack(accs).mean()


def behavior_clone(model, demos, epochs: int = 10, batch_size: int = 256,
                   lr: float = 1e-3,
                   generator: torch.Generator | None = None) -> list:
    """Fit ``model``'s policy logits to the demo actions, updating it in
    place. The samples are shuffled once by ``torch.randperm`` on
    ``generator`` (seed 0 by default) and cut into ``M // batch_size``
    minibatches (one short batch when M < batch_size). Returns the history:
    per epoch, the mean cross-entropy ``loss`` and the imitation
    ``accuracy``."""
    if getattr(model, "is_recurrent", False):
        raise ValueError(
            "behaviour cloning fits a policy without a hidden state: a "
            "recurrent model would need its hidden state threaded through "
            "each episode")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    flat = flatten_demos(demos)
    M = flat["action"].shape[0]
    batch_size = min(batch_size, M)
    perm = torch.randperm(M, generator=generator,
                          device=generator.device).cpu().numpy()
    device = next(model.parameters()).device
    batches = bc_minibatches(flat, perm, batch_size, device)
    optimizer = torch.optim.Adam(model.parameters(), lr=lr,
                                 betas=(0.9, 0.999), eps=1e-8)
    history = []
    for _ in range(epochs):
        ce, acc = bc_epoch(model, optimizer, batches)
        history.append({"loss": float(ce), "accuracy": float(acc)})
    return history
