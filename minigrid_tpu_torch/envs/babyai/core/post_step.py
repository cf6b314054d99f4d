"""The post-step of a BabyAI level: the CUDA kernel and its plain PyTorch
version.

A BabyAI level steps on the hook path: the fused step, then its
``_post_step`` (``envs/babyai/core/level.py::RoomGridLevel._post_step``),
which runs the instruction verifier against the previous state
(``envs/babyai/core/instrs.py::verify``), pays the success reward
``1 - 0.9 * step_count / max_steps``, no reward on failure, ends the episode
when the verifier says so and truncates it at the dynamic budget
``extra["max_steps"]``. Eager PyTorch spreads that over ~366 launches a step
on the card; ``csrc/babyai_post_step.cu`` computes all of it in one, for
every level: the tree's shape, the mask height and the done-actions mode are
arguments. The JAX package has no kernel here: its verifier is ``jnp`` under
``jit``, which XLA fuses.

Routing is by the device of the tensors, as ``fused_step.fused_rollout``
routes: CPU tensors take :func:`babyai_post_step_reference` (the verifier
and the reward arithmetic in PyTorch), CUDA tensors the kernel or raise;
nothing falls back. The kernel is :data:`LIBRARY`, built, loaded, checked,
called and counted (``kernel.verify_launches``) through ``ops/native.py``.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.envs.babyai.core import instrs as I
from minigrid_tpu_torch.ops import native

SOURCE = native.CSRC / "babyai_post_step.cu"
# the entry's (device pointers, ints): csrc/babyai_post_step.cu kPointers
LIBRARY = native.Library(SOURCE, {"babyai_post_step_launch": (33, 4)})

# the ``extra`` entries of the InstrState fields a step writes, in the
# order of the kernel's outputs; the others pass through
UPDATED = tuple(I.PREFIX + k for k in (
    "descs.mask_objs", "descs.mask_poss", "descs.carried", "pre_empty",
    "pre_move_carried", "last_match", "leaf_done", "a_done", "b_done"))
# the ``extra`` entries the kernel reads, in its pointer table's order
# (csrc/babyai_post_step.cu ``VerifyArgs``), after the two states' fields and
# the action
EXTRA_READ = tuple(I.PREFIX + k for k in (
    "root_kind", "a_is_and", "b_is_and", "kinds", "strict",
    "descs.mask_objs", "descs.mask_poss", "descs.carried", "pre_empty",
    "pre_move_carried", "last_match", "leaf_done", "a_done",
    "b_done")) + ("max_steps",)


def babyai_post_step_reference(params, prev, new, action, reward, terminated,
                               use_done_actions: bool):
    """The level's step after the core transition ``prev`` -> ``new`` (the
    JAX package's ``step_state``, level.py:279-299), in plain PyTorch.
    ``reward`` and ``terminated`` (B,) are the core step's. Returns (status
    (B,) int32, the new InstrState's ``extra`` entries, reward, terminated,
    truncated)."""
    status, instr = I.verify(params, I.InstrState.from_extra(prev.extra),
                             prev, new, action, use_done_actions)
    dyn_max = prev.extra["max_steps"]
    success_reward = 1.0 - 0.9 * new.step_count.to(torch.float32) \
        / dyn_max.to(torch.float32)
    reward = torch.where(status == I.SUCCESS, success_reward,
                         torch.where(status == I.FAILURE, 0.0, reward))
    terminated = terminated | (status != I.CONTINUE)
    return (status, instr.to_extra(), reward, terminated,
            new.step_count >= dyn_max)


def _inputs(prev, new, action, reward, terminated) -> list:
    """The tensors the kernel reads, in its pointer table's order."""
    return [prev.agent_pos, prev.agent_dir, prev.carrying, prev.grid,
            new.agent_pos, new.agent_dir, new.carrying, new.grid,
            new.step_count, action, *map(prev.extra.__getitem__, EXTRA_READ),
            reward, terminated]


def _specs(B: int, W: int, H: int) -> list:
    """(name, dtype, shape) of each of :func:`_inputs`; raises
    ``ValueError`` for a width the kernel's packed masks do not take."""
    if W > I.MAX_PACKED_WIDTH:
        raise ValueError(f"the kernel takes packed widths up to "
                         f"{I.MAX_PACKED_WIDTH}, got {W}")
    i32, u8, b8, f32 = torch.int32, torch.uint8, torch.bool, torch.float32
    state = [("agent_pos", i32, (B, 2)), ("agent_dir", i32, (B,)),
             ("carrying", u8, (B, 5)), ("grid", u8, (B, W, H, 5))]
    instr = [(i32, (B,)), (b8, (B,)), (b8, (B,)), (i32, (B, 4)),
             (b8, (B, 4)), (i32, (B, 8, H)), (i32, (B, 8, H)), (b8, (B, 8)),
             (b8, (B, 4)), (b8, (B, 4)), (b8, (B, 4)), (b8, (B, 4)),
             (b8, (B,)), (b8, (B,)), (i32, (B,))]
    return ([("prev." + n, d, s) for n, d, s in state]
            + [("new." + n, d, s) for n, d, s in state]
            + [("new.step_count", i32, (B,)), ("action", i32, (B,))]
            + [(k,) + spec for k, spec in zip(EXTRA_READ, instr)]
            + [("reward", f32, (B,)), ("terminated", b8, (B,))])


# The outputs of the kernel's calls are allocated in chunks, for up to
# CHUNK_CALLS calls and CHUNK_BYTES of device memory at once: on an H100's
# host an allocation costs 3-7 us, a view 1-2 us, and a call needs 13 new
# tensors (PERF.md, the post-step kernel's host cost). Each call takes the
# next call's part of the chunk: memory no other call writes, so a step
# never writes the tensors of a state it was given. A chunk is freed when
# the last of its calls' outputs is: a state kept keeps at most CHUNK_BYTES.
CHUNK_CALLS, CHUNK_BYTES = 16, 64 << 20


class _Outputs:
    """The unused parts of the last chunk, for one (B, H, device, stream):
    each a call's outputs, as views in ``VerifyArgs``' order (the two mask
    arrays, contiguous; status; reward; carried; the four memory fields and
    the four end flags, each group contiguous)."""

    key, left = None, []

    @classmethod
    def take(cls, B: int, H: int, dev, stream: int) -> tuple:
        key = (B, H, dev, stream)
        if key != cls.key or not cls.left:
            cls.key, cls.left = key, _chunk(B, H, dev)
        return cls.left.pop()


def _chunk(B: int, H: int, dev) -> list:
    call_bytes = B * (4 * 2 * 8 * H + 4 + 4 + 28)
    K = max(1, min(CHUNK_CALLS, CHUNK_BYTES // call_bytes))
    i32, b8 = torch.int32, torch.bool
    masks = torch.empty((2 * K, B, 8, H), dtype=i32, device=dev).unbind(0)
    status = torch.empty((K, B), dtype=i32, device=dev).unbind(0)
    reward = torch.empty((K, B), dtype=torch.float32, device=dev).unbind(0)
    carried = torch.empty((K, B, 8), dtype=b8, device=dev).unbind(0)
    memory = torch.empty((4 * K, B, 4), dtype=b8, device=dev).unbind(0)
    ends = torch.empty((4 * K, B), dtype=b8, device=dev).unbind(0)
    return [(masks[2 * k:2 * k + 2], status[k], reward[k], carried[k],
             memory[4 * k:4 * k + 4], ends[4 * k:4 * k + 4])
            for k in reversed(range(K))]


def _babyai_post_step_cuda(params, prev, new, action, reward, terminated,
                           use_done_actions: bool):
    B, W, H = new.batch_size, params.width, params.height
    dev = new.grid.device
    tensors = _inputs(prev, new, action, reward, terminated)
    native.check(tensors, _specs(B, W, H))
    stream = native.stream(dev)
    masks, status, new_reward, carried, memory, ends = _Outputs.take(
        B, H, dev, stream)
    LIBRARY.call("babyai_post_step_launch", tensors + [
        masks[0], status, new_reward, carried, memory[0], ends[0]],
        (B, W, H, int(use_done_actions)), stream)
    native.COUNTERS.verify_launches += 1
    updates = dict(zip(UPDATED, (*masks, carried, *memory, *ends[:2])))
    return status, updates, new_reward, ends[2], ends[3]


def babyai_post_step(params, prev, new, action, reward, terminated,
                     use_done_actions: bool):
    """A BabyAI level's step after the core transition ``prev`` -> ``new``:
    (status (B,) int32, the ``extra`` entries of the InstrState it wrote,
    reward (B,) float32, terminated, truncated (B,) bool). CPU tensors run
    :func:`babyai_post_step_reference`, CUDA tensors the kernel, which
    writes new tensors and leaves its inputs as they are. ``action`` (B,)
    int32, ``reward`` and ``terminated`` the core step's."""
    dev = new.grid.device.type
    if dev == "cpu":
        return babyai_post_step_reference(params, prev, new, action, reward,
                                          terminated, use_done_actions)
    if dev != "cuda":
        raise ValueError(f"babyai_post_step runs on cpu or cuda, got {dev}")
    return _babyai_post_step_cuda(params, prev, new, action, reward,
                                  terminated, use_done_actions)
