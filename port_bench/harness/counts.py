"""The work a cell asks for, counted from shapes: the policy's FLOPs and the
bytes the env step's contract moves.

The bytes follow the repository's kernel byte count (each input byte read
once, each output byte written once; ``chip_smoke.py::launch_bytes`` and
``observe_window_bytes``), counted once per env step whatever implements it:
the env's core state read and written, its action read, its observation,
reward and flags written, the broadcast reset row read once a step, and
for a state that is observed again after a reset select (the regen and
fresh modes, the hook path), the in-grid cells of its view window and its
scalars. A change that moves observation work between the kernel's two
entries, or drops the step entry's thrown-away observation, leaves these
counts as they are.
"""

from __future__ import annotations

# the port's state layout: grid (W, H, 5) uint8, agent_pos 2 x int32,
# agent_dir int32, carrying 5 x uint8, step_count int32; terminated and
# truncated one byte each; actions int32; a packed view cell int32
CELL_BYTES = 5
SCALAR_BYTES = 8 + 4 + 5 + 4
FLAG_BYTES = 2
ACTION_BYTES = 4
VIEW_CELL_BYTES = 4
REWARD_BYTES = 4
ROW_SCALARS = 8   # a reset row's int32 scalars (ops/fused_step.py NSCAL)
# what the observe entry reads besides the window: position, direction and
# the carried cell
OBSERVE_SCALAR_BYTES = 8 + 4 + 5


def policy_macs(view_size: int, hidden: int, mission_dim: int,
                vocab_size: int, num_actions: int,
                cell_features: int = 24) -> int:
    """Multiply-adds of one ``ActorCritic`` forward for one sample: the view
    features into the trunk, the mission table, the two trunk layers and
    the policy and value heads."""
    img = view_size * view_size * cell_features
    return (img * hidden + vocab_size * mission_dim
            + (hidden + mission_dim + 4) * hidden + hidden * hidden
            + hidden * num_actions + hidden)


def train_step_flops(policy: dict, num_envs: int, rollout_len: int,
                     num_epochs: int = 1) -> int:
    """FLOPs of one PPO train step: a forward per sample in the rollout and
    a forward and a backward (twice the forward) per sample in each epoch
    of the update; 2 FLOPs a multiply-add."""
    macs = policy_macs(policy["view_size"], policy["hidden"],
                       policy["mission_dim"], policy["vocab_size"],
                       policy["num_actions"])
    return (1 + 3 * num_epochs) * 2 * macs * num_envs * rollout_len


def core_state_bytes(width: int, height: int) -> int:
    return width * height * CELL_BYTES + SCALAR_BYTES


def env_step_bytes(width: int, height: int, view_size: int) -> int:
    """Bytes of one env step without the reset row or a second look: the
    core state read and written (with its two flags), the action, and the
    observation, reward and flags written."""
    core = core_state_bytes(width, height)
    return (2 * core + FLAG_BYTES + ACTION_BYTES
            + view_size * view_size * VIEW_CELL_BYTES + REWARD_BYTES
            + FLAG_BYTES)


def reset_row_bytes(width: int, height: int) -> int:
    """The broadcast reset row, read once a step: its packed cells and its
    scalars, int32 each."""
    return 4 * (width * height + ROW_SCALARS)


def window_cells(width: int, height: int, view_size: int, agent_pos,
                 agent_dir) -> int:
    """In-grid cells of the view windows of a batch of agents
    (``agent_pos`` (B, 2), ``agent_dir`` (B,) tensors): the window is V
    consecutive grid columns by V rows, placed by position and direction."""
    V = view_size
    d = agent_dir.long()
    pos = agent_pos.long()
    fx = (d == 0).long() - (d == 2).long()
    fy = (d == 1).long() - (d == 3).long()
    rx, ry = -fy, fx
    # view cell (vx, vy) is world (tlx + rx*vx - fx*vy, tly + ry*vx -
    # fy*vy): the window's first column and row
    x0 = (pos[:, 0] + fx * (V - 1) - rx * (V // 2)
          + (rx.clamp(max=0) + (-fx).clamp(max=0)) * (V - 1))
    y0 = (pos[:, 1] + fy * (V - 1) - ry * (V // 2)
          + (ry.clamp(max=0) + (-fy).clamp(max=0)) * (V - 1))
    nx = ((x0 + V).clamp(max=width) - x0.clamp(min=0)).clamp(min=0)
    ny = ((y0 + V).clamp(max=height) - y0.clamp(min=0)).clamp(min=0)
    return int((nx * ny).sum())


def observe_read_bytes(width: int, height: int, view_size: int, agent_pos,
                       agent_dir) -> int:
    """What a second look at a batch of states reads: the in-grid cells of
    each window and each env's position, direction and carried cell (the
    view it writes is counted once, in :func:`env_step_bytes`)."""
    B = agent_dir.shape[0]
    return (CELL_BYTES * window_cells(width, height, view_size, agent_pos,
                                      agent_dir)
            + B * OBSERVE_SCALAR_BYTES)
