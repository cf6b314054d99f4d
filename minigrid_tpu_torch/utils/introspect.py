"""Host-side state introspection helpers, on one env of a batch.

Counterpart of ``minigrid_tpu/utils/introspect.py`` and of the reference's
debugging/inspection API: ``pprint_grid`` (minigrid_env.py:175-234),
``get_view_coords``/``relative_coords``/``in_view``/``agent_sees``
(minigrid_env.py:426-523). Each function reads env ``b`` of a batched
:class:`~minigrid_tpu_torch.core.types.EnvState`.
"""

from __future__ import annotations

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.ops.fused_step import fused_observe

OBJECT_TO_STR = {
    "wall": "W", "floor": "F", "door": "D", "key": "K", "ball": "A",
    "box": "B", "goal": "G", "lava": "V",
}
AGENT_DIR_TO_STR = {0: ">", 1: "V", 2: "<", 3: "^"}


def _pose(state, b: int):
    ax, ay = (int(x) for x in state.agent_pos[b].tolist())
    return ax, ay, int(state.agent_dir[b])


def pprint_grid(state, b: int = 0) -> str:
    """Two-chars-per-cell ASCII dump, identical format to the reference."""
    grid = state.grid[b].cpu().numpy()
    ax, ay, agent_dir = _pose(state, b)
    W, H = grid.shape[:2]
    out = []
    for j in range(H):
        row = ""
        for i in range(W):
            if i == ax and j == ay:
                row += 2 * AGENT_DIR_TO_STR[agent_dir]
                continue
            t, color, st = grid[i, j, 0], grid[i, j, 1], grid[i, j, 2]
            tname = C.IDX_TO_OBJECT[int(t)]
            if tname == "empty":
                row += "  "
                continue
            if tname == "door":
                if st == C.OPEN:
                    row += "__"
                elif st == C.LOCKED:
                    row += "L" + C.IDX_TO_COLOR[int(color)][0].upper()
                else:
                    row += "D" + C.IDX_TO_COLOR[int(color)][0].upper()
                continue
            row += OBJECT_TO_STR[tname] + C.IDX_TO_COLOR[int(color)][0].upper()
        out.append(row)
    return "\n".join(out)


def get_view_coords(params, state, i: int, j: int, b: int = 0):
    """World (i, j) -> agent-view coordinates (may be out of view)."""
    ax, ay, agent_dir = _pose(state, b)
    d = C.DIR_TO_VEC[agent_dir]
    dx, dy = int(d[0]), int(d[1])
    rx, ry = -dy, dx
    sz = params.view_size
    hs = sz // 2
    tx = ax + dx * (sz - 1) - rx * hs
    ty = ay + dy * (sz - 1) - ry * hs
    lx, ly = i - tx, j - ty
    vx = rx * lx + ry * ly
    vy = -(dx * lx + dy * ly)
    return vx, vy


def relative_coords(params, state, x: int, y: int, b: int = 0):
    vx, vy = get_view_coords(params, state, x, y, b)
    if vx < 0 or vy < 0 or vx >= params.view_size or vy >= params.view_size:
        return None
    return vx, vy


def in_view(params, state, x: int, y: int, b: int = 0) -> bool:
    return relative_coords(params, state, x, y, b) is not None


def agent_sees(params, state, x: int, y: int, b: int = 0) -> bool:
    """Whether a non-empty world cell is visible to the agent right now
    (minigrid_env.py:505-523); the view is the observe entry's (the kernel
    on the card) of env ``b`` alone."""
    coords = relative_coords(params, state, x, y, b)
    if coords is None:
        return False
    vx, vy = coords
    packed = fused_observe(params, state.map(lambda t: t[b:b + 1]))
    obs_cell = int(packed[0, vx, vy]) & 15  # the type bits
    world_cell = int(state.grid[b, x, y, 0])
    assert world_cell != C.EMPTY
    return obs_cell != C.UNSEEN and obs_cell == world_cell
