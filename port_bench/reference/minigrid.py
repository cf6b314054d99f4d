"""Plain reference of the gridworld a cell runs, written from upstream
Minigrid (``minigrid/minigrid_env.py`` ``step``, ``gen_obs_grid``,
``get_view_exts``; ``minigrid/core/grid.py`` ``slice``, ``rotate_left``,
``process_vis``, ``encode``; ``minigrid/core/world_object.py``).

It imports nothing of the program. Its only contact with the program is the
data it judges: a state is a dict of batch-leading tensors (``grid`` (B, W,
H, 5) uint8 cells of type, colour, state, contained type and contained
colour; ``agent_pos`` (B, 2); ``agent_dir`` (B,); ``carrying`` (B, 5), an
empty cell when nothing is carried; ``step_count`` (B,); ``mission`` (B,
L) token ids), and a reset row is a packed grid and its scalars. Every
function runs on any device, batched, with loops over the view's cells where
upstream loops.
"""

from __future__ import annotations

import torch

UNSEEN, EMPTY, WALL, FLOOR, DOOR, KEY, BALL, BOX, GOAL, LAVA = range(10)
OPEN, CLOSED, LOCKED = 0, 1, 2
RED, GREEN, BLUE, PURPLE, YELLOW, GREY = range(6)
LEFT, RIGHT, FORWARD, PICKUP, DROP, TOGGLE, DONE = range(7)
EMPTY_CELL = (EMPTY, 0, 0, 0, 0)
WALL_CELL = (WALL, GREY, 0, 0, 0)
CORE = ("grid", "agent_pos", "agent_dir", "carrying", "step_count")


def _cells(values, like):
    return torch.tensor(values, dtype=torch.uint8, device=like.device)


def front(state):
    """(B, 2) cell in front of each agent (DIR_TO_VEC)."""
    d = state["agent_dir"].long()
    dx = (d == 0).long() - (d == 2).long()
    dy = (d == 1).long() - (d == 3).long()
    return state["agent_pos"].long() + torch.stack([dx, dy], -1)


def get_cells(grid, x, y):
    """Cells (..., 5) at (x, y) of each env's grid; a grey wall outside."""
    B, W, H, _ = grid.shape
    inside = (x >= 0) & (x < W) & (y >= 0) & (y < H)
    b = torch.arange(B, device=grid.device).reshape(
        (B,) + (1,) * (x.ndim - 1)).expand_as(x)
    cells = grid[b, x.clamp(0, W - 1), y.clamp(0, H - 1)]
    return torch.where(inside[..., None], cells, _cells(WALL_CELL, grid))


def reward_f32(step_count, max_steps: int, dtype=torch.float32,
               ratio_first: bool = True):
    """``1 - 0.9 * (step_count / max_steps)`` (``_reward``), each operation
    rounded to ``dtype``; ``ratio_first=False`` takes ``1 - (0.9 *
    step_count) / max_steps``, the order BabyAI's levels round in."""
    sc = step_count.to(dtype)
    ms = torch.full_like(sc, max_steps)
    if ratio_first:
        return (1 - 0.9 * (sc / ms)).to(dtype)
    return (1 - 0.9 * sc / ms).to(dtype)


def step(state, action, max_steps: int, reward_dtype=torch.float32):
    """One ``MiniGridEnv.step`` of every env: (new state, reward f32,
    terminated, truncated). ``reward_dtype`` computes the reward at another
    precision (the control)."""
    a = action.long()
    grid = state["grid"].clone()
    pos = state["agent_pos"].long()
    d = state["agent_dir"].long()
    carrying = state["carrying"]
    steps = state["step_count"] + 1
    fpos = front(state)
    cell = get_cells(grid, fpos[:, 0], fpos[:, 1])
    typ, color, st = cell[:, 0], cell[:, 1], cell[:, 2]
    empty_front = typ == EMPTY
    carries = carrying[:, 0] != EMPTY

    new_dir = torch.where(a == LEFT, (d + 3) % 4,
                          torch.where(a == RIGHT, (d + 1) % 4, d))
    can_overlap = (empty_front | (typ == FLOOR) | (typ == GOAL)
                   | (typ == LAVA) | ((typ == DOOR) & (st == OPEN)))
    fwd = a == FORWARD
    new_pos = torch.where((fwd & can_overlap)[:, None], fpos, pos)
    at_goal = fwd & (typ == GOAL)
    terminated = at_goal | (fwd & (typ == LAVA))
    reward = torch.where(at_goal, reward_f32(steps, max_steps, reward_dtype)
                         .to(torch.float32), torch.zeros_like(
                             steps, dtype=torch.float32))

    pickup = ((a == PICKUP) & ((typ == KEY) | (typ == BALL) | (typ == BOX))
              & ~carries)
    drop = (a == DROP) & empty_front & carries
    toggle = a == TOGGLE
    # Door.toggle: a locked door opens with a key of its colour; otherwise
    # open <-> closed. Box.toggle: the box becomes what it contains.
    key_fits = (carrying[:, 0] == KEY) & (carrying[:, 1] == color)
    door = cell.clone()
    door[:, 2] = torch.where(st == LOCKED,
                             torch.where(key_fits, OPEN, LOCKED),
                             torch.where(st == OPEN, CLOSED, OPEN)).to(
                                 torch.uint8)
    box_contents = torch.zeros_like(cell)
    box_contents[:, 0] = cell[:, 3]
    box_contents[:, 1] = cell[:, 4]
    box_contents = torch.where((cell[:, 3] == 0)[:, None],
                               _cells(EMPTY_CELL, grid), box_contents)
    new_front = cell
    new_front = torch.where(pickup[:, None], _cells(EMPTY_CELL, grid),
                            new_front)
    new_front = torch.where(drop[:, None], carrying, new_front)
    new_front = torch.where((toggle & (typ == DOOR))[:, None], door,
                            new_front)
    new_front = torch.where((toggle & (typ == BOX))[:, None], box_contents,
                            new_front)
    B, W, H, _ = grid.shape
    inside = ((fpos[:, 0] >= 0) & (fpos[:, 0] < W) & (fpos[:, 1] >= 0)
              & (fpos[:, 1] < H))
    b = torch.nonzero(inside).squeeze(-1)
    grid[b, fpos[b, 0], fpos[b, 1]] = new_front[b]
    new_carrying = torch.where(pickup[:, None], cell,
                               torch.where(drop[:, None],
                                           _cells(EMPTY_CELL, grid),
                                           carrying))
    new = dict(state, grid=grid, agent_pos=new_pos.to(torch.int32),
               agent_dir=new_dir.to(torch.int32), carrying=new_carrying,
               step_count=steps)
    return new, reward, terminated, steps >= max_steps


def view_cells(state, view_size: int):
    """(B, V, V, 5) view cells, indexed [i, j] as upstream's rotated slice,
    before the visibility mask and the carried overlay."""
    V = view_size
    pos = state["agent_pos"].long()
    d = state["agent_dir"].long()
    x, y = pos[:, 0], pos[:, 1]
    top_x = torch.where(d == 0, x, torch.where(d == 2, x - V + 1,
                                               x - V // 2))
    top_y = torch.where(d == 1, y, torch.where(d == 3, y - V + 1,
                                               y - V // 2))
    r = torch.arange(V, device=pos.device)
    xs = top_x[:, None, None] + r[None, :, None]
    ys = top_y[:, None, None] + r[None, None, :]
    sl = get_cells(state["grid"], xs, ys)                   # [b, i, j]
    # rotate_left (dir + 1) times: new[i, j] = old[V - 1 - j, i]
    out = sl
    rotated = []
    for _ in range(4):
        out = out.flip(1).transpose(1, 2)
        rotated.append(out)
    pick = torch.stack(rotated)                              # [k, b, ...]
    return pick[d, torch.arange(d.shape[0], device=d.device)]


def see_behind(cells):
    typ, st = cells[..., 0], cells[..., 2]
    return ~((typ == WALL) | ((typ == DOOR) & (st != OPEN)))


def process_vis(cells):
    """Grid.process_vis with the agent at (V // 2, V - 1): (B, V, V) bool."""
    B, V = cells.shape[0], cells.shape[1]
    clear = see_behind(cells)
    mask = torch.zeros((B, V, V), dtype=torch.bool, device=cells.device)
    mask[:, V // 2, V - 1] = True
    for j in range(V - 1, -1, -1):
        for i in range(V - 1):
            m = mask[:, i, j] & clear[:, i, j]
            mask[:, i + 1, j] |= m
            if j > 0:
                mask[:, i + 1, j - 1] |= m
                mask[:, i, j - 1] |= m
        for i in range(V - 1, 0, -1):
            m = mask[:, i, j] & clear[:, i, j]
            mask[:, i - 1, j] |= m
            if j > 0:
                mask[:, i - 1, j - 1] |= m
                mask[:, i, j - 1] |= m
    return mask


def observe(state, view_size: int):
    """``gen_obs``'s image as (B, V, V) packed cells, type | colour << 4 |
    state << 7 of each visible cell, 0 where unseen: the agent's cell shows
    what it carries (an empty cell when nothing)."""
    V = view_size
    cells = view_cells(state, V)
    vis = process_vis(cells)
    cells = cells.clone()
    cells[:, V // 2, V - 1] = state["carrying"]
    c = cells.to(torch.int32)
    packed = c[..., 0] | (c[..., 1] << 4) | (c[..., 2] << 7)
    return torch.where(vis, packed, torch.zeros_like(packed))


# -- the reset row format: a packed grid (W*H int32, x-major, type | colour
# << 4 | state << 7 | contained type << 9 | contained colour << 13) and the
# scalars x, y, dir, carried cell (packed), step count, terminated,
# truncated, pad

def unpack_cells(packed):
    p = packed.to(torch.int32)
    return torch.stack([p & 15, (p >> 4) & 7, (p >> 7) & 3, (p >> 9) & 15,
                        (p >> 13) & 7], -1).to(torch.uint8)


def row_state(grid_row, scal_row, mission_row, width: int, height: int):
    """A reset row (grid (W*H,), scalars (8,), mission (L,)) as a state of
    one env."""
    return {"grid": unpack_cells(grid_row).reshape(1, width, height, 5),
            "agent_pos": scal_row[None, 0:2].to(torch.int32),
            "agent_dir": scal_row[None, 2].to(torch.int32),
            "carrying": unpack_cells(scal_row[None, 3]),
            "step_count": scal_row[None, 4].to(torch.int32),
            "mission": mission_row[None]}


def select(done, state, reset):
    """``reset`` (one env, broadcast, or one a env) where ``done``."""
    out = {}
    for k, v in state.items():
        r = reset[k].to(v.dtype)
        out[k] = torch.where(done.reshape((-1,) + (1,) * (v.ndim - 1)), r, v)
    return out


def doorkey_layout_faults(state, size: int):
    """(B,) int count of what breaks upstream ``DoorKeyEnv._gen_grid``
    (``minigrid/envs/doorkey.py``) in each env of a fresh layout: grey walls
    all round, a wall column ``split`` in [2, size - 3] with one locked
    yellow door at a row in [1, size - 3], the green goal at (size - 2, size -
    2), one yellow key and the agent left of the wall on distinct cells,
    every other cell empty, nothing carried."""
    g = state["grid"].long()
    B, W, H, _ = g.shape
    dev = g.device
    faults = torch.zeros(B, dtype=torch.long, device=dev)
    if W != size or H != size:
        return faults + 1

    def is_cell(c, values):
        return (c == torch.tensor(values, device=dev)).all(-1)

    wall = is_cell(g, WALL_CELL)
    border = torch.zeros((W, H), dtype=torch.bool, device=dev)
    border[0, :] = border[-1, :] = border[:, 0] = border[:, -1] = True
    faults += (border & ~wall).flatten(1).sum(1)
    door = is_cell(g, (DOOR, YELLOW, LOCKED, 0, 0))
    inner_col = (wall | door)[:, 1:-1, :].all(2)            # (B, W - 2)
    xs = torch.arange(1, W - 1, device=dev)
    ok_x = (xs >= 2) & (xs <= W - 3)
    col = inner_col & ok_x & (door[:, 1:-1, :].sum(2) == 1)
    faults += (col.sum(1) != 1).long()
    split = torch.where(col.any(1), xs[col.to(torch.long).argmax(1)], 0)
    door_y = door.to(torch.long).sum(1).argmax(1)
    faults += ((door_y < 1) | (door_y > H - 3)).long()
    faults += (door.flatten(1).sum(1) != 1).long()
    goal = is_cell(g, (GOAL, GREEN, 0, 0, 0))
    faults += (~goal[:, W - 2, H - 2]).long() + (goal.flatten(1).sum(1) != 1)
    key = is_cell(g, (KEY, YELLOW, 0, 0, 0))
    gx = torch.arange(W, device=dev)[None, :, None]
    left = (gx < split[:, None, None]) & ~border
    faults += ((key & left).flatten(1).sum(1) != 1).long()
    faults += (key.flatten(1).sum(1) != 1).long()
    empty = is_cell(g, EMPTY_CELL)
    faults += (~(empty | wall | door | goal | key)).flatten(1).sum(1)
    col_x = gx == split[:, None, None]
    faults += ((wall | door) & ~border & ~col_x).flatten(1).sum(1)
    x = state["agent_pos"][:, 0].long()
    y = state["agent_pos"][:, 1].long()
    b = torch.arange(B, device=dev)
    agent_ok = (x >= 1) & (x < split) & (y >= 1) & (y <= H - 2)
    agent_ok &= empty[b, x.clamp(0, W - 1), y.clamp(0, H - 1)]
    faults += (~agent_ok).long()
    faults += ((state["agent_dir"] < 0) | (state["agent_dir"] > 3)).long()
    faults += (~is_cell(state["carrying"].long(), EMPTY_CELL)).long()
    return faults
