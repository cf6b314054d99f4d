"""Batched rooms-and-doors builder.

Counterpart of ``minigrid_tpu/core/roomgrid.py`` (reference
``minigrid/core/roomgrid.py:66-438``). A :class:`Builder` holds B layouts
under construction: the grids and fixed-shape door tables,

* ``door_pos_r[b, j, i]`` -- wall slot between room (i, j) and (i+1, j)
* ``door_pos_d[b, j, i]`` -- wall slot between room (i, j) and (i, j+1)
* ``doors_r`` / ``doors_d`` -- 1 where a door or opening joins the rooms
* ``locked[b, j, i]`` -- per-room locked flag (roomgrid.py:260)
* ``combo_used[b]`` -- the (kind, colour) pairs present, 3 x 6

Room indices, wall indices, colours and flags are Python ints (the same for
every env) or (B,) tensors (one per env). Draws come from an explicit
``torch.Generator``; the JAX package's unbounded rejection loops are
bounded batch loops here. :func:`connect_all` draws its random doors in
rounds of :data:`CONNECT_ROUND` at once and keeps, per env, the prefix of
each round up to the draw that connects every room: the same sequence of
doors as one draw per iteration, with one host sync per round.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid as G
from minigrid_tpu_torch.core import place

KIND_IDS = np.array([C.KEY, C.BALL, C.BOX], np.int64)  # kind 0, 1, 2
# colour ids in sorted-name order: ``_rand_color`` draws from sorted names
# (minigrid_env.py:294-299)
SORTED_COLORS = np.array([C.COLOR_TO_IDX[n] for n in C.COLOR_NAMES],
                         np.int64)
NUM_COMBOS = 3 * C.NUM_COLORS
CONNECT_ROUND = 32  # connect_all's door draws per round (per host sync)
DIR_VEC = torch.as_tensor(C.DIR_TO_VEC, dtype=torch.int64)


@dataclasses.dataclass
class GenCounters:
    """What the batched generation loops did since the last
    :meth:`reset`: host syncs (one per loop round), the most draws any env
    used in :func:`connect_all`, and the level generator's attempts (the
    most any env took) and envs left without a valid level; ``levels``
    counts the levels asked of a BabyAI level's ``generate`` and
    ``attempts`` the env-attempts it made, first tries included."""

    host_syncs: int = 0
    connect_draws_max: int = 0
    attempts_max: int = 0
    not_ok: int = 0
    levels: int = 0
    attempts: int = 0

    def reset(self):
        self.host_syncs = self.connect_draws_max = 0
        self.attempts_max = self.not_ok = 0
        self.levels = self.attempts = 0


COUNTERS = GenCounters()


@dataclasses.dataclass(frozen=True)
class Builder:
    """B layouts under construction (see the module docstring)."""

    grid: torch.Tensor        # (B, W, H, 5) uint8
    agent_pos: torch.Tensor   # (B, 2) int32
    agent_dir: torch.Tensor   # (B,) int32
    door_pos_r: torch.Tensor  # (B, R, max(C-1, 1), 2) int32
    door_pos_d: torch.Tensor  # (B, max(R-1, 1), C, 2) int32
    doors_r: torch.Tensor     # (B, R, max(C-1, 1)) int8
    doors_d: torch.Tensor     # (B, max(R-1, 1), C) int8
    locked: torch.Tensor      # (B, R, C) bool
    combo_used: torch.Tensor  # (B, 18) bool

    def replace(self, **kw) -> "Builder":
        return dataclasses.replace(self, **kw)

    @property
    def batch_size(self) -> int:
        return self.grid.shape[0]

    @property
    def device(self) -> torch.device:
        return self.grid.device

    def tensors(self) -> dict:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}

    def where(self, cond, other: "Builder") -> "Builder":
        """Per env: this builder where ``cond`` ((B,) bool), else
        ``other``."""
        def pick(a, b):
            return torch.where(cond.reshape((-1,) + (1,) * (a.ndim - 1)),
                               a, b)
        o = other.tensors()
        return Builder(**{k: pick(v, o[k]) for k, v in self.tensors().items()})


def per_env(v, n: int, device, dtype=torch.int64) -> torch.Tensor:
    """An int, bool or (n,) tensor as an (n,) tensor of ``dtype``."""
    return torch.as_tensor(v, device=device).to(dtype).expand(n).contiguous()


def _index(t: torch.Tensor, n: int) -> torch.Tensor:
    """JAX's index rule for a traced index into an axis of ``n``: negative
    indices count from the end, then clamp into range."""
    return torch.where(t < 0, t + n, t).clamp(0, n - 1)


def _onehot_set(arr: torch.Tensor, i0, i1, value, pred=None) -> torch.Tensor:
    """``arr[b, i0[b], i1[b]] = value`` for a (B, N0, N1) table where
    ``pred`` holds; out-of-range indices write nothing (the JAX package's
    ``grid.onehot_set``)."""
    B, n0, n1 = arr.shape
    dev = arr.device
    m = ((torch.arange(n0, device=dev)[None, :, None] == i0[:, None, None])
         & (torch.arange(n1, device=dev)[None, None, :] == i1[:, None, None]))
    if pred is not None:
        m = m & pred[:, None, None]
    value = torch.as_tensor(value, device=dev).to(arr.dtype)
    if value.ndim == 1:
        value = value[:, None, None]
    return torch.where(m, value, arr)


def categorical(generator: torch.Generator, valid: torch.Tensor):
    """Index of a uniform pick among the True entries of each row of
    ``valid`` (B, N); among all N where a row has none (the JAX
    package's categorical over all-equal logits)."""
    valid = valid | ~valid.any(-1, keepdim=True)
    u = torch.rand(valid.shape, generator=generator, device=valid.device)
    return torch.where(valid, u, -1.0).argmax(-1)


def sorted_color(idx) -> torch.Tensor:
    """Colour id of a uniform index into the sorted colour names."""
    return torch.as_tensor(SORTED_COLORS, device=idx.device)[idx.to(
        torch.int64)].to(torch.uint8)


def randint(generator, lo: int, hi: int, n: int, device) -> torch.Tensor:
    """(n,) int64 uniform in [lo, hi)."""
    return torch.randint(lo, hi, (n,), generator=generator, device=device)


def cell(type_idx, color=0, state=0, cont_type=0, cont_color=0,
         device=None) -> torch.Tensor:
    """A (B|1, 5) uint8 cell from channel values (ints or (B,) tensors)."""
    chans = [torch.as_tensor(v, device=device).to(torch.int64)
             for v in (type_idx, color, state, cont_type, cont_color)]
    shape = torch.broadcast_shapes(*(c.shape for c in chans)) or (1,)
    return torch.stack([c.expand(shape) for c in chans], -1).to(torch.uint8)


class RoomLayout:
    """Static geometry of a RoomGrid configuration."""

    def __init__(self, room_size: int, num_rows: int, num_cols: int):
        if room_size < 3:
            raise ValueError(f"room_size must be >= 3, got {room_size}")
        self.room_size = room_size
        self.num_rows = num_rows
        self.num_cols = num_cols
        self.width = (room_size - 1) * num_cols + 1
        self.height = (room_size - 1) * num_rows + 1

    def room_top(self, i, j):
        rs = self.room_size - 1
        return i * rs, j * rs

    def room_rect_mask(self, i, j, device=None) -> torch.Tensor:
        """(B|1, W, H) mask of room (i, j) with its walls
        (roomgrid.py:135-138)."""
        tx, ty = self.room_top(torch.as_tensor(i, device=device),
                               torch.as_tensor(j, device=device))
        return place.rect_mask(self.width, self.height, (tx, ty),
                               (self.room_size, self.room_size), device)

    def room_from_pos(self, pos: torch.Tensor):
        """The room (i, j) of each (B, 2) position, int64."""
        rs = self.room_size - 1
        pos = pos.to(torch.int64)
        return pos[:, 0] // rs, pos[:, 1] // rs

    @property
    def table_shapes(self):
        """(rows, cols) of the right-door and the down-door tables."""
        R, Cc = self.num_rows, self.num_cols
        return (R, max(Cc - 1, 1)), (max(R - 1, 1), Cc)


def init_builder(layout: RoomLayout, generator: torch.Generator, num_envs: int,
                 device=None) -> Builder:
    """Walls around every room and random door slots (roomgrid.py:123-179);
    the agent at the centre of the middle room, facing right."""
    L, B = layout, num_envs
    rs = L.room_size
    xs, ys = np.meshgrid(np.arange(L.width), np.arange(L.height),
                         indexing="ij")
    walls = torch.as_tensor((xs % (rs - 1) == 0) | (ys % (rs - 1) == 0),
                            device=device)
    grid = G.fill_mask(G.empty_grid(B, L.width, L.height, device),
                       walls[None], C.WALL_CELL)
    (R, nr), (nd, Cc) = L.table_shapes

    def draw(shape):
        return torch.randint(1, rs - 1, (B,) + shape, generator=generator,
                             device=device)

    # right-door slot: x on the shared wall, y uniform inside the room
    # (roomgrid.py:159-161); down-door slot likewise (:162-164)
    xs_r = ((torch.arange(nr, device=device) + 1) * (rs - 1)).expand(B, R, nr)
    ys_r = draw((R, nr)) + torch.arange(R, device=device)[:, None] * (rs - 1)
    xs_d = draw((nd, Cc)) + torch.arange(Cc, device=device)[None, :] * (rs - 1)
    ys_d = ((torch.arange(nd, device=device) + 1) * (rs - 1))[:, None].expand(
        B, nd, Cc)
    cx = (L.num_cols // 2) * (rs - 1) + rs // 2
    cy = (L.num_rows // 2) * (rs - 1) + rs // 2
    return Builder(
        grid=grid,
        agent_pos=torch.tensor([cx, cy], dtype=torch.int32,
                               device=device).expand(B, 2).contiguous(),
        agent_dir=torch.zeros(B, dtype=torch.int32, device=device),
        door_pos_r=torch.stack([xs_r, ys_r], -1).to(torch.int32),
        door_pos_d=torch.stack([xs_d, ys_d], -1).to(torch.int32),
        doors_r=torch.zeros((B, R, nr), dtype=torch.int8, device=device),
        doors_d=torch.zeros((B, nd, Cc), dtype=torch.int8, device=device),
        locked=torch.zeros((B, R, Cc), dtype=torch.bool, device=device),
        combo_used=torch.zeros((B, NUM_COMBOS), dtype=torch.bool,
                               device=device),
    )


def _door_slot(b: Builder, i, j, door_idx):
    """(is_right_table, ii_r, jj_d, pos) of each env's wall ``door_idx``
    of room (i, j); walls are right, down, left, up (roomgrid.py:31)."""
    B, dev = b.batch_size, b.device
    i, j, d = (per_env(v, B, dev) for v in (i, j, door_idx))
    is_r = d % 2 == 0
    ii_r = torch.where(d == 0, i, i - 1)
    jj_d = torch.where(d == 1, j, j - 1)
    (R, nr), (nd, Cc) = b.doors_r.shape[1:], b.doors_d.shape[1:]
    bi = torch.arange(B, device=dev)
    pos = torch.where(is_r[:, None],
                      b.door_pos_r[bi, _index(j, R), _index(ii_r, nr)],
                      b.door_pos_d[bi, _index(jj_d, nd), _index(i, Cc)])
    return is_r, ii_r, jj_d, pos


def has_neighbor(layout: RoomLayout, i, j, door_idx) -> torch.Tensor:
    dev = next((v.device for v in (i, j, door_idx)
                if isinstance(v, torch.Tensor)), None)
    i, j, d = (torch.as_tensor(v, device=dev) for v in (i, j, door_idx))
    return torch.where(
        d == 0, i < layout.num_cols - 1,
        torch.where(d == 1, j < layout.num_rows - 1,
                    torch.where(d == 2, i > 0, j > 0)))


def door_exists(b: Builder, i, j, door_idx) -> torch.Tensor:
    B, dev = b.batch_size, b.device
    i, j = per_env(i, B, dev), per_env(j, B, dev)
    is_r, ii_r, jj_d, _ = _door_slot(b, i, j, door_idx)
    (R, nr), (nd, Cc) = b.doors_r.shape[1:], b.doors_d.shape[1:]
    bi = torch.arange(B, device=dev)
    return torch.where(is_r, b.doors_r[bi, _index(j, R), _index(ii_r, nr)],
                       b.doors_d[bi, _index(jj_d, nd), _index(i, Cc)]) > 0


def _mark_door(b: Builder, i, j, door_idx, pred=None) -> Builder:
    B, dev = b.batch_size, b.device
    i, j = per_env(i, B, dev), per_env(j, B, dev)
    is_r, ii_r, jj_d, _ = _door_slot(b, i, j, door_idx)
    pr, pd = is_r, ~is_r
    if pred is not None:
        pr, pd = pr & pred, pd & pred
    return b.replace(doors_r=_onehot_set(b.doors_r, j, ii_r, 1, pr),
                     doors_d=_onehot_set(b.doors_d, jj_d, i, 1, pd))


def add_door(b: Builder, layout: RoomLayout, generator, i, j, door_idx=None,
             color=None, locked=None):
    """Place a door joining room (i, j) to its neighbour through wall
    ``door_idx`` (roomgrid.py:230-274): a uniform wall with a neighbour and
    no door yet, a uniform colour and a fair coin for ``locked`` where
    those are None. Returns (builder, colour (B,) uint8, pos (B, 2))."""
    B, dev = b.batch_size, b.device
    i, j = per_env(i, B, dev), per_env(j, B, dev)
    if door_idx is None:
        valid = torch.stack([has_neighbor(layout, i, j, d)
                             & ~door_exists(b, i, j, d) for d in range(4)],
                            -1)
        door_idx = categorical(generator, valid)
    if color is None:
        color = sorted_color(randint(generator, 0, 6, B, dev))
    if locked is None:
        locked = randint(generator, 0, 2, B, dev) == 0
    color = per_env(color, B, dev, torch.uint8)
    locked = per_env(locked, B, dev, torch.bool)
    _, _, _, pos = _door_slot(b, i, j, door_idx)
    state = torch.where(locked, C.LOCKED, C.CLOSED)
    grid = G.set_cell(b.grid, pos[:, 0], pos[:, 1],
                      cell(C.DOOR, color, state, device=dev))
    b = b.replace(grid=grid, locked=_onehot_set(b.locked, j, i, locked))
    return _mark_door(b, i, j, door_idx), color, pos


def remove_wall(b: Builder, layout: RoomLayout, i, j, wall_idx: int
                ) -> Builder:
    """Open the whole wall ``wall_idx`` of room (i, j)
    (roomgrid.py:276-311)."""
    rs = layout.room_size
    tx, ty = layout.room_top(torch.as_tensor(i, device=b.device),
                             torch.as_tensor(j, device=b.device))
    rect = {0: (tx + rs - 1, ty + 1, 1, rs - 2),
            1: (tx + 1, ty + rs - 1, rs - 2, 1),
            2: (tx, ty + 1, 1, rs - 2),
            3: (tx + 1, ty, rs - 2, 1)}
    if wall_idx not in rect:
        raise ValueError(f"invalid wall index {wall_idx}")
    b = b.replace(grid=G.fill_rect(b.grid, *rect[wall_idx], C.EMPTY_CELL))
    return _mark_door(b, i, j, wall_idx)


def place_in_room_mask(b: Builder, layout: RoomLayout, i, j) -> torch.Tensor:
    """(B, W, H) cells where :func:`place_in_room` may put an object: free,
    in room (i, j), not the agent's cell nor orthogonally next to it
    (roomgrid.py:181-196 with reject_next_to :11-20)."""
    xs, ys = G.coord_grids(layout.width, layout.height, b.device)
    ax = b.agent_pos[:, 0].to(torch.int64)[:, None, None]
    ay = b.agent_pos[:, 1].to(torch.int64)[:, None, None]
    manhattan = (xs - ax).abs() + (ys - ay).abs()
    return (G.free_mask(b.grid) & layout.room_rect_mask(i, j, b.device)
            & (manhattan >= 2) & ~((xs == ax) & (ys == ay)))


def place_in_room(b: Builder, layout: RoomLayout, generator, i, j, cell_):
    """Place ``cell_`` ((5,) or (B, 5)) uniformly in room (i, j). Returns
    (builder, pos (B, 2) int32)."""
    pos = place.sample_from_mask(generator,
                                 place_in_room_mask(b, layout, i, j))
    return b.replace(grid=G.set_cell(b.grid, pos[:, 0], pos[:, 1],
                                     cell_)), pos


def _use_combo(b: Builder, combo) -> Builder:
    hit = torch.arange(NUM_COMBOS, device=b.device)[None] == combo[:, None]
    return b.replace(combo_used=b.combo_used | hit)


def add_object(b: Builder, layout: RoomLayout, generator, i, j, kind=None,
               color=None):
    """Add a key, ball or box to room (i, j) (roomgrid.py:198-228); a
    uniform kind and colour where None. Returns (builder, kind (B,) int64
    indexing KIND_IDS, colour (B,) uint8, pos (B, 2) int32)."""
    B, dev = b.batch_size, b.device
    if kind is None:
        kind = randint(generator, 0, 3, B, dev)
    if color is None:
        color = sorted_color(randint(generator, 0, 6, B, dev))
    kind = per_env(kind, B, dev)
    color = per_env(color, B, dev, torch.uint8)
    kind_t = torch.as_tensor(KIND_IDS, device=dev)[kind]
    b, pos = place_in_room(b, layout, generator, i, j,
                           cell(kind_t, color, device=dev))
    return _use_combo(b, kind * 6 + color.to(torch.int64)), kind, color, pos


def _front_ok(grid: torch.Tensor) -> torch.Tensor:
    """(B, W, H, 4): the cell ahead in direction d is empty, a wall or off
    the grid (roomgrid.py:330-332)."""
    t = grid[..., 0]
    ok = F.pad(((t == C.EMPTY) | (t == C.WALL))[:, None].to(torch.uint8),
               (1, 1, 1, 1), value=1)[:, 0].bool()
    W, H = t.shape[1:]
    out = []
    for d in range(4):
        dx, dy = (int(v) for v in C.DIR_TO_VEC[d])
        out.append(ok[:, 1 + dx:1 + dx + W, 1 + dy:1 + dy + H])
    return torch.stack(out, -1)


def place_agent(b: Builder, layout: RoomLayout, generator, i=None, j=None,
                rand_dir: bool = True) -> Builder:
    """Agent placement in room (i, j) (a uniform room where None), on a
    free cell, never facing an object (roomgrid.py:313-334): with
    ``rand_dir`` a uniform (cell, direction) pair among the valid ones."""
    B, dev = b.batch_size, b.device
    if i is None:
        i = randint(generator, 0, layout.num_cols, B, dev)
    if j is None:
        j = randint(generator, 0, layout.num_rows, B, dev)
    H = layout.height
    free = G.free_mask(b.grid) & layout.room_rect_mask(i, j, dev)
    front_ok = _front_ok(b.grid)
    if rand_dir:
        valid = (free[..., None] & front_ok).reshape(B, -1)
        flat = categorical(generator, valid)
        xy = flat // 4
        pos = torch.stack([xy // H, xy % H], -1).to(torch.int32)
        return b.replace(agent_pos=pos, agent_dir=(flat % 4).to(torch.int32))
    d = b.agent_dir.to(torch.int64)[:, None, None, None]
    valid = free & torch.gather(front_ok, 3, d.expand(-1, *free.shape[1:],
                                                      1))[..., 0]
    return b.replace(agent_pos=place.sample_from_mask(generator, valid))


# --- room connectivity --------------------------------------------------------

def _edge_tables(layout: RoomLayout):
    """(E, N, N) adjacency of each edge of the room graph, edges numbered
    right-table entries first (row-major), then down-table entries; rooms
    numbered j * num_cols + i."""
    R, Cc = layout.num_rows, layout.num_cols
    edges = [(j * Cc + i, j * Cc + i + 1) for j in range(R)
             for i in range(Cc - 1)]
    edges += [(j * Cc + i, (j + 1) * Cc + i) for j in range(R - 1)
              for i in range(Cc)]
    adj = np.zeros((max(len(edges), 1), R * Cc, R * Cc), np.float32)
    for e, (u, v) in enumerate(edges):
        adj[e, u, v] = adj[e, v, u] = 1
    return adj, len(edges)


def _open_edges(b: Builder, layout: RoomLayout) -> torch.Tensor:
    """(B, E) bool: which edges of the room graph have a door or
    opening."""
    R, Cc = layout.num_rows, layout.num_cols
    parts = []
    if Cc > 1:
        parts.append(b.doors_r.reshape(b.batch_size, -1) > 0)
    if R > 1:
        parts.append(b.doors_d.reshape(b.batch_size, -1) > 0)
    if not parts:
        return torch.zeros((b.batch_size, 1), dtype=torch.bool,
                           device=b.device)
    return torch.cat(parts, -1)


def _closure(open_edges: torch.Tensor, layout: RoomLayout) -> torch.Tensor:
    """(..., N, N) bool: room v reachable from room u through the open
    edges ((..., E) bool)."""
    adj_t, _ = _edge_tables(layout)
    adj = torch.as_tensor(adj_t, device=open_edges.device)
    n = adj.shape[-1]
    m = torch.einsum("...e,enm->...nm", open_edges.to(torch.float32), adj)
    m = (m + torch.eye(n, device=m.device)) > 0
    for _ in range(max(1, (n - 1).bit_length())):
        m = torch.matmul(m.to(torch.float32), m.to(torch.float32)) > 0
    return m


def reachable_rooms(b: Builder, layout: RoomLayout) -> torch.Tensor:
    """(B, R, C) bool: rooms joined to the agent's room by doors and
    openings (the find_reach DFS, roomgrid.py:348-359)."""
    R, Cc = layout.num_rows, layout.num_cols
    i0, j0 = layout.room_from_pos(b.agent_pos)
    m = _closure(_open_edges(b, layout), layout)
    start = (j0 * Cc + i0).clamp(0, R * Cc - 1)
    bi = torch.arange(b.batch_size, device=b.device)
    return m[bi, start].reshape(-1, R, Cc)


def connect_all(b: Builder, layout: RoomLayout, generator,
                door_color_ids=None, max_itrs: int = 5000,
                exclude_color=None) -> Builder:
    """Add random unlocked doors until every room is reachable
    (roomgrid.py:336-394), at most ``max_itrs`` draws per env: each draw
    is a uniform room, wall and colour, kept when the wall has a neighbour,
    no door yet and neither room is locked.

    ``exclude_color`` ((B,) colour ids, -1 for none) removes one colour
    from each env's palette (the BabyAI Unlock level's door colours,
    envs/babyai/unlock.py:63-66). The draws run in rounds of
    :data:`CONNECT_ROUND` over the envs not yet connected; in each round
    an env keeps its valid draws up to the first that connects it."""
    R, Cc = layout.num_rows, layout.num_cols
    B, dev = b.batch_size, b.device
    colors = torch.as_tensor(SORTED_COLORS if door_color_ids is None
                             else np.asarray(door_color_ids), device=dev)
    n_colors = colors.shape[0]
    (_, nr), (nd, _) = layout.table_shapes
    _, n_edges = _edge_tables(layout)
    K = CONNECT_ROUND
    draws = torch.zeros(B, dtype=torch.int64, device=dev)
    start = layout.room_from_pos(b.agent_pos)
    start = (start[1] * Cc + start[0]).clamp(0, R * Cc - 1)
    if exclude_color is not None:
        excl = per_env(exclude_color, B, dev)
        is_excl = colors[None, :] == excl[:, None]
        has_excl = is_excl.any(-1)
        excl_pos = is_excl.to(torch.int8).argmax(-1)
    done = reachable_rooms(b, layout).reshape(B, -1).all(-1)
    while True:
        COUNTERS.host_syncs += 1
        todo = torch.nonzero(~done & (draws < max_itrs))[:, 0]
        if todo.numel() == 0:
            break
        n = todo.numel()
        sub = Builder(**{k: v[todo] for k, v in b.tensors().items()})
        # K draws per env: room, wall, colour
        i = randint(generator, 0, Cc, n * K, dev).reshape(n, K)
        j = randint(generator, 0, R, n * K, dev).reshape(n, K)
        k = randint(generator, 0, 4, n * K, dev).reshape(n, K)
        u = torch.rand((n, K), generator=generator, device=dev,
                       dtype=torch.float64)
        if exclude_color is None:
            ci = (u * n_colors).floor().to(torch.int64)
        else:
            he = has_excl[todo][:, None]
            ci = (u * torch.where(he, n_colors - 1, n_colors)).floor().to(
                torch.int64)
            ci = ci + (he & (ci >= excl_pos[todo][:, None])).to(torch.int64)
        color = colors[ci.clamp(max=n_colors - 1)]
        # the edge of each draw and whether it is valid on its own
        is_r = k % 2 == 0
        ii = torch.where(k == 0, i, i - 1)
        jj = torch.where(k == 1, j, j - 1)
        edge = torch.where(is_r, j * max(Cc - 1, 1) + ii,
                           R * (Cc - 1) + jj * Cc + i)
        ok = has_neighbor(layout, i, j, k)
        ni = (i + DIR_VEC.to(dev)[k, 0]).clamp(0, Cc - 1)
        nj = (j + DIR_VEC.to(dev)[k, 1]).clamp(0, R - 1)
        bi = torch.arange(n, device=dev)[:, None]
        ok &= ~sub.locked[bi, j, i] & ~sub.locked[bi, nj, ni]
        edge = torch.where(ok, edge, 0).clamp(0, max(n_edges, 1) - 1)
        opened = _open_edges(sub, layout)                      # (n, E)
        ok &= ~opened[bi, edge]
        ok &= (draws[todo][:, None] + torch.arange(K, device=dev)) < max_itrs
        # a later draw of an edge an earlier draw of this round opened is
        # a door that exists
        same = edge[:, :, None] == edge[:, None, :]            # (n, K, K)
        earlier = torch.ones(K, K, dtype=torch.bool, device=dev).tril(-1)
        ok &= ~(same & earlier & ok[:, None, :]).any(-1)
        # the rooms reached after each prefix of the round's doors
        hot = F.one_hot(edge, max(n_edges, 1)).bool() & ok[..., None]
        prefix = opened[:, None] | (hot.to(torch.int32).cumsum(1) > 0)
        reach = _closure(prefix, layout)                       # (n,K,N,N)
        conn = reach[torch.arange(n, device=dev), :, start[todo]].all(-1)
        found = conn.any(-1)
        stop = torch.where(found, conn.to(torch.int8).argmax(-1), K - 1)
        keep = ok & (torch.arange(K, device=dev) <= stop[:, None])
        # write the kept doors: distinct slots, so one blend for all
        pos = torch.where(
            is_r[..., None],
            sub.door_pos_r[bi, _index(j, R), _index(ii, nr)],
            sub.door_pos_d[bi, _index(jj, nd), _index(i, Cc)]).to(torch.int64)
        xs, ys = G.coord_grids(layout.width, layout.height, dev)
        hit = ((xs == pos[..., 0, None, None]) & (ys == pos[..., 1, None, None])
               & keep[..., None, None])                        # (n,K,W,H)
        door_color = (hit * color[..., None, None]).sum(1)
        doors = cell(C.DOOR, door_color, C.CLOSED, device=dev)
        grid = torch.where(hit.any(1)[..., None], doors, sub.grid)
        rows_r = torch.arange(R, device=dev)[:, None]
        cols_r = torch.arange(nr, device=dev)[None, :]
        rows_d = torch.arange(nd, device=dev)[:, None]
        cols_d = torch.arange(Cc, device=dev)[None, :]
        new_r = ((rows_r == j[..., None, None]) & (cols_r == ii[..., None, None])
                 & (keep & is_r)[..., None, None]).any(1)
        new_d = ((rows_d == jj[..., None, None]) & (cols_d == i[..., None, None])
                 & (keep & ~is_r)[..., None, None]).any(1)
        b = b.replace(
            grid=b.grid.index_copy(0, todo, grid),
            doors_r=b.doors_r.index_copy(
                0, todo, torch.where(new_r, 1, sub.doors_r).to(torch.int8)),
            doors_d=b.doors_d.index_copy(
                0, todo, torch.where(new_d, 1, sub.doors_d).to(torch.int8)))
        used = torch.where(found, stop + 1, K)
        draws = draws.index_add(0, todo, used.clamp(
            max=max_itrs - draws[todo]))
        done = done.index_copy(0, todo, found)
    if B:
        COUNTERS.connect_draws_max = max(COUNTERS.connect_draws_max,
                                         int(draws.max()))
    return b


def add_distractors(b: Builder, layout: RoomLayout, generator, i=None, j=None,
                    num_distractors: int = 10, all_unique: bool = True):
    """Scatter random objects, one after another (roomgrid.py:396-438): a
    (kind, colour) pair uniform over the unused ones (``all_unique``) or
    all 18, in room (i, j) or a uniform room. Returns (builder, kinds
    (B, n) int64, colours (B, n) uint8, positions (B, n, 2) int32)."""
    B, dev = b.batch_size, b.device
    kinds, colors, positions = [], [], []
    for _ in range(num_distractors):
        if all_unique:
            combo = categorical(generator, ~b.combo_used)
        else:
            combo = randint(generator, 0, NUM_COMBOS, B, dev)
        kind, color = combo // 6, (combo % 6).to(torch.uint8)
        ri = i if i is not None else randint(generator, 0, layout.num_cols,
                                             B, dev)
        rj = j if j is not None else randint(generator, 0, layout.num_rows,
                                             B, dev)
        kind_t = torch.as_tensor(KIND_IDS, device=dev)[kind]
        b, pos = place_in_room(b, layout, generator, ri, rj,
                               cell(kind_t, color, device=dev))
        b = _use_combo(b, combo)
        kinds.append(kind)
        colors.append(color)
        positions.append(pos)
    if not num_distractors:
        return (b, torch.zeros((B, 0), dtype=torch.int64, device=dev),
                torch.zeros((B, 0), dtype=torch.uint8, device=dev),
                torch.zeros((B, 0, 2), dtype=torch.int32, device=dev))
    return (b, torch.stack(kinds, 1), torch.stack(colors, 1),
            torch.stack(positions, 1))
