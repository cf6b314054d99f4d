"""Plain reference of BabyAI's PutNextLocal level, written from upstream
Minigrid: ``minigrid/envs/babyai/putnext.py`` (``PutNextLocal``: one room,
``num_objs`` distinct objects, "put the <a> next to the <b>"),
``minigrid/envs/babyai/core/verifier.py`` (``PutNextInstr``: success when
the agent drops an object the first description matches on a cell next to
one the second matches), ``minigrid/envs/babyai/core/roomgrid_level.py``
(the step: the core transition, then the verifier; the step budget
``num_navs * room_size^2 * rows * cols``, two navigations for "put next")
and ``roomgrid.py`` (``check_objs_reachable``).

It imports nothing of the program. The mission is read from its tokens with
the configuration's vocabulary. As in :mod:`reference.minigrid`, a state is a
dict of batch-leading tensors.
"""

from __future__ import annotations

import torch

from reference import minigrid as M

OBJECT_TYPES = {"key": M.KEY, "ball": M.BALL, "box": M.BOX}
COLOR_NAMES = ("red", "green", "blue", "purple", "yellow", "grey")
# "put the <colour> <type> next to the <colour> <type>"
PATTERN = ("put", "the", None, None, "next", "to", "the", None, None)


def parse_missions(tokens, vocabulary):
    """(move type, move colour, fixed type, fixed colour, malformed) of each
    env's "put next" mission, (B,) tensors each; ``vocabulary[i - 1]`` is
    the word of token id i, 0 pads."""
    dev = tokens.device
    V = len(vocabulary) + 1

    def table(mapping):
        t = torch.full((V,), -1, dtype=torch.long, device=dev)
        for i, w in enumerate(vocabulary, 1):
            if w in mapping:
                t[i] = mapping[w]
        return t

    word_id = {w: i for i, w in enumerate(vocabulary, 1)}
    types = table(OBJECT_TYPES)
    colors = table({c: i for i, c in enumerate(COLOR_NAMES)})
    t = tokens.long()
    bad = (t[:, len(PATTERN):] != 0).any(1)
    for i, w in enumerate(PATTERN):
        if w is not None:
            bad |= t[:, i] != word_id[w]
    out = (types[t[:, 3]], colors[t[:, 2]], types[t[:, 8]], colors[t[:, 7]])
    for x in out:
        bad |= x < 0
    return (*out, bad)


def _has(grid, typ, color):
    return (grid[..., 0].long() == typ[:, None, None]) & (
        grid[..., 1].long() == color[:, None, None])


def budget(room_size: int, rows: int = 1, cols: int = 1) -> int:
    """The step budget of a "put next" mission: two navigations."""
    return 2 * room_size * room_size * rows * cols


def step(state, action, vocabulary, max_steps: int,
         reward_dtype=torch.float32):
    """One step of the level: the core transition, then PutNextInstr's
    verifier. Returns (new state, reward, terminated, truncated)."""
    new, _, terminated, truncated = M.step(state, action, max_steps,
                                           reward_dtype)
    mt, mc, ft, fc, _ = parse_missions(state["mission"], vocabulary)
    before, after = state["carrying"].long(), new["carrying"].long()
    dropped = ((action.long() == M.DROP) & (before[:, 0] != M.EMPTY)
               & (after[:, 0] == M.EMPTY)
               & (before[:, 0] == mt) & (before[:, 1] == mc))
    fpos = M.front(state)
    fixed = _has(new["grid"], ft, fc)                       # (B, W, H)
    B, W, H = fixed.shape
    near = torch.zeros(B, dtype=torch.bool, device=fixed.device)
    b = torch.arange(B, device=fixed.device)
    for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        x, y = fpos[:, 0] + dx, fpos[:, 1] + dy
        inside = (x >= 0) & (x < W) & (y >= 0) & (y < H)
        near |= inside & fixed[b, x.clamp(0, W - 1), y.clamp(0, H - 1)]
    success = dropped & near
    reward = torch.where(success,
                         M.reward_f32(new["step_count"], max_steps,
                                      reward_dtype, ratio_first=False)
                         .to(torch.float32),
                         torch.zeros_like(new["step_count"],
                                          dtype=torch.float32))
    return new, reward, terminated | success, truncated


def layout_faults(state, vocabulary, size: int, num_objs: int):
    """(B,) count of what breaks a fresh PutNextLocal layout: grey walls all
    round a ``size`` room; ``num_objs`` keys, balls and boxes (empty boxes),
    no two of one type and colour, every one reachable from the agent
    (``check_objs_reachable``); the agent inside, on an empty cell, carrying
    nothing; a "put next" mission naming two different objects of the
    room."""
    g = state["grid"].long()
    B, W, H, _ = g.shape
    dev = g.device
    faults = torch.zeros(B, dtype=torch.long, device=dev)
    if W != size or H != size:
        return faults + 1
    typ, color = g[..., 0], g[..., 1]
    border = torch.zeros((W, H), dtype=torch.bool, device=dev)
    border[0, :] = border[-1, :] = border[:, 0] = border[:, -1] = True
    wall = (typ == M.WALL) & (color == M.GREY) & (g[..., 2:] == 0).all(-1)
    faults += (border & ~wall).flatten(1).sum(1)
    obj = (typ == M.KEY) | (typ == M.BALL) | (typ == M.BOX)
    empty = (g == torch.tensor(M.EMPTY_CELL, device=dev)).all(-1)
    faults += (~border & ~(obj | empty)).flatten(1).sum(1)
    faults += (obj & (g[..., 2:] != 0).any(-1)).flatten(1).sum(1)
    faults += (obj.flatten(1).sum(1) != num_objs).long()
    code = torch.where(obj, typ * 8 + color, -1).flatten(1)
    for k in range(M.KEY * 8, M.BOX * 8 + 8):
        faults += ((code == k).sum(1) > 1).long()
    x, y = state["agent_pos"][:, 0].long(), state["agent_pos"][:, 1].long()
    b = torch.arange(B, device=dev)
    inside = (x >= 1) & (x <= W - 2) & (y >= 1) & (y <= H - 2)
    faults += (~(inside & empty[b, x.clamp(0, W - 1), y.clamp(0, H - 1)])
               ).long()
    faults += ((state["agent_dir"] < 0) | (state["agent_dir"] > 3)).long()
    faults += (~(state["carrying"].long() == torch.tensor(
        M.EMPTY_CELL, device=dev)).all(-1)).long()
    # reachability: the flood through empty cells from the agent, with the
    # blocking cells it touches
    reach = torch.zeros((B, W, H), dtype=torch.bool, device=dev)
    reach[b, x.clamp(0, W - 1), y.clamp(0, H - 1)] = True
    open_ = empty | (typ == M.DOOR)
    for _ in range(W * H):
        src = reach & open_
        grow = torch.zeros_like(reach)
        grow[:, 1:] |= src[:, :-1]
        grow[:, :-1] |= src[:, 1:]
        grow[:, :, 1:] |= src[:, :, :-1]
        grow[:, :, :-1] |= src[:, :, 1:]
        nxt = reach | grow
        if torch.equal(nxt, reach):
            break
        reach = nxt
    faults += (obj & ~reach).flatten(1).sum(1)
    mt, mc, ft, fc, bad = parse_missions(state["mission"], vocabulary)
    faults += bad.long()
    faults += (~_has(state["grid"], mt, mc).flatten(1).any(1)).long()
    faults += (~_has(state["grid"], ft, fc).flatten(1).any(1)).long()
    faults += ((mt == ft) & (mc == fc)).long()
    return faults
