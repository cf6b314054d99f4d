"""Plain reference of BabyAI's LevelGen levels (``BabyAI-BossLevel-v0``),
written from upstream Minigrid: ``minigrid/envs/babyai/synth.py``
(``BossLevel``: a ``LevelGen`` with its defaults),
``minigrid/envs/babyai/core/levelgen.py`` (the locked room, ``connect_all``,
18 distractors, the agent outside the locked room, random instructions of
kinds action, and, seq over goto, pickup, open and putnext with random
descriptors), ``minigrid/envs/babyai/core/verifier.py`` (``ObjDesc``,
``GoToInstr``, ``PickupInstr``, ``OpenInstr``, ``PutNextInstr``,
``AndInstr``, ``BeforeInstr``, ``AfterInstr`` and their surfaces),
``minigrid/envs/babyai/core/roomgrid_level.py`` (the step: the core
transition, ``update_objs_poss`` after every drop action, then the
verifier; the budget ``num_navs * room_size^2 * rows * cols``;
``validate_instrs``) and ``minigrid/core/roomgrid.py`` (``add_door``,
``connect_all``, ``place_agent``).

It imports nothing of the program. A mission is read from its tokens with
the configuration's vocabulary into its instruction tree. Upstream tracks
objects by identity: here every object of a layout gets an id when an
episode starts (its cell's index), and the ids move with the objects, so a
descriptor's ``obj_set`` is a set of ids and ``obj_poss`` a set of cells.

Where the JAX package departs from upstream on purpose, the port keeps its
behaviour and so does this reference:

1. A pickup or put-next instruction's ``preCarrying`` starts unknown, not
   ``None``: a pickup succeeds only after a call of its verifier that saw
   the agent's hands empty (the JAX package's ``pre_empty`` starts false,
   ``minigrid_tpu/envs/babyai/core/instrs.py``). Upstream, a "then pick up"
   part whose first call picks up a matching object succeeds at once.
2. ``validate_instrs`` also rejects a key descriptor of any colour while a
   locked door exists (upstream: only a key of a locked door's colour).
3. Generation's rejections that a layout cannot show (every leaf's four
   descriptor draws must each match an object; a level still invalid after
   its first attempt and 64 retries is kept) are not checked: a kept
   invalid level would read as a fault here, and BossLevel's levels
   validate within a few attempts.

As in :mod:`reference.minigrid`, a state is a dict of batch-leading tensors.
"""

from __future__ import annotations

import torch

from reference import minigrid as M

TYPE_WORDS = {"box": M.BOX, "ball": M.BALL, "key": M.KEY, "door": M.DOOR,
              "object": -1}
COLOR_WORDS = {"red": M.RED, "green": M.GREEN, "blue": M.BLUE,
               "purple": M.PURPLE, "yellow": M.YELLOW, "grey": M.GREY}
LEFT, RIGHT, FRONT, BEHIND = range(4)
LOC_WORDS = ((("on", "your", "left"), LEFT), (("on", "your", "right"), RIGHT),
             (("in", "front", "of", "you"), FRONT), (("behind", "you"), BEHIND))
GOTO, PICKUP, OPEN, PUTNEXT = range(4)
ACTION, AND, BEFORE, AFTER = range(4)
NONE = -1           # no leaf; any type or colour; no location; nothing held
UNKNOWN = -2        # preCarrying before the first call (departure 1)
LEAVES = 4          # part A: leaves 0, 1; part B: leaves 2, 3
SLOTS = 2 * LEAVES  # leaf k: descriptor 2k (its object), 2k + 1 (put next's)


class Mission:
    """One mission's instruction tree: the root kind, whether each part is
    an "and" of two leaves, each leaf's kind (or NONE) and each
    descriptor's (type, colour, location, article "a")."""

    def __init__(self):
        self.root = ACTION
        self.a_and = self.b_and = False
        self.kinds = [NONE] * LEAVES
        self.descs = [(NONE, NONE, NONE, False)] * SLOTS

    def used_slots(self):
        """The descriptor slots the tree uses, each with its leaf's kind
        and whether it is the put-next's second."""
        out = []
        for k, kind in enumerate(self.kinds):
            if kind != NONE:
                out.append((2 * k, kind, False))
                if kind == PUTNEXT:
                    out.append((2 * k + 1, kind, True))
        return out

    def navs(self) -> int:
        """``num_navs_needed``: one a leaf, two a put next."""
        return sum(2 if k == PUTNEXT else 1 for k in self.kinds if k != NONE)


class _Words:
    def __init__(self, words):
        self.w, self.i = words, 0

    def take(self, *seq) -> bool:
        if tuple(self.w[self.i:self.i + len(seq)]) == seq:
            self.i += len(seq)
            return True
        return False

    def next(self):
        if self.i >= len(self.w):
            raise ValueError("the mission ends early")
        self.i += 1
        return self.w[self.i - 1]


def _desc(r: _Words):
    """ObjDesc.surface: the|a [colour] type [location]."""
    article = r.next()
    if article not in ("the", "a"):
        raise ValueError(f"article {article!r}")
    word = r.next()
    color = NONE
    if word in COLOR_WORDS:
        color, word = COLOR_WORDS[word], r.next()
    if word not in TYPE_WORDS:
        raise ValueError(f"type {word!r}")
    loc = NONE
    for seq, code in LOC_WORDS:
        if r.take(*seq):
            loc = code
            break
    return (TYPE_WORDS[word], color, loc, article == "a")


def _leaf(r: _Words, m: Mission, k: int):
    if r.take("go", "to"):
        m.kinds[k], m.descs[2 * k] = GOTO, _desc(r)
    elif r.take("pick", "up"):
        m.kinds[k], m.descs[2 * k] = PICKUP, _desc(r)
    elif r.take("open"):
        m.kinds[k], m.descs[2 * k] = OPEN, _desc(r)
    elif r.take("put"):
        m.kinds[k], m.descs[2 * k] = PUTNEXT, _desc(r)
        if not r.take("next", "to"):
            raise ValueError("put without next to")
        m.descs[2 * k + 1] = _desc(r)
    else:
        raise ValueError(f"no verb at word {r.i}")


def _part(r: _Words, m: Mission, k: int) -> bool:
    """A leaf, or two joined by "and" (AndInstr.surface)."""
    _leaf(r, m, k)
    if r.take("and"):
        _leaf(r, m, k + 1)
        return True
    return False


def parse(words) -> Mission:
    """The instruction tree of a mission's words; ValueError where the
    words are not a surface of LevelGen's grammar."""
    r, m = _Words(list(words)), Mission()
    m.a_and = _part(r, m, 0)
    if r.take(",", "then"):
        m.root = BEFORE
    elif r.take("after", "you"):
        m.root = AFTER
    else:
        m.root = AND if m.a_and else ACTION
    if m.root in (BEFORE, AFTER):
        m.b_and = _part(r, m, 2)
    if r.i != len(r.w):
        raise ValueError(f"words left after word {r.i}")
    return m


def parse_tokens(tokens, vocabulary):
    """(Mission or None where malformed) of each row of (B, L) token ids;
    ``vocabulary[i - 1]`` is the word of id i, 0 pads."""
    out, memo = [], {}
    for row in tokens.cpu().tolist():
        key = tuple(t for t in row if t)
        if key not in memo:
            try:
                if any(t < 1 or t > len(vocabulary) for t in key):
                    raise ValueError("token outside the vocabulary")
                memo[key] = parse(vocabulary[t - 1] for t in key)
            except ValueError:
                memo[key] = None
        out.append(memo[key])
    return out


def _tensors(missions, device):
    """The parsed missions as tensors (a malformed one as a lone goto leaf
    of an impossible descriptor, counted by :func:`layout_faults`)."""
    ms = [m if m is not None else _bad() for m in missions]

    def t(rows, dtype=torch.long):
        return torch.tensor(rows, dtype=dtype, device=device)

    descs = t([[d[:3] for d in m.descs] for m in ms]).reshape(-1, SLOTS, 3)
    return {"root": t([m.root for m in ms]),
            "a_and": t([m.a_and for m in ms], torch.bool),
            "b_and": t([m.b_and for m in ms], torch.bool),
            "kinds": t([m.kinds for m in ms]).reshape(-1, LEAVES),
            "type": descs[..., 0], "color": descs[..., 1],
            "loc": descs[..., 2], "navs": t([m.navs() for m in ms])}


def _bad() -> Mission:
    m = Mission()
    m.kinds[0], m.descs[0] = GOTO, (M.WALL, M.RED, NONE, False)
    return m


def budget(navs, room_size: int, rows: int, cols: int):
    """The episode's step budget (roomgrid_level.py: ``num_navs *
    room_size^2 * num_rows * num_cols``)."""
    return navs * room_size * room_size * rows * cols


# -- find_matching_objs ------------------------------------------------------

def _coords(W, H, device):
    xs = torch.arange(W, device=device)[:, None].expand(W, H)
    ys = torch.arange(H, device=device)[None, :].expand(W, H)
    return xs, ys


def match(grid, agent_pos, agent_dir, typ, color, loc, room_size: int):
    """(B, S, W, H) bool: the cells whose object each of S descriptors
    matches with its location, from the agent's pose (ObjDesc.
    find_matching_objs with use_location): a type and colour where given;
    a location word only in the agent's room, walls included, by the signs
    of the offset's products with the facing direction and its right."""
    g = grid.long()
    W, H = g.shape[1:3]
    t, c = g[..., 0][:, None], g[..., 1][:, None]
    ok = (t != M.EMPTY) & ((typ[..., None, None] < 0)
                           | (t == typ[..., None, None]))
    ok &= (color[..., None, None] < 0) | (c == color[..., None, None])
    xs, ys = _coords(W, H, g.device)
    ax, ay = agent_pos[:, 0].long(), agent_pos[:, 1].long()
    rs = room_size - 1
    rx, ry = (ax // rs) * rs, (ay // rs) * rs
    in_room = ((xs >= rx[:, None, None]) & (xs < rx[:, None, None] + room_size)
               & (ys >= ry[:, None, None])
               & (ys < ry[:, None, None] + room_size))
    d = agent_dir.long()
    d1x = (d == 0).long() - (d == 2).long()
    d1y = (d == 1).long() - (d == 3).long()
    vx, vy = xs - ax[:, None, None], ys - ay[:, None, None]
    ahead = vx * d1x[:, None, None] + vy * d1y[:, None, None]
    # d2 = (-d1y, d1x)
    side = -vx * d1y[:, None, None] + vy * d1x[:, None, None]
    by_loc = torch.stack([side < 0, side > 0, ahead > 0, ahead < 0], 1)
    l_ = loc.clamp(min=0)
    where_ok = by_loc.gather(1, l_[..., None, None].expand(-1, -1, W, H))
    where_ok = where_ok & in_room[:, None]
    ok &= (loc[..., None, None] < 0) | where_ok
    return ok


def _neighbours(mask):
    """(…, W, H) bool: the cells next to (a Manhattan distance of 1 from)
    a cell of ``mask`` (pos_next_to)."""
    out = torch.zeros_like(mask)
    out[..., 1:, :] |= mask[..., :-1, :]
    out[..., :-1, :] |= mask[..., 1:, :]
    out[..., :, 1:] |= mask[..., :, :-1]
    out[..., :, :-1] |= mask[..., :, 1:]
    return out


# -- the verifier --------------------------------------------------------------

class Verifier:
    """The verifiers of a batch of episodes, kept across steps: each env's
    instruction tree, its descriptors' ``obj_set`` (ids) and ``obj_poss``
    (cells), each leaf's ``preCarrying`` and done flag, each sequence
    part's done flag, the objects' ids on the grid and in the agent's hands,
    and the episode's budget."""

    def __init__(self, env: dict):
        self.env = env
        self.vocabulary = env["vocabulary"]
        self.geometry = (env["room_size"], env["num_rows"], env["num_cols"])
        self.s = None

    def reset(self, state, rows):
        """reset_verifier of the envs ``rows`` ((B,) bool) from ``state``:
        a fresh episode's layout and mission."""
        g = state["grid"]
        B, W, H, _ = g.shape
        dev = g.device
        if self.s is None:
            self.s = {
                "ids": torch.full((B, W, H), NONE, dtype=torch.long,
                                  device=dev),
                "held": torch.full((B,), NONE, dtype=torch.long, device=dev),
                "obj_set": torch.zeros((B, SLOTS, W * H + 1),
                                       dtype=torch.bool, device=dev),
                "obj_poss": torch.zeros((B, SLOTS, W, H), dtype=torch.bool,
                                        device=dev),
                "pre": torch.full((B, LEAVES), UNKNOWN, dtype=torch.long,
                                  device=dev),
                "done": torch.zeros((B, LEAVES), dtype=torch.bool,
                                    device=dev),
                "a_done": torch.zeros(B, dtype=torch.bool, device=dev),
                "b_done": torch.zeros(B, dtype=torch.bool, device=dev),
                "budget": torch.ones(B, dtype=torch.long, device=dev),
                "root": torch.zeros(B, dtype=torch.long, device=dev),
                "a_and": torch.zeros(B, dtype=torch.bool, device=dev),
                "b_and": torch.zeros(B, dtype=torch.bool, device=dev),
                "kinds": torch.full((B, LEAVES), NONE, dtype=torch.long,
                                    device=dev),
            }
        idx = torch.nonzero(rows)[:, 0]
        if idx.numel() == 0:
            return
        sub = {k: v[idx] for k, v in state.items()}
        p = _tensors(parse_tokens(sub["mission"], self.vocabulary), dev)
        n = idx.numel()
        cells = torch.arange(W * H, device=dev).reshape(W, H).expand(n, W, H)
        ids = torch.where(sub["grid"][..., 0] != M.EMPTY, cells, NONE)
        hit = match(sub["grid"], sub["agent_pos"], sub["agent_dir"],
                    p["type"], p["color"], p["loc"], self.geometry[0])
        obj_set = torch.zeros((n, SLOTS, W * H + 1), dtype=torch.bool,
                              device=dev)
        obj_set[..., :W * H] = hit.flatten(2)
        held = torch.where(sub["carrying"][:, 0] != M.EMPTY, W * H, NONE)
        new = {"ids": ids, "held": held, "obj_set": obj_set, "obj_poss": hit,
               "pre": torch.full((n, LEAVES), UNKNOWN, dtype=torch.long,
                                 device=dev),
               "done": torch.zeros((n, LEAVES), dtype=torch.bool, device=dev),
               "a_done": torch.zeros(n, dtype=torch.bool, device=dev),
               "b_done": torch.zeros(n, dtype=torch.bool, device=dev),
               "budget": budget(p["navs"], *self.geometry),
               "root": p["root"], "a_and": p["a_and"], "b_and": p["b_and"],
               "kinds": p["kinds"]}
        for k, v in new.items():
            self.s[k][idx] = v.to(self.s[k].dtype)

    def _track(self, prev, new, action):
        """The ids after the core transition: a pickup takes the front
        object's id into the hands, a drop puts it on the front cell, a
        toggled box becomes its contents (an untracked object or nothing);
        then ``update_objs_poss`` after a drop action."""
        s = self.s
        g = prev["grid"].long()
        B, W, H, _ = g.shape
        b = torch.arange(B, device=g.device)
        f = M.front(prev)
        inside = (f[:, 0] >= 0) & (f[:, 0] < W) & (f[:, 1] >= 0) & (
            f[:, 1] < H)
        fx, fy = f[:, 0].clamp(0, W - 1), f[:, 1].clamp(0, H - 1)
        was = prev["carrying"][:, 0] != M.EMPTY
        now = new["carrying"][:, 0] != M.EMPTY
        a = action.long()
        picked = inside & (a == M.PICKUP) & ~was & now
        dropped = inside & (a == M.DROP) & was & ~now
        front = g[b, fx, fy]
        box = inside & (a == M.TOGGLE) & (front[:, 0] == M.BOX)
        here = s["ids"][b, fx, fy]
        contents = torch.where(front[:, 3] != 0, W * H, NONE)
        s["ids"][b, fx, fy] = torch.where(
            picked, NONE, torch.where(dropped, s["held"],
                                      torch.where(box, contents, here)))
        s["held"] = torch.where(picked, here,
                                torch.where(dropped, NONE, s["held"]))
        # find_matching_objs(use_location=False) of every descriptor
        ids = s["ids"].clamp(min=0).flatten(1)
        tracked = s["obj_set"].gather(
            2, ids[:, None, :].expand(-1, SLOTS, -1)).reshape(B, SLOTS, W, H)
        tracked &= (s["ids"] >= 0)[:, None]
        s["obj_poss"] = torch.where((a == M.DROP)[:, None, None, None],
                                    tracked, s["obj_poss"])

    def _leaves(self, new, action):
        """(B, LEAVES) bool: each leaf's verify_action on this step, from
        its memory before the step."""
        s = self.s
        g = new["grid"].long()
        B, W, H, _ = g.shape
        b = torch.arange(B, device=g.device)
        a = action.long()
        f = M.front(new)
        inside = (f[:, 0] >= 0) & (f[:, 0] < W) & (f[:, 1] >= 0) & (
            f[:, 1] < H)
        fx, fy = f[:, 0].clamp(0, W - 1), f[:, 1].clamp(0, H - 1)
        front = g[b, fx, fy]
        own = s["obj_set"][:, 0::2]            # (B, 4, N): each leaf's object
        poss = s["obj_poss"]
        # GoToInstr: the front cell is one of obj_poss
        goto = inside[:, None] & poss[b, 0::2, fx, fy]
        # OpenInstr: toggled, the front cell one of the doors, open now
        fid = s["ids"][b, fx, fy]
        in_set = own.gather(2, fid.clamp(min=0)[:, None, None].expand(
            -1, LEAVES, 1))[..., 0] & (fid >= 0)[:, None]
        opened = (inside & (a == M.TOGGLE) & (front[:, 0] == M.DOOR)
                  & (front[:, 2] == M.OPEN))[:, None] & in_set
        # PickupInstr: nothing held at its last call, one of its objects
        # held now
        held = s["held"]
        holds = own.gather(2, held.clamp(min=0)[:, None, None].expand(
            -1, LEAVES, 1))[..., 0] & (held >= 0)[:, None]
        pickup = (a == M.PICKUP)[:, None] & (s["pre"] == NONE) & holds
        # PutNextInstr: the object held at its last call is one of its
        # objects, now on the grid next to a cell of the second's obj_poss
        pre = s["pre"]
        was_own = own.gather(2, pre.clamp(min=0)[..., None])[..., 0] & (
            pre >= 0)
        at = s["ids"][:, None] == pre[..., None, None]      # (B, 4, W, H)
        near = (_neighbours(at) & poss[:, 1::2]).flatten(2).any(-1)
        putnext = (a == M.DROP)[:, None] & was_own & near
        kinds = s["kinds"]
        return torch.where(kinds == GOTO, goto, torch.where(
            kinds == OPEN, opened, torch.where(
                kinds == PICKUP, pickup, (kinds == PUTNEXT) & putnext)))

    def step(self, prev, new, action):
        """The verifier after the transition ``prev`` -> ``new``: (B,)
        bool, the instruction done. ``instrs.verify(action)`` through the
        tree: an action leaf; an "and" verifies each child not yet done;
        "before" verifies part A until it is done, then part B, on the same
        step as A ends; "after" the other way round."""
        self._track(prev, new, action)
        s = self.s
        res = self._leaves(new, action)
        done = s["done"]
        called = torch.zeros_like(done)
        root = s["root"]

        def part(k, is_and, gate):
            g0 = gate & ~done[:, k]
            g1 = gate & is_and & ~done[:, k + 1]
            called[:, k] |= g0
            called[:, k + 1] |= g1
            done[:, k] |= g0 & res[:, k]
            done[:, k + 1] |= g1 & res[:, k + 1]
            return done[:, k] & (~is_and | done[:, k + 1])

        single = part(0, root == AND, (root == ACTION) | (root == AND))
        before, after = root == BEFORE, root == AFTER
        gate = before & ~s["a_done"]
        s["a_done"] |= gate & part(0, s["a_and"], gate)
        gate = before & s["a_done"] & ~s["b_done"]
        s["b_done"] |= gate & part(2, s["b_and"], gate)
        gate = after & ~s["b_done"]
        s["b_done"] |= gate & part(2, s["b_and"], gate)
        gate = after & s["b_done"] & ~s["a_done"]
        s["a_done"] |= gate & part(0, s["a_and"], gate)
        # PickupInstr and PutNextInstr keep what the hands held at each call
        s["pre"] = torch.where(called, s["held"][:, None], s["pre"])
        seq = s["a_done"] & s["b_done"]
        return torch.where((root == ACTION) | (root == AND), single,
                           (before | after) & seq)


def step(verifier: Verifier, state, action, reward_dtype=torch.float32):
    """One step of the level: the core transition, the verifier, the
    reward ``1 - 0.9 * step_count / max_steps`` on success (BabyAI's
    rounding order, each operation in ``reward_dtype``) and truncation at
    the env's own budget. An env whose step count is 0 starts its
    episode's verifier here. Returns (new state, reward, terminated,
    truncated)."""
    fresh = state["step_count"] == 0
    if verifier.s is None:
        fresh = torch.ones_like(fresh)
    if bool(fresh.any()):
        verifier.reset(state, fresh)
    new, reward, terminated, _ = M.step(state, action, 1 << 30, reward_dtype)
    success = verifier.step(state, new, action)
    ms = verifier.s["budget"]
    sc = new["step_count"].to(reward_dtype)
    r = (1 - 0.9 * sc / ms.to(reward_dtype)).to(reward_dtype).to(
        torch.float32)
    reward = torch.where(success, r, reward)
    return new, reward, terminated | success, new["step_count"] >= ms


# -- layouts -------------------------------------------------------------------

def layout_faults(state, env: dict):
    """(B,) count of what breaks a LevelGen layout at its start (and a
    staggered start's step count): the room lattice of grey walls with
    doors only on the walls between rooms, at most one a wall and at most
    one of them locked; the locked room has that door alone, and a key of
    its colour lies outside it; every room reachable through doors; keys,
    balls and empty boxes inside the rooms, ``num_dists`` of them and the
    key; the agent on an empty cell of a room other than the locked one,
    facing an empty cell or a wall, carrying nothing; a mission that parses
    with each descriptor of a type its verb takes, matching an object from
    the agent's pose with the article its count takes ("a" where more than
    one); ``validate_instrs``; the step count below the env's budget."""
    g = state["grid"].long()
    B, W, H, _ = g.shape
    dev = g.device
    rs, R, Cc = env["room_size"], env["num_rows"], env["num_cols"]
    faults = torch.zeros(B, dtype=torch.long, device=dev)
    if W != (rs - 1) * Cc + 1 or H != (rs - 1) * R + 1:
        return faults + 1
    if B == 0:
        return faults
    typ, color, st = g[..., 0], g[..., 1], g[..., 2]
    xs, ys = _coords(W, H, dev)
    lattice = (xs % (rs - 1) == 0) | (ys % (rs - 1) == 0)
    cross = (xs % (rs - 1) == 0) & (ys % (rs - 1) == 0)
    border = (xs == 0) | (ys == 0) | (xs == W - 1) | (ys == H - 1)
    wall = (g == torch.tensor(M.WALL_CELL, device=dev)).all(-1)
    door = ((typ == M.DOOR) & (color <= M.GREY) & (g[..., 3:] == 0).all(-1)
            & ((st == M.CLOSED) | (st == M.LOCKED)))
    faults += (lattice & ~wall & ~(door & ~cross & ~border)).flatten(
        1).sum(1)
    obj = (((typ == M.KEY) | (typ == M.BALL) | (typ == M.BOX))
           & (color <= M.GREY) & (g[..., 2:] == 0).all(-1))
    empty = (g == torch.tensor(M.EMPTY_CELL, device=dev)).all(-1)
    faults += (~lattice & ~obj & ~empty).flatten(1).sum(1)
    locked = door & (st == M.LOCKED)
    n_locked = locked.flatten(1).sum(1)
    faults += (n_locked > 1).long()
    faults += (obj.flatten(1).sum(1) != env["num_dists"] + n_locked).long()

    # the walls between rooms: one door slot each; room r = j * Cc + i
    walls = []   # (mask of the wall's cells, room, neighbour)
    for j in range(R):
        for i in range(Cc):
            x0, y0 = i * (rs - 1), j * (rs - 1)
            if i + 1 < Cc:
                m = (xs == x0 + rs - 1) & (ys > y0) & (ys < y0 + rs - 1)
                walls.append((m, j * Cc + i, j * Cc + i + 1))
            if j + 1 < R:
                m = (ys == y0 + rs - 1) & (xs > x0) & (xs < x0 + rs - 1)
                walls.append((m, j * Cc + i, (j + 1) * Cc + i))
    n_rooms = R * Cc
    adj = torch.eye(n_rooms, dtype=torch.bool, device=dev).repeat(B, 1, 1)
    doors_of = torch.zeros((B, n_rooms), dtype=torch.long, device=dev)
    locked_wall = []
    for m, r0, r1 in walls:
        n = (door & m).flatten(1).sum(1)
        faults += (n > 1).long()
        has = n > 0
        adj[:, r0, r1] |= has
        adj[:, r1, r0] |= has
        doors_of[:, r0] += has.long()
        doors_of[:, r1] += has.long()
        locked_wall.append(((locked & m).flatten(1).any(1), r0, r1))
    reach = adj.clone()
    for _ in range(n_rooms):
        reach = (reach.float() @ adj.float() > 0) | reach
    faults += (~reach[:, 0].all(-1)).long()
    # the locked room: the room of the locked door's wall with no other door
    locked_room = torch.full((B,), -1, dtype=torch.long, device=dev)
    for has, r0, r1 in locked_wall:
        for r in (r1, r0):
            locked_room = torch.where(has & (doors_of[:, r] == 1), r,
                                      locked_room)
    faults += ((n_locked > 0) & (locked_room < 0)).long()
    room_x = xs // (rs - 1)
    room_y = ys // (rs - 1)
    room_id = (room_y.clamp(max=R - 1) * Cc + room_x.clamp(max=Cc - 1))
    in_locked = (room_id[None] == locked_room[:, None, None]) & ~lattice
    lock_color = torch.where(locked, color, -1).flatten(1).max(1).values
    key_out = (obj & (typ == M.KEY) & (color == lock_color[:, None, None])
               & ~in_locked).flatten(1).any(1)
    faults += ((n_locked > 0) & ~key_out).long()

    # the agent
    b = torch.arange(B, device=dev)
    ax, ay = state["agent_pos"][:, 0].long(), state["agent_pos"][:, 1].long()
    axc, ayc = ax.clamp(0, W - 1), ay.clamp(0, H - 1)
    ok = ((ax >= 0) & (ax < W) & (ay >= 0) & (ay < H)
          & empty[b, axc, ayc] & ~lattice[axc, ayc] & ~in_locked[b, axc, ayc])
    d = state["agent_dir"].long()
    ok &= (d >= 0) & (d <= 3)
    f = M.front({"agent_pos": state["agent_pos"], "agent_dir": d % 4})
    ahead = M.get_cells(state["grid"], f[:, 0], f[:, 1]).long()
    ok &= (ahead[:, 0] == M.EMPTY) | (ahead[:, 0] == M.WALL)
    ok &= (state["carrying"].long() == torch.tensor(M.EMPTY_CELL,
                                                    device=dev)).all(-1)
    faults += (~ok).long()

    # the mission
    missions = parse_tokens(state["mission"], env["vocabulary"])
    faults += torch.tensor([m is None for m in missions], dtype=torch.long,
                           device=dev)
    p = _tensors(missions, dev)
    hit = match(state["grid"], state["agent_pos"], d % 4, p["type"],
                p["color"], p["loc"], rs)
    count_h = hit.flatten(2).sum(-1).cpu().tolist()         # (B, SLOTS)
    lock_colors = (locked[..., None] & (color[..., None] == torch.arange(
        6, device=dev))).flatten(1, 2).any(1).cpu().tolist()  # (B, 6)
    extra = []
    for e, m in enumerate(missions):
        bad = 0
        if m is not None:
            for slot, kind, second in m.used_slots():
                t_, c_, _, plural = m.descs[slot]
                n = count_h[e][slot]
                bad += int(n == 0) + int(plural != (n > 1))
                if kind == OPEN:
                    bad += int(t_ != M.DOOR)
                elif kind != GOTO and not second:
                    bad += int(t_ == M.DOOR)
                if env["unblocking"] and t_ == M.KEY and (
                        any(lock_colors[e]) if c_ < 0 else lock_colors[e][c_]):
                    bad += 1
        extra.append(bad)
    faults += torch.tensor(extra, dtype=torch.long, device=dev)
    # validate_instrs of each put next: no object of both descriptors, no
    # object to move already next to one of the second's
    kinds = p["kinds"]
    for k in range(LEAVES):
        move, fixed = hit[:, 2 * k], hit[:, 2 * k + 1]
        bad = ((move & fixed).flatten(1).any(1)
               | (move & _neighbours(fixed)).flatten(1).any(1))
        faults += ((kinds[:, k] == PUTNEXT) & bad).long()
    own = budget(p["navs"], rs, R, Cc)
    sc = state["step_count"].long()
    faults += ((sc < 0) | (sc >= own)).long()
    return faults
