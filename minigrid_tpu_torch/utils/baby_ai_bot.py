"""BabyAI oracle solver planning from accumulated partial observations.

Counterpart of ``minigrid_tpu/utils/baby_ai_bot.py`` (the reference's
stack-machine bot, ``minigrid/utils/baby_ai_bot.py:18-1026``, with the same
knowledge contract: the bot never reads world state the agent has not
observed). It accumulates a ``seen`` mask of every cell that has been in the
agent's view cone and reads grid contents only through it; unseen cells are
unknown (not passable, not targets) and drive exploration. Box contents are
never read. Each step it replans greedily from that belief, reading which
sub-instruction is pending from the verifier's progress flags.

It is host code, as in the JAX package: numpy on one env of the port's
batched ``EnvState`` (grid ``(B, W, H, 5)`` indexed ``[x, y]``, position,
direction, carrying) and its instruction under the dotted ``extra`` keys of
:data:`INSTR_KEYS`. :func:`host_state` copies a batch to the host once a
step, and ``BabyAIBot.replan(host, b)`` plans for env ``b``. Every
tie-break is JAX's (``np.nonzero`` order, the ``DIRS`` order, the BFS
frontier order), so the same state gives the same action.

    bot = BabyAIBot(env)
    action = bot.replan(state)          # env 0 of a batched state
"""

from __future__ import annotations

import numpy as np
import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core.actions import Actions
from minigrid_tpu_torch.envs.babyai.core import instrs as I

DIRS = np.array([[1, 0], [0, 1], [-1, 0], [0, -1]])  # DIR_TO_VEC
DONE = int(Actions.done)


def world_vis_mask(types, door_states, agent_pos, agent_dir, view_size):
    """(W, H) bool: world cells inside the agent's current view cone.

    The host's copy of the observation: the affine view->world map of
    core/obs.py plus the reference's occlusion sweep
    (minigrid/core/grid.py:291-328), so the bot sees exactly what the
    observation exposes.
    """
    V = view_size
    W, H = types.shape
    f = DIRS[agent_dir]
    r = np.array([-f[1], f[0]])
    top_left = agent_pos + f * (V - 1) - r * (V // 2)

    vx, vy = np.meshgrid(np.arange(V), np.arange(V), indexing="ij")
    wx = top_left[0] + r[0] * vx - f[0] * vy
    wy = top_left[1] + r[1] * vx - f[1] * vy
    inb = (wx >= 0) & (wx < W) & (wy >= 0) & (wy < H)

    vtypes = np.full((V, V), C.WALL, int)
    vstates = np.zeros((V, V), int)
    vtypes[inb] = types[wx[inb], wy[inb]]
    vstates[inb] = door_states[wx[inb], wy[inb]]
    transparent = ~(
        (vtypes == C.WALL) | ((vtypes == C.DOOR) & (vstates != C.OPEN))
    )

    # the reference two-pass sweep, agent at (V//2, V-1)
    mask = np.zeros((V, V), bool)
    mask[V // 2, V - 1] = True
    for j in reversed(range(V)):
        for i in range(V - 1):
            if mask[i, j] and transparent[i, j]:
                mask[i + 1, j] = True
                if j > 0:
                    mask[i + 1, j - 1] = True
                    mask[i, j - 1] = True
        for i in reversed(range(1, V)):
            if mask[i, j] and transparent[i, j]:
                mask[i - 1, j] = True
                if j > 0:
                    mask[i - 1, j - 1] = True
                    mask[i, j - 1] = True

    out = np.zeros((W, H), bool)
    sel = mask & inb
    out[wx[sel], wy[sel]] = True
    return out


class BabyAIBot:
    def __init__(self, env):
        self.env = env
        p = env.params
        self.view_size = p.view_size
        # accumulated visibility: the bot's entire knowledge of the world
        self.seen = np.zeros((p.width, p.height), bool)
        # cells where we parked a wrong/blocking object; the unblock router
        # must not pick these up again (prevents pickup/drop livelock)
        self._parked: list[tuple] = []

    # ------------------------------------------------------------------
    def replan(self, state, b: int = 0) -> int:
        """Next action for env ``b`` of a batched ``EnvState``, or of a
        :func:`host_state` copy of one."""
        host = state if isinstance(state, dict) else host_state(state)
        s = _Snapshot(host, b, self.seen)
        self.seen |= world_vis_mask(
            s.types, s.types_state, s.agent_pos, s.agent_dir, self.view_size
        )
        s.seen = self.seen
        leaf = self._pending_leaf(s)
        if leaf is None:
            return DONE
        act = self._plan_leaf(s, leaf)
        if act is None:
            act = self._explore(s)
        if act is None:
            act = DONE
        return act

    # ------------------------------------------------------------------
    def _pending_leaf(self, s):
        """First incomplete leaf in the verifier's required order."""
        instr = s.instr
        root = int(instr.root_kind)
        done = np.asarray(instr.leaf_done)
        kinds = np.asarray(instr.kinds)

        def pending(indices):
            for i in indices:
                if kinds[i] != I.UNUSED and not done[i]:
                    return i
            return None

        if root == I.ROOT_ACTION:
            return pending([0])
        if root == I.ROOT_AND:
            return pending([0, 1])
        a_first = root == I.ROOT_BEFORE
        first = [0, 1] if a_first else [2, 3]
        second = [2, 3] if a_first else [0, 1]
        leaf = pending(first)
        return leaf if leaf is not None else pending(second)

    # ------------------------------------------------------------------
    def _plan_leaf(self, s, i):
        """Action for leaf i, or None when no progress is possible with
        current knowledge (caller falls back to exploration)."""
        kind = int(s.instr.kinds[i])
        W = s.seen.shape[0]
        def unpack(row):
            return I.unpack_mask(torch.from_numpy(row), W).numpy()

        move_mask = unpack(s.instr.descs.mask_objs[2 * i]) & s.seen
        move_carried = bool(s.instr.descs.carried[2 * i])
        if kind == I.GOTO:
            targets = unpack(s.instr.descs.mask_poss[2 * i]) & s.seen
            if not targets.any():
                return None
            return self._go_adjacent(s, targets)
        if kind == I.OPEN:
            if not move_mask.any():
                return None
            return self._plan_open(s, move_mask)
        if kind == I.PICKUP:
            return self._plan_pickup(s, move_mask, move_carried)
        if kind == I.PUTNEXT:
            fixed_mask = unpack(s.instr.descs.mask_poss[2 * i + 1]) & s.seen
            return self._plan_putnext(s, move_mask, move_carried, fixed_mask)
        return None

    # ------------------------------------------------------------------
    def _plan_open(self, s, doors_mask, _depth=0):
        pos, d = self._nearest(s, doors_mask)
        if pos is None:
            return self._go_adjacent(s, doors_mask, _depth=_depth)
        dx, dy = pos
        door_state = s.types_state[dx, dy]
        color = s.colors[dx, dy]
        blocker = self._door_blocker(s, (dx, dy))
        if blocker is not None:
            act = self._clear_cell(s, blocker)
            if act is not None:
                return act
        if door_state == C.LOCKED:
            if not (s.carrying[0] == C.KEY and s.carrying[1] == color):
                act = self._fetch_key(s, color, _depth=_depth)
                if act is not None:
                    return act
                return None  # key unknown: explore before toggling in vain
        # walk next to the door and toggle
        target = np.zeros_like(doors_mask)
        target[dx, dy] = True
        return self._go_adjacent(s, target, then=Actions.toggle,
                                 _depth=_depth)

    def _plan_pickup(self, s, mask, carried):
        if carried:
            return DONE
        if not mask.any():
            return None
        # a carried item (e.g. the key that opened the way) is kept until we
        # stand at the target, then parked next to it (the reference bot's
        # drop-before-pickup, baby_ai_bot.py:282-292)
        return self._go_adjacent(s, mask, then=Actions.pickup,
                                 allow_unblock=True, require_free_hands=True)

    def _plan_putnext(self, s, move_mask, move_carried, fixed_mask):
        carrying_move = move_carried and s.carrying[0] != C.EMPTY
        if not carrying_move:
            if not move_mask.any():
                return None
            return self._go_adjacent(s, move_mask, then=Actions.pickup,
                                     allow_unblock=True,
                                     require_free_hands=True)
        if not fixed_mask.any():
            return None
        # carrying the move object: find an empty cell adjacent to a fixed
        # object and drop into it
        drop_targets = self._adjacent_empty(s, fixed_mask)
        return self._go_adjacent(s, drop_targets, then=Actions.drop,
                                 targets_are_empty=True)

    # ------------------------------------------------------------------
    # exploration (reference ExploreSubgoal, baby_ai_bot.py:490-546)
    # ------------------------------------------------------------------
    def _explore(self, s):
        """Move toward the nearest unseen cell; unseen cells adjacent to a
        reachable seen cell are the exploration frontier."""
        unseen = ~s.seen
        if unseen.any():
            act = self._go_adjacent(s, unseen, allow_unblock=True)
            if act is not None:
                return act
        # map exhausted from here: open any reachable closed/locked door
        # (reference :522-544 falls back to opening doors)
        doors = (s.types == C.DOOR) & (s.types_state != C.OPEN) & s.seen
        if doors.any():
            return self._plan_open(s, doors, _depth=1)
        return None

    # ------------------------------------------------------------------
    # primitive planners
    # ------------------------------------------------------------------
    def _fetch_key(self, s, color, _depth=0):
        """Action working towards holding the key of ``color``; None when no
        seen key (or key-holding box candidate) is known."""
        if s.carrying[0] == C.KEY and s.carrying[1] == color:
            return None
        keys = (s.types == C.KEY) & (s.colors == color) & s.seen
        if keys.any():
            return self._go_adjacent(s, keys, then=Actions.pickup,
                                     allow_unblock=True, _depth=_depth,
                                     require_free_hands=True)
        if self._exploration_possible(s):
            return None  # reachable unexplored map: look for the key first
        # exploration exhausted (remaining unseen cells, if any, sit behind
        # locked doors) and no key on the floor: search inside boxes
        # (contents are unobservable; opening reveals them)
        boxes = (s.types == C.BOX) & s.seen
        if boxes.any():
            if s.carrying[0] != C.EMPTY:
                act = self._drop_somewhere(s)
                if act is not None:
                    return act
            return self._go_adjacent(s, boxes, then=Actions.toggle,
                                     _depth=_depth)
        return None

    def _exploration_possible(self, s):
        """True while exploring (without new keys) can still reveal cells:
        an unseen cell borders a cell the agent can actually traverse, or
        a traversable CLOSED (unlocked) door may hide one. When only locked
        doors remain, key search must move on to boxes (prevents the
        hidden-key deadlock where the locked room itself holds every
        unseen cell). BFS marks door/object cells it cannot expand
        through, so reach is intersected with true passability."""
        dist = self._bfs(s, allow_unblock=True)
        reach = (dist >= 0) & self._passable(s, allow_unblock=True)
        reach[tuple(s.agent_pos)] = True
        unseen = ~s.seen
        W, H = unseen.shape
        near_reach = np.zeros_like(reach)
        for d in DIRS:
            xs, ys = np.nonzero(reach)
            nx, ny = xs + d[0], ys + d[1]
            ok = (nx >= 0) & (nx < W) & (ny >= 0) & (ny < H)
            near_reach[nx[ok], ny[ok]] = True
        if (near_reach & unseen).any():
            return True
        closed = (s.types == C.DOOR) & (s.types_state == C.CLOSED) & s.seen
        return bool((closed & near_reach).any())

    def _door_blocker(self, s, door_pos):
        """The carryable object barring access to the door, or None.

        An adjacent object only *blocks* when the agent cannot already
        stand next to the door: if any known-free door-adjacent cell is
        reachable, the door is approachable and nothing needs clearing
        (the reference bot's GoNextToSubgoal blocker handling,
        baby_ai_bot.py:536-560, likewise clears only the cell it must
        step onto)."""
        reach = self._reachable_cells(s)
        blocker = None
        for d in DIRS:
            n = (door_pos[0] + d[0], door_pos[1] + d[1])
            if n == tuple(s.agent_pos):
                return None  # already standing next to the door
            if not s.in_bounds(n) or not s.seen[n]:
                continue
            t = s.types[n]
            if t == C.EMPTY and reach[n]:
                return None  # a free approach cell exists — not blocked
            if blocker is None and t in (C.BALL, C.BOX, C.KEY) and reach[n]:
                blocker = n
        return blocker

    def _clear_cell(self, s, cell):
        """Pick up the object at ``cell`` and drop it elsewhere."""
        if s.carrying[0] != C.EMPTY:
            act = self._drop_somewhere(s, avoid=[cell])
            if act is not None:
                return act
        target = np.zeros_like(s.types, bool)
        target[cell] = True
        return self._go_adjacent(s, target, then=Actions.pickup)

    def _drop_somewhere(self, s, avoid=None):
        """Drop the carried object on a free neighbor, preferring side/back
        cells so a just-cleared blocker is not dropped back onto the path
        (the reference bot's _find_drop_pos heuristic,
        baby_ai_bot.py:865-...)."""
        candidates = []
        for face in range(4):  # absolute order -> stable turn target
            n = tuple(s.agent_pos + DIRS[face])
            if not s.in_bounds(n) or not s.seen[n] or s.types[n] != C.EMPTY:
                continue
            if avoid is not None:
                avoid_cells = ([tuple(avoid)] if not isinstance(avoid, list)
                               else [tuple(a) for a in avoid])
                if n in avoid_cells:
                    continue
            candidates.append((face, n))
        if candidates:
            # prefer dropping straight ahead when allowed
            front = [c for c in candidates if c[0] == s.agent_dir]
            face, cell = front[0] if front else candidates[0]
            if face == s.agent_dir:
                self._parked.append(cell)
                self._parked = self._parked[-8:]
                return int(Actions.drop)
            return self._turn_towards(s, face)
        empty = (s.types == C.EMPTY) & s.seen
        return self._go_adjacent(s, empty, then=Actions.drop,
                                 targets_are_empty=True)

    def _adjacent_empty(self, s, mask):
        out = np.zeros_like(mask)
        W, H = mask.shape
        for d in DIRS:
            sh = np.zeros_like(mask)
            xs, ys = np.nonzero(mask)
            nx, ny = xs + d[0], ys + d[1]
            ok = (nx >= 0) & (nx < W) & (ny >= 0) & (ny < H)
            sh[nx[ok], ny[ok]] = True
            out |= sh
        return out & (s.types == C.EMPTY) & s.seen

    def _nearest(self, s, mask):
        """Nearest True cell reachable-adjacent to the agent, by BFS dist."""
        dist = self._bfs(s)
        best, best_d = None, None
        for x, y in zip(*np.nonzero(mask)):
            dmin = None
            for d in DIRS:
                n = (x + d[0], y + d[1])
                if s.in_bounds(n) and dist[n] >= 0:
                    dmin = dist[n] if dmin is None else min(dmin, dist[n])
            if dmin is not None and (best_d is None or dmin < best_d):
                best, best_d = (x, y), dmin
        return best, best_d

    def _passable(self, s, allow_unblock=False):
        t = s.types
        ok = (t == C.EMPTY) | (t == C.GOAL) | (t == C.FLOOR)
        open_door = (t == C.DOOR) & (s.types_state == C.OPEN)
        closed_door = (t == C.DOOR) & (s.types_state == C.CLOSED)
        ok |= open_door | closed_door
        # locked doors passable when we hold the matching key
        if s.carrying[0] == C.KEY:
            ok |= (t == C.DOOR) & (s.types_state == C.LOCKED) \
                & (s.colors == s.carrying[1])
        if allow_unblock and s.carrying[0] == C.EMPTY:
            unblockable = (t == C.BALL) | (t == C.KEY) | (t == C.BOX)
            for cell in self._parked:
                unblockable[cell] = False
            ok |= unblockable
        return ok & s.seen  # unknown cells are never passable

    def _bfs(self, s, allow_unblock=False):
        """Distance field from the agent over passable SEEN cells (-1 =
        unreachable). Unblock-passable cells terminate expansion."""
        ok = self._passable(s, allow_unblock)
        hard = self._passable(s, False)
        # mark (but do not expand through) object/door/unseen cells so
        # adjacency queries and frontier detection can see them (the
        # reference BFS marks blocking cells as reached,
        # roomgrid_level.py:272-283)
        markable = (s.types != C.WALL) | ~s.seen
        W, H = ok.shape
        dist = -np.ones((W, H), np.int32)
        ax, ay = s.agent_pos
        dist[ax, ay] = 0
        frontier = [(ax, ay)]
        while frontier:
            nxt = []
            for x, y in frontier:
                for d in DIRS:
                    n = (x + d[0], y + d[1])
                    if s.in_bounds(n) and dist[n] < 0 and markable[n]:
                        dist[n] = dist[x, y] + 1
                        if ok[n]:
                            nxt.append(n)
            frontier = nxt
        return dist

    def _reachable_cells(self, s):
        return self._bfs(s) >= 0

    def _go_adjacent(self, s, targets, then=None, allow_unblock=False,
                     targets_are_empty=False, _depth=0,
                     require_free_hands=False):
        """Move toward standing next to (and facing) any target cell; when
        already facing one, emit ``then`` (or ``done`` for pure goto).
        Returns None when unreachable with current knowledge."""
        if _depth > 4:
            return None
        if not targets.any():
            return None
        if require_free_hands and s.carrying[0] != C.EMPTY:
            # park the carried item once we are next to the target
            adjacent_targets = [
                tuple(s.agent_pos + DIRS[f]) for f in range(4)
                if s.in_bounds(tuple(s.agent_pos + DIRS[f]))
                and targets[tuple(s.agent_pos + DIRS[f])]
            ]
            if adjacent_targets:
                act = self._drop_somewhere(s, avoid=adjacent_targets)
                if act is not None:
                    return act
        fwd = tuple(s.agent_pos + DIRS[s.agent_dir])
        if s.in_bounds(fwd) and targets[fwd]:
            if then is not None:
                return int(then)
            return DONE

        # goal cells: any cell from which a target is in front
        dist = self._bfs(s, allow_unblock)
        best = None  # (dist, stand_cell, face_dir)
        hard_pass = self._passable(s, False)
        for x, y in zip(*np.nonzero(targets)):
            for di, d in enumerate(DIRS):
                stand = (x - d[0], y - d[1])
                if not s.in_bounds(stand):
                    continue
                if dist[stand] < 0:
                    continue
                # must be able to STAND there (hard-passable or current pos)
                if not (hard_pass[stand] or stand == tuple(s.agent_pos)):
                    continue
                cand = (dist[stand], stand, di)
                if best is None or cand[0] < best[0]:
                    best = cand
        if best is None:
            # target unreachable: a seen door on the frontier must be
            # opened first (the reference's OpenSubgoal key-fetch planning,
            # baby_ai_bot.py:169-263)
            if _depth > 3:
                return None
            reach = self._reachable_cells(s)
            shut = (s.types == C.DOOR) & (s.types_state != C.OPEN) & s.seen
            frontier_doors = np.zeros_like(shut)
            for x, y in zip(*np.nonzero(shut)):
                for d in DIRS:
                    n = (x + d[0], y + d[1])
                    if s.in_bounds(n) and reach[n]:
                        frontier_doors[x, y] = True
            if not frontier_doors.any():
                return None
            # prefer a door we can open right now (closed, or locked with
            # its key in hand or in seen reach) — resolves chained unlocks
            openable = np.zeros_like(frontier_doors)
            for x, y in zip(*np.nonzero(frontier_doors)):
                if s.types_state[x, y] != C.LOCKED:
                    openable[x, y] = True
                    continue
                color = s.colors[x, y]
                if s.carrying[0] == C.KEY and s.carrying[1] == color:
                    openable[x, y] = True
                    continue
                keys = (s.types == C.KEY) & (s.colors == color) & s.seen
                for kx, ky in zip(*np.nonzero(keys)):
                    if reach[kx, ky]:
                        openable[x, y] = True
                        break
            pick = openable if openable.any() else frontier_doors
            return self._plan_open(s, pick, _depth=_depth + 1)
        _, stand, face = best

        if stand == tuple(s.agent_pos):
            # rotate towards the target
            return self._turn_towards(s, face)

        # first step along a shortest path to `stand`
        step = self._first_step(s, dist, stand, allow_unblock)
        if step is None:
            return None
        return self._advance(s, step)

    def _first_step(self, s, dist, goal, allow_unblock):
        """Backtrack the BFS field from goal to adjacent-to-agent cell.

        Intermediate steps must be cells BFS actually expanded through
        (``ok``): the field also assigns distances to marked-but-blocking
        cells (objects, doors — see _bfs), and a naive dist-1 descent can
        run the chain through one, yielding a "first step" onto an object
        the agent cannot enter — _advance then bails and the bot
        deadlocks emitting ``done``. Every marked cell's BFS parent is
        expandable, so restricting the descent keeps it complete; the
        goal cell itself may still be a blocking cell (door to toggle,
        object to unblock-pick) when the path length is 1."""
        cur = goal
        ok = self._passable(s, allow_unblock)
        guard = 0
        while dist[cur] > 1 and guard < 10000:
            guard += 1
            for d in DIRS:
                n = (cur[0] - d[0], cur[1] - d[1])
                if (s.in_bounds(n) and dist[n] == dist[cur] - 1
                        and ok[n]):
                    cur = n
                    break
            else:
                return None
        return cur if dist[cur] == 1 else None

    def _turn_towards(self, s, face_dir):
        diff = (face_dir - s.agent_dir) % 4
        if diff == 0:
            return int(Actions.forward)  # unreachable in practice
        if diff == 3:
            return int(Actions.left)
        return int(Actions.right)

    def _advance(self, s, cell):
        """Action moving into adjacent ``cell`` (turn / open door / unblock
        / forward)."""
        delta = (cell[0] - s.agent_pos[0], cell[1] - s.agent_pos[1])
        face = int(np.argmax((DIRS == np.asarray(delta)).all(1)))
        if face != s.agent_dir:
            return self._turn_towards(s, face)
        t = s.types[cell]
        if t == C.DOOR and s.types_state[cell] != C.OPEN:
            return int(Actions.toggle)
        if t in (C.BALL, C.KEY, C.BOX):
            if s.carrying[0] == C.EMPTY:
                return int(Actions.pickup)
            return None
        return int(Actions.forward)


# the instruction entries of EnvState.extra that the bot reads
INSTR_KEYS = ("instr.root_kind", "instr.kinds", "instr.leaf_done",
              "instr.descs.mask_objs", "instr.descs.mask_poss",
              "instr.descs.carried")
_CORE_KEYS = ("grid", "agent_pos", "agent_dir", "carrying")


def host_state(state) -> dict:
    """The fields the bot reads, for every env of a batched ``EnvState``,
    as numpy arrays (batch-leading): one device-to-host copy of the whole
    batch."""
    tensors = [getattr(state, k) for k in _CORE_KEYS] + [
        state.extra[k] for k in INSTR_KEYS]
    B = state.batch_size
    flat = torch.cat([t.reshape(B, -1).to(torch.int32) for t in tensors],
                     1).cpu().numpy()
    out, i = {}, 0
    for k, t in zip(_CORE_KEYS + INSTR_KEYS, tensors):
        n = t[0].numel()
        out[k] = flat[:, i:i + n].reshape(t.shape)
        i += n
    return out


class _Instr:
    """One env's instruction fields, as the JAX ``InstrState`` names them."""

    def __init__(self, host, b):
        self.root_kind = host["instr.root_kind"][b]
        self.kinds = host["instr.kinds"][b]
        self.leaf_done = host["instr.leaf_done"][b].astype(bool)
        self.descs = _Descs(host, b)


class _Descs:
    def __init__(self, host, b):
        self.mask_objs = host["instr.descs.mask_objs"][b]
        self.mask_poss = host["instr.descs.mask_poss"][b]
        self.carried = host["instr.descs.carried"][b].astype(bool)


class _Snapshot:
    """Host view of env ``b`` of a :func:`host_state`, knowledge-gated by
    the seen mask."""

    def __init__(self, host, b, seen):
        g = host["grid"][b]
        self.types = g[..., 0].astype(int)
        self.colors = g[..., 1].astype(int)
        self.types_state = g[..., 2].astype(int)
        self.agent_pos = host["agent_pos"][b]
        self.agent_dir = int(host["agent_dir"][b])
        self.carrying = host["carrying"][b].astype(int)
        self.instr = _Instr(host, b)
        self.seen = seen

    def in_bounds(self, pos):
        return (0 <= pos[0] < self.types.shape[0]
                and 0 <= pos[1] < self.types.shape[1])
