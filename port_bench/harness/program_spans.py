"""The program's own spans in a traced run, for the per-layer metrics'
readers.

The program records spans at its layer boundaries
(``minigrid_tpu_torch/utils/trace.py``) while a ``torch.profiler`` session
runs, so the traced window turns them on with no change to the drivers. The
records are taken once per run, and a reading keeps only the trees of the
cell's last ``profiled_steps`` roots of the name its reader gives
(``train_step`` for a train step's metric, ``env.step`` for a vector
step's) that opened after the run started: spans that an earlier run or a
test left in the same process never count. Where the program has no spans,
or left fewer such trees, the reading is None.
"""

from __future__ import annotations

CACHE = "_program_spans"


def _trees(run, root: str):
    """(the trees' count, their records with each one's ancestors' names),
    or None."""
    try:
        from minigrid_tpu_torch.utils import trace
    except ImportError:
        return None
    k = run.cell["traffic"].get("profiled_steps")
    if not k:
        return None
    recs = trace.records()
    since = run.t_start * 1e9  # the spans' clock is perf_counter's
    roots = [r.id for r in recs
             if r.parent is None and r.name == root and r.start_ns >= since]
    if len(roots) < k:
        return None
    keep = set(roots[-k:])
    parent = {r.id: r.parent for r in recs}
    name = {r.id: r.name for r in recs}
    kept = []
    for r in recs:
        up, p = [], r.id
        while parent.get(p) is not None:
            p = parent[p]
            up.append(name.get(p))
        if p in keep:
            kept.append((r, frozenset(up)))
    return k, kept


def _cached(run, root: str):
    cache = vars(run).setdefault(CACHE, {})
    if root not in cache:
        cache[root] = _trees(run, root)
    return cache[root]


def per_root_ms(run, root: str, name: str, inside: str | None = None,
                self_time: bool = False):
    """Host milliseconds of the spans ``name`` per tree of the root
    ``root`` (a train step, a vector step): inclusive, or with
    ``self_time`` less their child spans'; with ``inside`` only the spans
    that opened under a span of that name. None where the kept trees hold
    no such span."""
    got = _cached(run, root)
    if got is None:
        return None
    k, kept = got
    child_ns = {}
    for r, _ in kept:
        if r.parent is not None:
            child_ns[r.parent] = (child_ns.get(r.parent, 0)
                                  + r.end_ns - r.start_ns)
    ns, found = 0, False
    for r, up in kept:
        if r.name != name or (inside is not None and inside not in up):
            continue
        found = True
        ns += r.end_ns - r.start_ns
        if self_time:
            ns -= child_ns.get(r.id, 0)
    return ns / 1e6 / k if found else None


def per_call_us(run, root: str, name: str):
    """Host microseconds of one call of the spans ``name`` in the kept
    trees of the root ``root``, or None where there is none."""
    got = _cached(run, root)
    if got is None:
        return None
    spans = [r for r, _ in got[1] if r.name == name]
    if not spans:
        return None
    return sum(r.end_ns - r.start_ns for r in spans) / len(spans) / 1e3
