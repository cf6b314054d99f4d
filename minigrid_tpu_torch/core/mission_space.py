"""MissionSpace — Gymnasium space over instruction strings.

The port's own copy of ``minigrid_tpu/core/mission_space.py`` (no JAX in
it). Functional re-implementation of the reference ``MissionSpace``
(``minigrid/core/mission.py:14-199``): a space whose samples are mission
strings produced by ``mission_func(*placeholders)`` with each placeholder
drawn uniformly from its candidate list; ``contains`` reverse-parses a
string against the placeholder lists, handling overlapping candidates by
trying every consistent assignment.
"""

from __future__ import annotations

import itertools
from typing import Callable

import numpy as np

try:
    from gymnasium import spaces as _spaces

    _Base = _spaces.Space
except ImportError:  # gymnasium is optional: a plain base class then
    _Base = object


class ConstantMission:
    """Picklable zero-argument mission_func returning a fixed string
    (lambda closures cannot cross process boundaries, and vectorized
    gymnasium workers pipe the observation space — so the built-in spaces
    use these callables instead)."""

    def __init__(self, text: str):
        self.text = text

    def __call__(self) -> str:
        return self.text


class TemplateMission:
    """Picklable mission_func substituting its arguments into a ``{}``
    format template."""

    def __init__(self, template: str, n_args: int):
        self.template = template
        self.n_args = n_args

    def __call__(self, *args) -> str:
        return self.template.format(*args)


class MissionSpace(_Base):
    def __init__(self, mission_func: Callable[..., str],
                 ordered_placeholders: list[list[str]] | None = None,
                 seed=None):
        if ordered_placeholders is not None:
            n_args = getattr(mission_func, "n_args", None)
            if n_args is None:
                n_args = mission_func.__code__.co_argcount
            assert len(ordered_placeholders) == n_args
            for placeholders in ordered_placeholders:
                assert len(placeholders) == len(set(placeholders))
        self.ordered_placeholders = ordered_placeholders
        self.mission_func = mission_func
        if _Base is not object:
            super().__init__(dtype=str, seed=seed)
        # sanity check (reference mission.py:61-64)
        sampled = self.sample()
        assert isinstance(sampled, str)

    def sample(self, mask=None, probability=None) -> str:
        if self.ordered_placeholders is None:
            return self.mission_func()
        rng = getattr(self, "np_random", None) or np.random.default_rng()
        picks = [
            placeholders[rng.integers(0, len(placeholders))]
            for placeholders in self.ordered_placeholders
        ]
        return self.mission_func(*picks)

    def _template(self):
        """Split ``mission_func``'s output into literal segments around the
        placeholder slots by realizing it once with sentinel tokens.

        Returns ``(segments, slot_args)`` where the template reads
        ``segments[0] + <slot_0> + segments[1] + <slot_1> + ...`` and
        ``slot_args[j]`` is the ``ordered_placeholders`` index bound by
        slot ``j`` (an argument may appear multiple times or not at all).
        Returns ``None`` when the function does not pass its arguments
        through verbatim — it raises on the sentinels, or it branches /
        post-processes so that substituting real candidates into the
        sentinel-derived template does not reproduce its output — in which
        case ``contains`` falls back to exhausting the candidate product.
        The result is cached: it depends only on constructor arguments."""
        if hasattr(self, "_template_cache"):
            return self._template_cache
        self._template_cache = self._compute_template()
        return self._template_cache

    def _compute_template(self):
        n = len(self.ordered_placeholders)
        sentinels = [f"\x00{i}\x00" for i in range(n)]
        try:
            template = self.mission_func(*sentinels)
        except Exception:
            return None
        segments, slot_args = [], []
        pos = 0
        while True:
            hits = [
                (template.find(s, pos), i)
                for i, s in enumerate(sentinels)
                if template.find(s, pos) != -1
            ]
            if not hits:
                segments.append(template[pos:])
                break
            at, arg = min(hits)
            segments.append(template[pos:at])
            slot_args.append(arg)
            pos = at + len(sentinels[arg])

        # self-check against realizations: a mission_func that branches on
        # its argument values produces sentinel output that does not
        # describe the real realizations. Probe every candidate of every
        # slot at least once (paired with the first candidate of the other
        # slots) so a branch on a *middle* candidate is caught too.
        if any(not cands for cands in self.ordered_placeholders):
            return None  # before the probe build: c[0] would raise
        probes = [[c[0] for c in self.ordered_placeholders]]
        for i, cands in enumerate(self.ordered_placeholders):
            for c in cands[1:]:
                args = [cl[0] for cl in self.ordered_placeholders]
                args[i] = c
                probes.append(args)
        for args in probes:
            rebuilt = segments[0]
            for j, arg in enumerate(slot_args):
                rebuilt += args[arg] + segments[j + 1]
            try:
                if self.mission_func(*args) != rebuilt:
                    return None
            except Exception:
                return None
        return segments, slot_args

    def contains(self, x) -> bool:
        """Reverse-parse ``x`` against the placeholder lists — the analog of
        the reference's span analysis (``minigrid/core/mission.py:80-163``):
        match the literal template segments, then at each placeholder slot
        try only the candidates that actually occur at that position
        (backtracking handles overlapping candidates), binding repeated
        arguments consistently."""
        if not isinstance(x, str):
            return False
        if self.ordered_placeholders is None:
            return x == self.mission_func()
        tpl = self._template()
        if tpl is None:  # non-pass-through mission_func: exhaustive fallback
            return any(
                self.mission_func(*combo) == x
                for combo in itertools.product(*self.ordered_placeholders)
            )
        segments, slot_args = tpl

        def match(slot: int, pos: int, bound: dict) -> bool:
            seg = segments[slot]
            if not x.startswith(seg, pos):
                return False
            pos += len(seg)
            if slot == len(slot_args):
                return pos == len(x)
            arg = slot_args[slot]
            if arg in bound:
                cands = [bound[arg]]
            else:
                cands = self.ordered_placeholders[arg]
            for c in cands:
                if x.startswith(c, pos) and match(
                    slot + 1, pos + len(c), {**bound, arg: c}
                ):
                    return True
            return False

        return match(0, 0, {})

    def __eq__(self, other) -> bool:
        if not isinstance(other, MissionSpace):
            return False
        if (self.ordered_placeholders is None) != (
                other.ordered_placeholders is None):
            return False
        if self.ordered_placeholders is None:
            return self.mission_func() == other.mission_func()
        if [sorted(p) for p in self.ordered_placeholders] != [
                sorted(p) for p in other.ordered_placeholders]:
            return False
        test = [p[0] for p in self.ordered_placeholders]
        return self.mission_func(*test) == other.mission_func(*test)

    def __repr__(self) -> str:
        return f"MissionSpace({self.mission_func}, {self.ordered_placeholders})"


class BabyAIMissionSpace(MissionSpace):
    """Catch-all mission space for the combinatorial BabyAI instruction
    grammar (reference envs/babyai/core/roomgrid_level.py:27-43): missions
    are generated by the level sampler, not enumerable placeholders, so
    ``contains`` accepts any string."""

    def __init__(self):
        super().__init__(mission_func=ConstantMission("go"))

    def contains(self, x) -> bool:
        return isinstance(x, str)
