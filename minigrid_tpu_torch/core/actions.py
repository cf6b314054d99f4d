"""The 7-action discrete space (reference minigrid/core/actions.py:7-20)."""

from __future__ import annotations

from enum import IntEnum


class Actions(IntEnum):
    left = 0
    right = 1
    forward = 2
    pickup = 3
    drop = 4
    toggle = 5
    done = 6


NUM_ACTIONS = len(Actions)
