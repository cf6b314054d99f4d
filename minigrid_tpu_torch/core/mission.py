"""Mission strings as fixed-shape token arrays.

The port's own copy of the JAX package's vocabulary and tokenizer
(``minigrid_tpu/core/mission.py``): the first 51 words reproduce the
reference ``DictObservationSpaceWrapper`` word order (ids offset by 1,
0 = padding), the tail adds the BabyAI surface-form words. The word list must
stay identical to the JAX package's, since token ids are observations.
"""

from __future__ import annotations

import numpy as np

from minigrid_tpu_torch.core.types import MISSION_LEN

_REFERENCE_WORDS = (
    ["red", "green", "blue", "yellow", "purple", "grey"]
    + [
        "unseen", "empty", "wall", "floor", "box", "key", "ball", "door",
        "goal", "agent", "lava",
    ]
    + [
        "pick", "avoid", "get", "find", "put", "use", "open", "go", "fetch",
        "reach", "unlock", "traverse",
    ]
    + [
        "up", "the", "a", "at", ",", "square", "and", "then", "to", "of",
        "rooms", "near", "opening", "must", "you", "matching", "end",
        "hallway", "object", "from", "room", "maze",
    ]
)

_EXTRA_WORDS = [
    "next", "on", "your", "left", "right", "in", "front", "behind", "after",
    "side", "what", "is",
]

WORDS: list[str] = _REFERENCE_WORDS + _EXTRA_WORDS
assert len(WORDS) == len(set(WORDS))

WORD_TO_ID = {w: i + 1 for i, w in enumerate(WORDS)}
ID_TO_WORD = {i + 1: w for i, w in enumerate(WORDS)}
VOCAB_SIZE = len(WORDS) + 1


def tokenize(mission: str, length: int = MISSION_LEN) -> np.ndarray:
    """Host-side: mission string -> padded int32 id vector."""
    mission = mission.replace(",", " , ")
    ids = [WORD_TO_ID[w] for w in mission.split()]
    if len(ids) > length:
        raise ValueError(f"mission too long ({len(ids)}): {mission!r}")
    out = np.zeros(length, dtype=np.int32)
    out[: len(ids)] = ids
    return out


def detokenize(tokens) -> str:
    """Host-side: id vector -> mission string (inverse of tokenize)."""
    words = [ID_TO_WORD[int(t)] for t in np.asarray(tokens) if int(t) != 0]
    return " ".join(words).replace(" , ", ", ")


def mission_table(missions: list[str],
                  length: int = MISSION_LEN) -> np.ndarray:
    """(N, length) table of tokenized missions, for categorical sampling."""
    return np.stack([tokenize(m, length) for m in missions])
