"""Structured per-environment documentation composer.

The port's own copy of ``minigrid_tpu/envs/envdoc.py``: a port env class
carries the same ``__doc__`` as its JAX counterpart, so the text below,
links included, stays the JAX package's word for word.

Every reference env class carries a six-section markdown docstring
(Description / Mission Space / Action Space / Observation Encoding /
Rewards / Termination — e.g. the reference minigrid/envs/doorkey.py:10-61)
that the docs generator renders into the environment pages. Here the shared
boilerplate (the action table, the tile encoding) is composed by this
helper so the per-env files state only their actual content, and the table
stays consistent with :mod:`minigrid_tpu_torch.core.actions` by construction.
"""

from __future__ import annotations

ACTION_NAMES = ("left", "right", "forward", "pickup", "drop", "toggle",
                "done")
ACTION_DESCS = (
    "Turn left",
    "Turn right",
    "Move forward",
    "Pick up an object",
    "Drop an object",
    "Toggle/activate an object",
    "Done completing task",
)

DEFAULT_REWARD = ("A reward of `1 - 0.9 * (step_count / max_steps)` is "
                  "given on success, and `0` on failure.")

OBS_ENCODING = """\
- Each visible tile is encoded as a 3-dimensional tuple:
    `(OBJECT_IDX, COLOR_IDX, STATE)`
- The `OBJECT_TO_IDX` and `COLOR_TO_IDX` vocabularies live in
    [minigrid_tpu/core/constants.py](minigrid_tpu/core/constants.py)
    (identical integer contract to the reference's
    `minigrid/core/constants.py`)
- `STATE` is the door state: 0=open, 1=closed, 2=locked
- In this framework the observation ships as
    `{"image": (view, view, 3) uint8, "direction": int, "mission": token
    ids}`; with `EnvParams.packed_obs` the three planes arrive packed in
    one int32 lane per tile instead."""


def env_doc(description: str, mission: str, *, used=(0, 1, 2),
            termination=("Timeout (see `max_steps`).",),
            rewards: str = DEFAULT_REWARD, mission_notes: str = "",
            configurations: str = "", num_actions: int = 7) -> str:
    """Compose the six-section env docstring."""
    from inspect import cleandoc

    description = cleandoc(description)
    mission = cleandoc(mission)
    if mission_notes:
        mission_notes = cleandoc(mission_notes)
    if configurations:
        configurations = cleandoc(configurations)
    rewards = cleandoc(rewards)
    rows = []
    for i in range(num_actions):
        desc = ACTION_DESCS[i] if i in set(used) else "Unused"
        rows.append(f"| {i}   | {ACTION_NAMES[i]:<12} | {desc} |")
    table = ("| Num | Name         | Action |\n"
             "|-----|--------------|--------|\n" + "\n".join(rows))
    term = "\n".join(f"{i + 1}. {t}" for i, t in enumerate(termination))
    parts = [
        "## Description", "", description.strip(), "",
        "## Mission Space", "", mission.strip(), "",
    ]
    if mission_notes:
        parts += [mission_notes.strip(), ""]
    parts += [
        "## Action Space", "", table, "",
        "## Observation Encoding", "", OBS_ENCODING, "",
        "## Rewards", "", rewards.strip(), "",
        "## Termination", "",
        "The episode ends when any of the following happens:", "", term, "",
    ]
    if configurations:
        parts += ["## Registered Configurations", "",
                  configurations.strip(), ""]
    return "\n".join(parts)
