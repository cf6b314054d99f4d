"""BossLevel's reference semantics: the core step, LevelGen's instruction
tree and verifier with each env's own budget, and LevelGen's layouts
(:mod:`reference.levelgen`). The verifier's progress lives in the
instance: it follows one batch step after step, and starts an env's
episode wherever its step count is 0 (and for every env at the first
step)."""

import torch

from reference import levelgen as LG

MAX_NAVS = 8  # four leaves, each a put next


class Family:
    def __init__(self, env: dict):
        self.env = env
        self.max_steps = LG.budget(MAX_NAVS, env["room_size"],
                                   env["num_rows"], env["num_cols"])
        if env["max_steps"] != self.max_steps:
            raise ValueError(f"max_steps {env['max_steps']}: the level's "
                             f"largest budget is {self.max_steps}")
        self.verifier = LG.Verifier(env)

    def step(self, state, action, reward_dtype=torch.float32):
        return LG.step(self.verifier, state, action, reward_dtype)

    def layout_faults(self, state):
        return LG.layout_faults(state, self.env)
