"""DoorKey's reference semantics: upstream Minigrid's step and
``DoorKeyEnv._gen_grid``'s layouts (:mod:`reference.minigrid`)."""

import torch

from reference import minigrid as M


class Family:
    def __init__(self, env: dict):
        self.env, self.max_steps = env, env["max_steps"]

    def step(self, state, action, reward_dtype=torch.float32):
        return M.step(state, action, self.max_steps, reward_dtype)

    def layout_faults(self, state):
        return M.doorkey_layout_faults(state, self.env["size"])
