"""PutNextLocal's reference semantics: the core step and the put-next
verifier, the level's layouts (:mod:`reference.babyai`)."""

import torch

from reference import babyai as BA


class Family:
    def __init__(self, env: dict):
        self.env = env
        self.max_steps = BA.budget(env["room_size"])
        if env["max_steps"] != self.max_steps:
            raise ValueError(f"max_steps {env['max_steps']}: the level's "
                             f"budget is {self.max_steps}")

    def step(self, state, action, reward_dtype=torch.float32):
        return BA.step(state, action, self.env["vocabulary"], self.max_steps,
                       reward_dtype)

    def layout_faults(self, state):
        return BA.layout_faults(state, self.env["vocabulary"],
                                self.env["size"], self.env["num_objs"])
