"""Gymnasium adapter: the reference's class API over the batched port.

Counterpart of ``minigrid_tpu/compat/gym_env.py``. Lets reference-Minigrid
users switch with one import: ``GymnasiumAdapter`` implements the ``gym.Env``
contract with the reference's observation dict (image / direction /
mission-string), render modes and metadata
(``minigrid/minigrid_env.py:24-117,741-789``), backed by a batch of one env
of the port on the given device (the card unless ``device="cpu"``). Every
reset and step is one call of the batched env: on the card, the fused
kernel's entries.

``reset(seed=n)`` seeds a ``torch.Generator`` on the env's device with ``n``
(``env.generator(n)``): the layout and every step's keys come from it, so
the same seed gives the same episode. It is not the layout JAX's
``PRNGKey(n)`` gives.

Imports ``gymnasium`` (and ``pygame`` to render to a window), which
``minigrid_tpu_torch/__init__.py`` does not import.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

import gymnasium as gym
from gymnasium import spaces

from minigrid_tpu_torch import registry
from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.envs.base import random_keys
from minigrid_tpu_torch.render import get_frame


class GymnasiumAdapter(gym.Env):
    metadata = {"render_modes": ["human", "rgb_array"], "render_fps": 10}

    def __init__(self, env_or_id, render_mode: str | None = None,
                 screen_size: int | None = 640, highlight: bool = True,
                 tile_size: int = C.TILE_PIXELS, agent_pov: bool = False,
                 device=None, **env_kwargs):
        self.env = (registry.make(env_or_id, device=device, **env_kwargs)
                    if isinstance(env_or_id, str) else env_or_id)

        self.reward_range = getattr(self.env, "reward_range", (0, 1))

        self.render_mode = render_mode
        self.screen_size = screen_size
        self.highlight = highlight
        self.tile_size = tile_size
        self.agent_pov = agent_pov

        self._state = None
        self._gen = None
        self._np_seed = None
        self._build_runtime()

    def _build_runtime(self):
        """(Re)build the members that are not pickled: pygame handles and
        the gym spaces (whose MissionSpace holds the env's mission
        function). Mirrors the reference contract that every env pickles
        (reference tests/test_envs.py:180-195)."""
        p = self.env.params
        self.action_space = spaces.Discrete(self.env.num_actions)
        image_space = spaces.Box(0, 255, (p.view_size, p.view_size, 3),
                                 dtype="uint8")
        self.observation_space = spaces.Dict({
            "image": image_space,
            "direction": spaces.Discrete(4),
            "mission": self.env.mission_space(),
        })
        self.window = None
        self.clock = None

    def __getstate__(self):
        d = self.__dict__.copy()
        for k in ("window", "clock", "observation_space", "action_space"):
            d.pop(k, None)
        # the spaces are rebuilt, but their np_random generators are
        # carried so space.seed(n) state survives, as the reference's
        # wholesale space pickling does
        d["_space_rngs"] = {
            "action": getattr(self.action_space, "_np_random", None),
            "observation": getattr(self.observation_space, "_np_random", None),
            "subspaces": {
                k: getattr(s, "_np_random", None)
                for k, s in self.observation_space.spaces.items()
            },
        }
        # tensors and the generator's state go through the host, so the
        # payload loads on a machine without the device
        if self._state is not None:
            d["_state"] = self._state.map(lambda x: x.cpu())
        if self._gen is not None:
            d["_gen"] = self._gen.get_state()
        return d

    def __setstate__(self, d):
        rngs = d.pop("_space_rngs", None)
        self.__dict__.update(d)
        dev = self.env.device
        if self._state is not None:
            self._state = self._state.map(lambda x: x.to(dev))
        if self._gen is not None:
            self._gen = torch.Generator(device=dev).set_state(self._gen)
        self._build_runtime()
        if rngs:
            if rngs["action"] is not None:
                self.action_space._np_random = rngs["action"]
            if rngs["observation"] is not None:
                self.observation_space._np_random = rngs["observation"]
            for k, r in rngs["subspaces"].items():
                if r is not None and k in self.observation_space.spaces:
                    self.observation_space.spaces[k]._np_random = r

    # -- reference-style introspection ----------------------------------
    @property
    def unwrapped(self):
        return self

    @property
    def agent_pos(self):
        return tuple(self._state.agent_pos[0].tolist())

    @property
    def agent_dir(self) -> int:
        return int(self._state.agent_dir[0])

    @property
    def carrying(self):
        cell = self._state.carrying[0].tolist()
        if cell[0] == C.EMPTY:
            return None
        return (C.IDX_TO_OBJECT[cell[0]], C.IDX_TO_COLOR[cell[1]])

    @property
    def step_count(self) -> int:
        return int(self._state.step_count[0])

    @property
    def max_steps(self) -> int:
        extra = self._state.extra if self._state is not None else None
        if extra is not None and "max_steps" in extra:
            return int(extra["max_steps"][0])
        return self.env.params.max_steps

    @property
    def mission(self) -> str:
        return self.env.mission_text(self._state)

    @property
    def width(self) -> int:
        return self.env.params.width

    @property
    def height(self) -> int:
        return self.env.params.height

    def encode_grid(self) -> np.ndarray:
        """(W, H, 3) symbolic grid (the reference ``grid.encode()``)."""
        return self._state.grid[0, ..., :3].cpu().numpy()

    def hash(self, size: int = 16) -> str:
        """State fingerprint (minigrid_env.py:159-169)."""
        import hashlib

        sample_hash = hashlib.sha256()
        for item in [self.encode_grid().tolist(), self.agent_pos,
                     self.agent_dir]:
            sample_hash.update(str(item).encode("utf8"))
        return sample_hash.hexdigest()[:size]

    @property
    def steps_remaining(self) -> int:
        return self.max_steps - self.step_count

    # -- gym API ---------------------------------------------------------
    def _obs_to_host(self, obs) -> dict[str, Any]:
        return {
            "image": obs["image"][0].cpu().numpy(),
            "direction": int(obs["direction"][0]),
            "mission": self.mission,
        }

    def reset(self, *, seed: int | None = None,
              options: dict | None = None):
        super().reset(seed=seed)
        if seed is not None:
            self._np_seed = seed
        n = (self._np_seed if self._np_seed is not None
             else int(self.np_random.integers(0, 2**31 - 1)))
        self._np_seed = None
        self._gen = self.env.generator(n)
        obs, self._state = self.env.reset(self._gen, 1)
        if self.render_mode == "human":
            self.render()
        return self._obs_to_host(obs), {}

    def step(self, action):
        dev = self.env.device
        keys = random_keys(self._gen, (1, 2), dev)
        act = torch.tensor([int(action)], dtype=torch.int32, device=dev)
        obs, self._state, reward, term, trunc, _ = self.env.step(
            keys, self._state, act)
        if self.render_mode == "human":
            self.render()
        return (self._obs_to_host(obs), float(reward[0]), bool(term[0]),
                bool(trunc[0]), {})

    def get_frame(self, highlight: bool = True,
                  tile_size: int = C.TILE_PIXELS, agent_pov: bool = False):
        return get_frame(self.env.params, self._state, highlight=highlight,
                         tile_size=tile_size,
                         agent_pov=agent_pov)[0].cpu().numpy()

    def render(self):
        img = self.get_frame(self.highlight, self.tile_size, self.agent_pov)
        if self.render_mode == "human":
            self._render_human(img)
        elif self.render_mode == "rgb_array":
            return img

    def _render_human(self, img):
        """Pygame window loop (minigrid_env.py:744-782)."""
        import pygame
        import pygame.freetype

        img = np.transpose(img, axes=(1, 0, 2))
        if self.window is None:
            pygame.init()
            pygame.display.init()
            self.window = pygame.display.set_mode(
                (self.screen_size, self.screen_size))
            pygame.display.set_caption("minigrid-tpu")
        if self.clock is None:
            self.clock = pygame.time.Clock()
        surf = pygame.surfarray.make_surface(img)
        offset = surf.get_size()[0] * 0.1
        bg = pygame.Surface(
            (int(surf.get_size()[0] + offset), int(surf.get_size()[1] + offset)))
        bg.convert()
        bg.fill((255, 255, 255))
        bg.blit(surf, (offset / 2, 0))
        bg = pygame.transform.smoothscale(
            bg, (self.screen_size, self.screen_size))
        font_size = 22
        text = self.mission
        font = pygame.freetype.SysFont(
            pygame.font.get_default_font(), font_size)
        text_rect = font.get_rect(text, size=font_size)
        text_rect.center = bg.get_rect().center
        text_rect.y = bg.get_height() - font_size * 1.5
        font.render_to(bg, text_rect, text, size=font_size)
        self.window.blit(bg, (0, 0))
        pygame.event.pump()
        self.clock.tick(self.metadata["render_fps"])
        pygame.display.flip()

    def close(self):
        if self.window:
            import pygame

            pygame.quit()


def gym_make(env_id: str, **kwargs) -> GymnasiumAdapter:
    """Reference-style construction: ``gym_make("MiniGrid-Empty-8x8-v0",
    device="cpu")``; without ``device`` the env runs on the card."""
    return GymnasiumAdapter(env_id, **kwargs)
