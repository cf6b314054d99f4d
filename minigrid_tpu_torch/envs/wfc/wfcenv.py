"""WFC maze environment (reference minigrid/envs/wfc/wfcenv.py:30-283).

Counterpart of ``minigrid_tpu/envs/wfc/wfcenv.py``, batched. Per reset: the
batched WFC solver (``solver.py``) on the preset's pattern catalog ->
black/white layouts -> the largest connected empty-cell component of each
(the reference's networkx pipeline, wfcenv.py:240-269, becomes a min-label
flood) -> agent and goal at random distinct component cells -> the boundary
wall ring. The env has no step hooks: on the card it steps through the
fused kernel's broadcast-row entry like any core-dynamics family.
"""

from __future__ import annotations

import numpy as np
import torch

from minigrid_tpu_torch.core import constants as C
from minigrid_tpu_torch.core import grid as G
from minigrid_tpu_torch.core.types import EnvParams
from minigrid_tpu_torch.envs import common as X
from minigrid_tpu_torch.envs.base import MiniGridEnv, random_keys
from minigrid_tpu_torch.envs.envdoc import env_doc
from minigrid_tpu_torch.envs.wfc import patterns as P
from minigrid_tpu_torch.envs.wfc import solver as S
from minigrid_tpu_torch.envs.wfc.config import WFC_PRESETS_ALL, WFCConfig

FLOOD_ROUND = 16  # flood passes between two convergence tests (host syncs)


def largest_component(empty: torch.Tensor) -> torch.Tensor:
    """(B, H, W) bool mask of each env's largest 4-connected True
    component. The min-label flood of JAX's ``largest_component``, batched,
    tested for convergence every :data:`FLOOD_ROUND` passes (a pass at the
    fixpoint changes nothing; one counted host sync a test); the label
    sizes by ``scatter_add``, the INF bucket zeroed, the first largest."""
    B, H, W = empty.shape
    INF = H * W
    idx = torch.arange(H * W, dtype=torch.int32, device=empty.device)
    labels = torch.where(empty, idx.reshape(H, W), INF)
    pad = torch.full((B, H + 2, W + 2), INF, dtype=torch.int32,
                     device=empty.device)

    def flood(lab):
        pad[:, 1:-1, 1:-1] = lab
        best = torch.minimum(
            torch.minimum(pad[:, :-2, 1:-1], pad[:, 2:, 1:-1]),
            torch.minimum(pad[:, 1:-1, :-2], pad[:, 1:-1, 2:]))
        return torch.where(empty, torch.minimum(lab, best), INF)

    while True:
        before = labels
        for _ in range(FLOOD_ROUND):
            labels = flood(labels)
        S.COUNTERS.host_syncs += 1
        if torch.equal(labels, before):
            break
    flat = labels.reshape(B, -1).to(torch.int64)
    sizes = torch.zeros((B, H * W + 1), dtype=torch.int32,
                        device=empty.device).scatter_add_(
        1, flat, empty.reshape(B, -1).to(torch.int32))
    sizes[:, INF] = 0
    biggest = sizes.argmax(1)
    return labels == biggest[:, None, None]


def _uniform_cell(generator, mask):
    """(B,) int64 flat index of a uniform True cell of each (B, N) mask;
    where a mask has none, uniform over all N cells (JAX's categorical over
    equal -1e9 logits)."""
    mask = torch.where(mask.any(1, keepdim=True), mask, True)
    u = torch.rand(mask.shape, generator=generator, device=mask.device)
    return torch.where(mask, u, -1.0).argmax(1)


class WFCEnv(MiniGridEnv):
    name = "WFC"
    __doc__ = env_doc(
        """
        Every reset synthesizes a fresh maze with Wave Function Collapse:
        local patterns extracted from a small template image are tiled
        into a new layout that is locally consistent with the template,
        then the largest connected region is kept and start/goal cells are
        placed inside it. 22 preset pattern catalogs ship with the
        framework (6 of them registered as ids); heuristics, backtracking
        and global constraints are configurable via ``WFCConfig``.
        Reference: minigrid/envs/wfc/wfcenv.py and wfclogic/.
        """,
        '"traverse the maze to get to the goal"',
        used=(0, 1, 2),
        termination=("The agent reaches the goal.",
                     "Timeout (see `max_steps`)."),
        configurations="""
        Registered ids select a preset, e.g.
        ``MiniGrid-WFC-MazeSimple-v0``; every shipped preset is available
        through ``WFCEnv(wfc_config=...)``.
        """,
    )

    PATTERN_COLOR_CONFIG = {"wall": 0, "empty": 255}

    def __init__(self, wfc_config: WFCConfig | str = "MazeSimple", size=25,
                 ensure_connected=True, max_steps=None, device=None, **kw):
        self.config = (wfc_config if isinstance(wfc_config, WFCConfig)
                       else WFC_PRESETS_ALL[wfc_config])
        if size < 3:
            raise ValueError(f"Grid size must be at least 3 (currently {size})")
        if max_steps is None:
            max_steps = size * 20
        super().__init__(EnvParams(width=size, height=size,
                                   max_steps=max_steps, **kw), device=device)
        self.ensure_connected = ensure_connected
        self.max_attempts = 64

        pats, weights, tiles = P.build_catalog(
            self.config.image, self.config.pattern_width,
            self.config.rotations, self.config.input_periodic)
        self._patterns = pats
        self._weights = weights
        self._adj = P.build_adjacency(pats)
        # pattern -> wall iff its top-left tile is black (wfcenv.py:227-238)
        tiles_arr = np.asarray(tiles)
        black = (tiles_arr == self.PATTERN_COLOR_CONFIG["wall"]
                 if tiles_arr.ndim == 1
                 else (tiles_arr == self.PATTERN_COLOR_CONFIG["wall"]).all(-1))
        self._is_wall = black[pats[:, 0, 0]]

    def default_mission(self) -> str:
        return "traverse the maze to get to the goal"

    def solve(self, generator: torch.Generator, num_envs: int):
        """The preset's WFC solve with retries for ``num_envs`` envs on the
        env's device: (pattern grids (B, H-2, W-2) int64 indexed [row, col],
        ok (B,) bool, attempts (B,) int64)."""
        p = self.params
        c = self.config
        return S.solve_with_retries(
            generator, self._adj, self._weights,
            (p.height - 2, p.width - 2), c.output_periodic, num_envs,
            self.max_attempts, loc_heuristic=c.loc_heuristic,
            choice_heuristic=c.choice_heuristic, backtracking=c.backtracking,
            global_constraint=c.global_constraint)

    def layout(self, generator: torch.Generator, pat_grid: torch.Tensor):
        """Reset states from solved pattern grids (B, H-2, W-2): walls, the
        largest component, start and goal, the wall ring."""
        p = self.params
        dev = self.device
        B = pat_grid.shape[0]
        rng = random_keys(generator, (B, 2), dev)
        is_wall = torch.as_tensor(self._is_wall, device=dev)
        wall = is_wall[pat_grid]                    # (B, H-2, W-2) [row, col]
        empty = ~wall
        if self.ensure_connected:
            comp = largest_component(empty)
            wall = wall | (empty & ~comp)
            empty = comp

        # random distinct start/goal on the component (wfcenv.py:271-282)
        H, W = wall.shape[1:]
        cells = empty.reshape(B, -1)
        start = _uniform_cell(generator, cells)
        goal = _uniform_cell(generator, cells & (
            torch.arange(H * W, device=dev) != start[:, None]))

        # inner layout indexed [row, col] -> grid[x=col+1, y=row+1]
        grid = G.wall_rect(G.empty_grid(B, p.width, p.height, dev), 0, 0,
                           p.width, p.height)
        inner = torch.where(wall.transpose(1, 2)[..., None],
                            torch.as_tensor(C.WALL_CELL, device=dev),
                            torch.as_tensor(C.EMPTY_CELL, device=dev))
        grid[:, 1:p.width - 1, 1:p.height - 1] = inner
        grid = G.set_cell(grid, goal % W + 1, goal // W + 1, X.GOAL_CELL)
        agent_pos = torch.stack([start % W + 1, start // W + 1], -1)
        agent_dir = X.randint(generator, 0, 4, B, dev)
        return self.make_state(grid, agent_pos, agent_dir, rng=rng)

    def _gen_grid(self, generator, num_envs):
        pat_grid, _, _ = self.solve(generator, num_envs)
        return self.layout(generator, pat_grid)
