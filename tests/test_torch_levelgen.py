"""The port's LevelGen levels (minigrid_tpu_torch/envs/babyai/core/
levelgen.py) against the JAX package by distribution: GoToSeqS5R2, the
smallest registered LevelGen configuration, 1000 levels a side, chi-square
of the instruction's structure, descriptors, budget and layout (p > 1e-3).
Its own file: the JAX generator's compile takes ~40 s on the CPU."""

from __future__ import annotations

import numpy as np
import pytest

import minigrid_tpu_torch
from minigrid_tpu_torch.core import constants as C

from tests.torch_port_utils import (share_cpu,  # noqa: F401
                                    CPU, categories, chi2_same_distribution,
                                    export, jax_layouts)

pytestmark = pytest.mark.usefixtures("share_cpu")

LEVEL = "BabyAI-GoToSeqS5R2-v0"
N = 1000


def _features(st):
    ex = {k: v.numpy() for k, v in st.extra.items()}
    g = st.grid.numpy()
    H = g.shape[2]
    kinds = ex["instr.kinds"]
    return {"root": ex["instr.root_kind"], "a_and": ex["instr.a_is_and"],
            "b_and": ex["instr.b_is_and"],
            "n_leaves": (kinds != 4).sum(1), "max_steps": ex["max_steps"],
            "type0": ex["instr.descs.type"][:, 0],
            "color0": ex["instr.descs.color"][:, 0],
            "count0": np.minimum(ex["instr.descs.count"][:, 0], 4),
            "n_doors": (g[..., 0] == C.DOOR).sum((1, 2)),
            "n_objs": np.isin(g[..., 0], [C.KEY, C.BALL, C.BOX]).sum((1, 2)),
            "agent": st.agent_pos.numpy()[:, 0] * H
            + st.agent_pos.numpy()[:, 1] // 4 * 4,
            "dir": st.agent_dir.numpy()}


def test_levelgen_distribution_matches_jax():
    _, jst = jax_layouts(LEVEL, N, seed=2)
    jst = export(jst)
    penv = minigrid_tpu_torch.make(LEVEL, device=CPU).packed()
    pst = penv._gen_grid(penv.generator(2), N)
    jf, pf = _features(jst), _features(pst)
    jf["mission"], pf["mission"] = categories(
        jst.mission.numpy()[:, :4], pst.mission.numpy()[:, :4])
    for k in jf:
        p = chi2_same_distribution(jf[k], pf[k])
        assert p > 1e-3, (k, p)
