"""WaveFunctionCollapse environments (counterpart of
``minigrid_tpu/envs/wfc``)."""

from minigrid_tpu_torch.envs.wfc.config import (
    WFC_PRESETS,
    WFC_PRESETS_ALL,
    WFC_PRESETS_INCONSISTENT,
    WFC_PRESETS_SLOW,
    WFCConfig,
    register_wfc_presets,
)
from minigrid_tpu_torch.envs.wfc.wfcenv import WFCEnv

__all__ = [
    "WFCEnv", "WFCConfig", "WFC_PRESETS", "WFC_PRESETS_ALL",
    "WFC_PRESETS_INCONSISTENT", "WFC_PRESETS_SLOW", "register_wfc_presets",
]
