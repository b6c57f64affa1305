# Port copy of src/repro/configs/__init__.py: data only, logic unchanged.
"""Architecture config registry: ``--arch <id>`` resolution.

Each module exports CONFIG (the exact published config) and SMOKE (a reduced
same-family variant that runs one forward/train step on CPU)."""
from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig, ShapeCell, SHAPES, SHAPES_BY_NAME, cells_for

from repro_torch.configs import (
    qwen2_vl_7b, granite_20b, phi4_mini_3_8b, deepseek_coder_33b, qwen2_7b,
    mixtral_8x7b, grok_1_314b, falcon_mamba_7b, zamba2_2_7b, whisper_medium,
)

_MODULES = {
    "qwen2-vl-7b": qwen2_vl_7b,
    "granite-20b": granite_20b,
    "phi4-mini-3.8b": phi4_mini_3_8b,
    "deepseek-coder-33b": deepseek_coder_33b,
    "qwen2-7b": qwen2_7b,
    "mixtral-8x7b": mixtral_8x7b,
    "grok-1-314b": grok_1_314b,
    "falcon-mamba-7b": falcon_mamba_7b,
    "zamba2-2.7b": zamba2_2_7b,
    "whisper-medium": whisper_medium,
}

ARCH_IDS = tuple(_MODULES)
CONFIGS = {k: m.CONFIG for k, m in _MODULES.items()}
SMOKES = {k: m.SMOKE for k, m in _MODULES.items()}


def get_config(arch_id: str, smoke: bool = False) -> ArchConfig:
    table = SMOKES if smoke else CONFIGS
    if arch_id not in table:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(table)}")
    return table[arch_id]
