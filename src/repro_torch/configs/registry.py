"""Registry mapping --arch ids to ArchConfig objects."""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import ArchConfig, ShapeConfig, SHAPES

_MODULES = {
    "chameleon-34b": "repro_torch.configs.chameleon_34b",
    "codeqwen1.5-7b": "repro_torch.configs.codeqwen15_7b",
    "qwen1.5-0.5b": "repro_torch.configs.qwen15_05b",
    "stablelm-12b": "repro_torch.configs.stablelm_12b",
    "starcoder2-15b": "repro_torch.configs.starcoder2_15b",
    "zamba2-2.7b": "repro_torch.configs.zamba2_27b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "grok-1-314b": "repro_torch.configs.grok1_314b",
    "whisper-large-v3": "repro_torch.configs.whisper_large_v3",
    "rwkv6-3b": "repro_torch.configs.rwkv6_3b",
}


def arch_ids() -> List[str]:
    return list(_MODULES)


def get_arch(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[name]).CONFIG


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]


def cell_is_runnable(arch: ArchConfig, shape: ShapeConfig) -> bool:
    """long_500k only runs for sub-quadratic (SSM/hybrid) archs."""
    if shape.name == "long_500k" and not arch.sub_quadratic:
        return False
    return True


def all_cells() -> List[tuple]:
    """All (arch_id, shape_name, runnable) cells — 40 total."""
    cells = []
    for a in arch_ids():
        cfg = get_arch(a)
        for s in SHAPES.values():
            cells.append((a, s.name, cell_is_runnable(cfg, s)))
    return cells
