"""Architecture config registry: ``get_config(name)`` / ``--arch <id>``."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.configs.shapes import SHAPES, ShapeConfig, applicable_shapes

_ARCH_MODULES = {
    "qwen2.5-3b": "repro_torch.configs.qwen2_5_3b",
    "nemotron-4-15b": "repro_torch.configs.nemotron_4_15b",
    "gemma3-1b": "repro_torch.configs.gemma3_1b",
    "granite-3-8b": "repro_torch.configs.granite_3_8b",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2_7b",
    "musicgen-large": "repro_torch.configs.musicgen_large",
    "internvl2-76b": "repro_torch.configs.internvl2_76b",
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b_a400m",
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "mamba2-780m": "repro_torch.configs.mamba2_780m",
}
# archs of the port alone: no JAX counterpart to hold them to, so
# ``list_archs`` (what the JAX-held tests take) leaves them out
_PORT_ONLY = {
    "zamba2-7b-instruct": "repro_torch.configs.zamba2_7b_instruct",
}


def list_archs() -> list:
    return sorted(_ARCH_MODULES)


def get_config(name: str) -> ArchConfig:
    mod = _ARCH_MODULES.get(name) or _PORT_ONLY.get(name)
    if mod is None:
        raise KeyError(f"unknown arch {name!r}; available: "
                       f"{sorted(_ARCH_MODULES) + sorted(_PORT_ONLY)}")
    return importlib.import_module(mod).CONFIG


__all__ = [
    "ArchConfig",
    "MoEConfig",
    "SHAPES",
    "ShapeConfig",
    "applicable_shapes",
    "get_config",
    "list_archs",
]
