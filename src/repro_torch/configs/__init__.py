"""Architecture registry: the 10 assigned architectures (+ smoke variants).

``get_config(name)`` / ``get_smoke_config(name)`` resolve by arch id.
"""

from __future__ import annotations

import importlib

from .base import (
    LONG_500K,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    SHAPES,
    SSDConfig,
    ShapeConfig,
    shape_applicable,
)

ARCHS: tuple[str, ...] = (
    "mamba2_780m",
    "jamba_1p5_large_398b",
    "deepseek_v3_671b",
    "granite_moe_1b_a400m",
    "musicgen_medium",
    "qwen1p5_110b",
    "olmo_1b",
    "qwen3_0p6b",
    "yi_6b",
    "internvl2_2b",
)

#: public --arch ids (dashes) → module names
ALIASES = {
    "mamba2-780m": "mamba2_780m",
    "jamba-1.5-large-398b": "jamba_1p5_large_398b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "musicgen-medium": "musicgen_medium",
    "qwen1.5-110b": "qwen1p5_110b",
    "olmo-1b": "olmo_1b",
    "qwen3-0.6b": "qwen3_0p6b",
    "yi-6b": "yi_6b",
    "internvl2-2b": "internvl2_2b",
}


def _module(name: str):
    mod_name = ALIASES.get(name, name.replace("-", "_").replace(".", "p"))
    if mod_name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ALIASES)}")
    return importlib.import_module(f".{mod_name}", __package__)


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).SMOKE_CONFIG


def all_archs() -> list[str]:
    return list(ALIASES.keys())


__all__ = [
    "ARCHS",
    "ALIASES",
    "ModelConfig",
    "MoEConfig",
    "MLAConfig",
    "SSDConfig",
    "ShapeConfig",
    "SHAPES",
    "LONG_500K",
    "get_config",
    "get_smoke_config",
    "all_archs",
    "shape_applicable",
]
