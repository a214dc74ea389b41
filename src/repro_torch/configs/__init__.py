"""Architecture registry.

``get_config(name)`` returns the full-size assigned config; every module
``repro_torch.configs.<id>`` exports ``CONFIG``. ``REGISTRY`` maps arch id -> config.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    ArchConfig, MoEConfig, SSMConfig, ShapeConfig, SHAPES, shapes_for,
)

ARCH_IDS = (
    "musicgen_medium",
    "zamba2_2p7b",
    "internlm2_1p8b",
    "qwen3_8b",
    "h2o_danube3_4b",
    "starcoder2_7b",
    "qwen2_vl_2b",
    "rwkv6_1p6b",
    "qwen3_moe_30b_a3b",
    "kimi_k2_1t_a32b",
)

_ALIASES = {
    "musicgen-medium": "musicgen_medium",
    "zamba2-2.7b": "zamba2_2p7b",
    "internlm2-1.8b": "internlm2_1p8b",
    "qwen3-8b": "qwen3_8b",
    "h2o-danube-3-4b": "h2o_danube3_4b",
    "starcoder2-7b": "starcoder2_7b",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "rwkv6-1.6b": "rwkv6_1p6b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
}


def get_config(name: str) -> ArchConfig:
    key = _ALIASES.get(name, name).replace("-", "_")
    if key not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{key}")
    return mod.CONFIG


def all_configs() -> dict:
    return {a: get_config(a) for a in ARCH_IDS}
