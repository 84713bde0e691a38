"""Architecture config registry: ``get_config(arch_id)`` / ``list_archs()``.

A copy of the reference's ``configs`` (same fields, same values, same
``smoke()``).  One module per assigned architecture; each exposes ``CONFIG``
(exact public dims) and ``smoke()`` (reduced same-family config for CPU
tests).
"""
from __future__ import annotations

import importlib

from .base import SHAPES, ModelConfig, ShapeCell

ARCH_IDS = (
    "granite_moe_3b_a800m",
    "qwen3_moe_235b_a22b",
    "seamless_m4t_large_v2",
    "deepseek_coder_33b",
    "h2o_danube_3_4b",
    "nemotron_4_340b",
    "yi_34b",
    "zamba2_7b",
    "rwkv6_3b",
    "llama_3_2_vision_11b",
)

_ALIAS = {a.replace("_", "-"): a for a in ARCH_IDS}


def _mod(arch_id: str):
    arch_id = _ALIAS.get(arch_id, arch_id)
    return importlib.import_module(f"repro_torch.configs.{arch_id}")


def get_config(arch_id: str) -> ModelConfig:
    return _mod(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _mod(arch_id).smoke()


def list_archs():
    return list(ARCH_IDS)


__all__ = [
    "ARCH_IDS",
    "SHAPES",
    "ModelConfig",
    "ShapeCell",
    "get_config",
    "get_smoke_config",
    "list_archs",
]
