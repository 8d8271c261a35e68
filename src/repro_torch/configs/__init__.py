"""Assigned architecture configs (exact published hyperparameters) and
reduced smoke variants for CPU tests.

Every config cites its source; see per-module docstrings.  ``get_config(id)``
returns the full config, ``get_smoke_config(id)`` a structurally identical
but tiny variant (same block type, same features, small dims).
"""
from __future__ import annotations

import dataclasses

from ..models.config import SHAPES, ModelConfig, ShapeConfig  # noqa: F401

from . import (
    granite_4_0_h_small,
    granite_moe_1b,
    hymba_1_5b,
    mamba2_1_3b,
    phi3_vision_4_2b,
    phi35_moe_42b,
    qwen2_0_5b,
    qwen3_0_6b,
    qwen3_14b,
    starcoder2_7b,
    whisper_medium,
)

_MODULES = {
    "hymba-1.5b": hymba_1_5b,
    "qwen3-0.6b": qwen3_0_6b,
    "qwen2-0.5b": qwen2_0_5b,
    "qwen3-14b": qwen3_14b,
    "starcoder2-7b": starcoder2_7b,
    "phi3.5-moe-42b-a6.6b": phi35_moe_42b,
    "granite-moe-1b-a400m": granite_moe_1b,
    "whisper-medium": whisper_medium,
    "phi-3-vision-4.2b": phi3_vision_4_2b,
    "mamba2-1.3b": mamba2_1_3b,
    # the port's own, beyond the reference's ten
    "granite-4.0-h-small": granite_4_0_h_small,
}

ARCHS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; options: {ARCHS}")
    return _MODULES[arch].CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _MODULES[arch].SMOKE


def shape_cells(arch: str) -> list[str]:
    """The live dry-run shape cells for this arch (documented skips removed)."""
    cfg = get_config(arch)
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    # long_500k only for sub-quadratic archs (SSM state / sliding window)
    if cfg.block in ("mamba2", "hymba"):
        cells.append("long_500k")
    return cells


def scale_down(cfg: ModelConfig, **overrides) -> ModelConfig:
    return dataclasses.replace(cfg, **overrides)
