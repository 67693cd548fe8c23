"""Architecture registry: ``--arch <id>`` lookup for every assigned config,
and the assigned input shapes with the one shape-bucketing rule
(:mod:`.shapes`, a copy of the reference's).

Each architecture lives in its own module with a ``FULL`` (exact public
config) and ``SMOKE`` (reduced same-family config for CPU tests) variant,
as in the reference. Arch modules are imported lazily (first
``get_config`` call): they pull in ``repro_torch.models`` and therefore
torch, while the shape tables serve the census planner and the serving
oracle, which must not pay the model stack's import.
"""

from typing import TYPE_CHECKING, Dict, List

from .shapes import ARCH_SKIPS, LONG_CONTEXT_ARCHS, SHAPES, SKIPS, ShapeSpec, bucket_bounds, cells, shape_bucket

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.models.config import ModelConfig

_MODULES = {
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "gemma2-27b": "gemma2_27b",
    "command-r-plus-104b": "command_r_plus_104b",
    "qwen3-14b": "qwen3_14b",
    "granite-8b": "granite_8b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "whisper-tiny": "whisper_tiny",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "mamba2-1.3b": "mamba2_1_3b",
    "deepseek-v2-lite": "deepseek_v2_lite",
    "kimi-linear-48b-a3b": "kimi_linear_48b_a3b",
}

ARCH_NAMES: List[str] = list(_MODULES)


def get_config(name: str, smoke: bool = False) -> "ModelConfig":
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    import importlib

    mod = importlib.import_module(f".{_MODULES[name]}", __name__)
    return mod.SMOKE if smoke else mod.FULL


def all_configs(smoke: bool = False) -> Dict[str, "ModelConfig"]:
    return {n: get_config(n, smoke) for n in ARCH_NAMES}


__all__ = [
    "ARCH_NAMES",
    "ARCH_SKIPS",
    "LONG_CONTEXT_ARCHS",
    "SHAPES",
    "SKIPS",
    "ShapeSpec",
    "all_configs",
    "bucket_bounds",
    "cells",
    "get_config",
    "shape_bucket",
]
