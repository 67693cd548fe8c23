"""Modality frontend stubs (the reference's ``models/frontend.py``): the
``[audio]``/``[vlm]`` entries specify the transformer BACKBONE only; the
frontend provides precomputed frame/patch embeddings.

The stubs define the *interface* (shapes/dtypes of the precomputed
embeddings) plus a deterministic synthetic generator so smoke tests and
examples run end to end. The generator draws from a ``torch.Generator``, so
its numbers differ from the reference's ``jax.random`` ones by design.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device import DeviceLike, resolve_device
from .config import ModelConfig
from .layers import compute_dtype, update_slice


@dataclass(frozen=True)
class VisionStubSpec:
    """LLaVA-NeXT anyres tiling: base 336px grid (24x24 patches = 576) plus
    up to 4 sub-tiles -> <= 2880 patch embeddings per image. The stub hands
    the backbone already-projected patch embeddings [n_patches, d_model]."""

    patches_per_tile: int = 576
    max_tiles: int = 5

    @property
    def max_patches(self) -> int:
        return self.patches_per_tile * self.max_tiles


@dataclass(frozen=True)
class AudioStubSpec:
    """Whisper conv frontend: log-mel [3000, 80] -> two conv1d (stride 1, 2)
    -> 1500 frame embeddings. The stub hands the encoder the 1500 x d_model
    frame embeddings directly."""

    n_frames: int = 1500


def _stub_embeds(cfg: ModelConfig, batch: int, n: int, seed: int, device: DeviceLike) -> torch.Tensor:
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((batch, n, cfg.d_model), generator=gen, device=dev)
    return (0.02 * x).to(compute_dtype(cfg))


def vision_patch_embeds(cfg: ModelConfig, batch: int, n_patches: int, seed: int = 0,
                        device: DeviceLike = "cuda") -> torch.Tensor:
    """Synthetic precomputed patch embeddings [b, n_patches, d_model]."""
    return _stub_embeds(cfg, batch, n_patches, seed, device)


def audio_frame_embeds(cfg: ModelConfig, batch: int, n_frames: int, seed: int = 0,
                       device: DeviceLike = "cuda") -> torch.Tensor:
    """Synthetic precomputed frame embeddings [b, n_frames, d_model]."""
    return _stub_embeds(cfg, batch, n_frames, seed, device)


def merge_vision_embeds(
    cfg: ModelConfig,
    token_embeds: torch.Tensor,     # [b, s, d] — text token embeddings
    patch_embeds: torch.Tensor,     # [b, p, d] — precomputed patch embeddings
    patch_offset: int = 0,
) -> torch.Tensor:
    """Splice patch embeddings into the token-embedding sequence at a fixed
    offset (static layout: <patches><text>, the common packed-VLM layout).
    The offset is clamped as ``lax.dynamic_update_slice`` clamps it."""
    b, s, d = token_embeds.shape
    p = patch_embeds.shape[1]
    if p > s - patch_offset:
        raise ValueError(f"{p} patches do not fit in seq {s} at offset {patch_offset}")
    return update_slice(token_embeds, patch_embeds, patch_offset, dim=1)
