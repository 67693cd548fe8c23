"""Int8 KV-cache quantization — the decode cell's memory lever (the
reference's ``serve/quant.py``).

Decode streams the parameters and the cache; int8 K/V with
per-(head, position) scales halves the cache stream against bf16. This is
an *approximation*, not an equivalent algorithm, so the tests bound the
attention output's error instead of asserting equality.

Layout: q8 [b, S, K, hd] int8 + scales [b, S, K] f32 (per head-position
amax scaling, KIVI-style post-RoPE).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from ..device import DeviceLike, resolve_device
from ..models.attention import decode_attention
from ..models.layers import update_slice


def quantize_kv(k: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[b, s, K, hd] -> (int8 payload, f32 scales [b, s, K])."""
    kf = k.float()
    amax = kf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, 1.0)
    q = torch.clamp(torch.round(kf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


def init_quant_kv_cache(
    batch: int, max_len: int, n_kv_heads: int, head_dim: int, device: DeviceLike = "cuda",
) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    payload, scales = (batch, max_len, n_kv_heads, head_dim), (batch, max_len, n_kv_heads)
    return {
        "k_q": torch.zeros(payload, dtype=torch.int8, device=dev),
        "k_s": torch.ones(scales, dtype=torch.float32, device=dev),
        "v_q": torch.zeros(payload, dtype=torch.int8, device=dev),
        "v_s": torch.ones(scales, dtype=torch.float32, device=dev),
    }


def update_quant_kv_cache(
    cache: Dict[str, torch.Tensor],
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    position: Union[int, torch.Tensor],
) -> Dict[str, torch.Tensor]:
    """A new cache with ``k_new``/``v_new`` quantized and written at
    ``position`` (placed as ``lax.dynamic_update_slice`` places it; a
    tensor position is never read back to the host)."""
    kq, ks = quantize_kv(k_new)
    vq, vs = quantize_kv(v_new)
    return {name: update_slice(cache[name], new, position, dim=1)
            for name, new in (("k_q", kq), ("k_s", ks), ("v_q", vq), ("v_s", vs))}


def quant_decode_attention(
    q: torch.Tensor,                  # [b, 1, H, hd]
    cache: Dict[str, torch.Tensor],
    cache_len: Union[int, torch.Tensor],
    *,
    window: Optional[int] = None,
    logit_cap: Optional[float] = None,
) -> torch.Tensor:
    """Decode attention over the int8 cache (dequantized per use).

    Bytes moved per token: (1 + 4/hd) per element vs 2 for bf16 — a 1.97x
    cache-stream reduction at hd=128.
    """
    k = dequantize_kv(cache["k_q"], cache["k_s"], q.dtype)
    v = dequantize_kv(cache["v_q"], cache["v_s"], q.dtype)
    return decode_attention(q, k, v, cache_len, window=window, logit_cap=logit_cap)
