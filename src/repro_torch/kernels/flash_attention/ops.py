"""``flash_attention`` in the model layout, on the hand-written Hopper kernel.

``q [b, sq, h, d]``, ``k, v [b, skv, kv_heads, d]``; query head ``i``
attends with kv head ``i // (h // kv_heads)``, the mapping of the
reference's ``jnp.repeat``. ``use_kernel=False`` takes the reference's oracle
on the head-flattened, kv-repeated layout, as the reference's wrapper does;
both routes share this function so tests sweep them identically. The
reference's docstring mentions padding to block multiples, which its code
does not do: a sequence the blocks do not divide raises ``ValueError`` on
the kernel route.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention_kernel, heads_flat
from .ref import flash_attention_ref


def flash_attention(
    q: torch.Tensor,              # [b, sq, h, d]
    k: torch.Tensor,              # [b, skv, kv_heads, d]
    v: torch.Tensor,              # [b, skv, kv_heads, d]
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    logit_cap: Optional[float] = None,
    window: Optional[int] = None,
    block_q: int = 128,
    block_k: int = 512,
    use_kernel: bool = True,
) -> torch.Tensor:
    """Attention output ``[b, sq, h, d]`` in ``q``'s dtype: the kernel (plain
    version for CPU tensors) or, with ``use_kernel=False``, the oracle."""
    if q.dim() != 4:
        raise ValueError(f"need q [b, s, h, d], got {tuple(q.shape)}")
    if use_kernel:
        return flash_attention_kernel(
            q, k, v, causal=causal, sm_scale=sm_scale, logit_cap=logit_cap,
            window=window, block_q=block_q, block_k=block_k,
        )
    b, sq, h, d = q.shape
    of = flash_attention_ref(*heads_flat(q, k, v), causal=causal, sm_scale=sm_scale,
                             logit_cap=logit_cap, window=window)
    return of.reshape(b, h, sq, d).transpose(1, 2)
