"""Plain PyTorch versions of flash attention, on the head-flattened layout
``q [bh, sq, d]``, ``k, v [bh, skv, d]``.

* :func:`flash_attention_ref` is the reference's oracle
  (``kernels/flash_attention/ref.py``), copied. ``ops.flash_attention``'s
  ``use_kernel=False`` route takes it.
* :func:`flash_attention_plain` is the function the TPU kernel computes, and
  the one the CUDA kernel is held against. It equals the oracle except in two
  cases where the reference's kernel and its oracle differ: a query that sees
  no key gives 0 (the oracle's softmax over an all-masked row gives the mean
  of ``v``), and the window is shifted by ``skv - sq`` only when causal (the
  oracle always shifts it). Scores are f32 from f32 inputs, ``p`` is rounded
  to ``v``'s dtype before the PV product, and the output is in ``q``'s dtype.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -2.0e38


def flash_attention_ref(
    q: torch.Tensor,              # [bh, sq, d]
    k: torch.Tensor,              # [bh, skv, d]
    v: torch.Tensor,              # [bh, skv, d]
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    logit_cap: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    bh, sq, d = q.shape
    skv = k.shape[1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    s = torch.einsum("bqd,bkd->bqk", q, k).float() * scale
    if logit_cap:
        s = logit_cap * torch.tanh(s / logit_cap)
    q_pos = torch.arange(sq, device=q.device)[:, None]
    kv_pos = torch.arange(skv, device=q.device)[None, :]
    allowed = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        allowed &= kv_pos <= q_pos + (skv - sq)  # offset when sq != skv
    if window is not None:
        allowed &= kv_pos > q_pos + (skv - sq) - window
    s = torch.where(allowed[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p.to(v.dtype), v)


def flash_attention_plain(
    q: torch.Tensor,              # [bh, sq, d]
    k: torch.Tensor,              # [bh, skv, d]
    v: torch.Tensor,              # [bh, skv, d]
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    logit_cap: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    bh, sq, d = q.shape
    skv = k.shape[1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if logit_cap:
        s = logit_cap * torch.tanh(s / logit_cap)
    q_offset = skv - sq if causal else 0  # the TPU kernel's rule
    q_pos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kv_pos = torch.arange(skv, device=q.device)[None, :]
    allowed = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        allowed &= kv_pos <= q_pos
    if window is not None:
        allowed &= kv_pos > q_pos - window
    s = s.masked_fill(~allowed[None], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), 0.0, m)  # a row that sees no key: p = 0, l = 0
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bqk,bkd->bqd", p.to(v.dtype).float(), v.float())
    return (out / torch.where(l == 0.0, 1.0, l)).to(q.dtype)
