"""DeepSeek-V2's forward pass by the published equations, in plain float32
torch: the yardstick that the port's latent-attention model is held to.

It follows the published modelling code (``modeling_deepseek.py`` of
deepseek-ai/DeepSeek-V2-Lite; arXiv:2405.04434 §2.1–2.2) for one sequence:
per layer an RMS norm, multi-head latent attention with the latent
decompressed into per-head keys and values (the paper's equations), then
a dense MLP (the ``first_k_dense_replace`` leading layers) or the MoE
(softmax router, greedy top-k, weights scaled without renormalising, the
shared experts as one ungated MLP). It keeps no cache, takes no batch,
imports nothing of the port, and switches TF32 off for its products.

It reads the port's parameter tree (``init_lm_params``'s values, any
dtype and device) and converts one layer at a time to float32, so that it
fits beside the model on one card, and computes attention one head at a
time. The configuration is read by attribute only.

Departures, shared with the port: the rope's two halves are split rather
than interleaved pairs (a fixed permutation of the rope projection's
columns), and the RMS norms multiply by their weight before rounding (here
all in float32, where the two agree).
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Iterator, Optional, Sequence

import torch


@contextlib.contextmanager
def _no_tf32() -> Iterator[None]:
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _f32(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _f32(v, device) for k, v in tree.items()}
    return tree.to(device=device, dtype=torch.float32)


def _layer(tree: Any, i: int) -> Any:
    return {k: _layer(v, i) for k, v in tree.items()} if isinstance(tree, dict) else tree[i]


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * w


def _mscale(factor: float, m: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def rope_tables(cfg, positions: torch.Tensor):
    """(cos, sin) [s, dr/2] of YaRN rope (DeepseekV2YarnRotaryEmbedding)."""
    dim, base, factor = cfg.qk_rope_head_dim, cfg.rope_theta, cfg.rope_factor
    extra = 1.0 / base ** (torch.arange(0, dim, 2, dtype=torch.float64) / dim)
    inv = extra
    if factor > 1:
        def corr(rot):
            return dim * math.log(cfg.rope_original_max_position / (rot * 2 * math.pi)) / (2 * math.log(base))
        low = max(math.floor(corr(cfg.rope_beta_fast)), 0)
        high = min(math.ceil(corr(cfg.rope_beta_slow)), dim - 1)
        ramp = ((torch.arange(dim // 2, dtype=torch.float64) - low) / ((high - low) or 0.001)).clamp(0, 1)
        inv = extra / factor * ramp + extra * (1 - ramp)
    m = _mscale(factor, cfg.rope_mscale) / _mscale(factor, cfg.rope_mscale_all_dim)
    angles = positions.float()[:, None] * inv.float().to(positions.device)
    return torch.cos(angles) * m, torch.sin(angles) * m


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [s, ..., dr] rotated: [x1 cos − x2 sin, x2 cos + x1 sin]."""
    shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (cos.shape[-1],)
    cos, sin = cos.reshape(shape), sin.reshape(shape)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(cfg, p: Dict[str, torch.Tensor], h: torch.Tensor, cos, sin) -> torch.Tensor:
    """Multi-head latent attention of a whole sequence h [s, d], causal."""
    s = h.shape[0]
    nh, r = cfg.n_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q = (h @ p["wq"].reshape(h.shape[1], -1)).reshape(s, nh, dn + dr)
    q_nope, q_pe = q[..., :dn], rope(q[..., dn:], cos, sin)
    ckv = h @ p["wkv_a"]
    c = rms_norm(ckv[:, :r], p["kv_norm"], cfg.norm_eps)
    k_pe = rope(ckv[:, r:], cos, sin)                                   # [s, dr], all heads
    kv = (c @ torch.cat([p["wuk"], p["wuv"]], dim=-1).reshape(r, -1)).reshape(s, nh, dn + dv)
    m = _mscale(cfg.rope_factor, cfg.rope_mscale_all_dim) if cfg.rope_mscale_all_dim else 1.0
    scale = (dn + dr) ** -0.5 * m * m
    future = torch.ones((s, s), dtype=torch.bool, device=h.device).triu(1)
    out = torch.empty((s, nh, dv), dtype=torch.float32, device=h.device)
    for i in range(nh):
        k = torch.cat([kv[:, i, :dn], k_pe], dim=-1)
        scores = (torch.cat([q_nope[:, i], q_pe[:, i]], dim=-1) @ k.T) * scale
        probs = torch.softmax(scores.masked_fill_(future, float("-inf")), dim=-1)
        out[:, i] = probs @ kv[:, i, dn:]
        del k, scores, probs
    return out.reshape(s, nh * dv) @ p["wo"].reshape(nh * dv, -1)


def mlp(p: Dict[str, torch.Tensor], h: torch.Tensor) -> torch.Tensor:
    """down(silu(gate(h)) * up(h)): ``wg`` the gate, ``wi`` up, ``wo`` down."""
    return (torch.nn.functional.silu(h @ p["wg"]) * (h @ p["wi"])) @ p["wo"]


def moe(cfg, p: Dict[str, torch.Tensor], h: torch.Tensor) -> torch.Tensor:
    """Softmax router, greedy top-k, the weights scaled by 1 (not
    renormalised); every token through its experts, plus the shared MLP."""
    probs = torch.softmax(h @ p["router"], dim=-1)
    weight, expert = torch.topk(probs, cfg.top_k, dim=-1)
    if cfg.moe_norm_topk:
        weight = weight / weight.sum(dim=-1, keepdim=True)
    y = torch.zeros_like(h)
    for e in range(cfg.n_experts):
        rows, slot = (expert == e).nonzero(as_tuple=True)
        if rows.numel():
            ep = {k: p[k][e] for k in ("wi", "wg", "wo")}
            y.index_add_(0, rows, mlp(ep, h[rows]) * weight[rows, slot, None])
    if cfg.n_shared_experts:
        y = y + mlp(p["shared"], h)
    return y


def forward(cfg, params: Dict[str, Any], tokens: torch.Tensor,
            rows: Optional[Sequence[int]] = None, device: Optional[torch.device] = None) -> torch.Tensor:
    """Logits [len(rows) or s, vocab] float32 of one sequence ``tokens`` [s]
    at the positions ``rows`` (all by default), the layers computed one at
    a time from ``params`` converted to float32 on ``device`` (the
    parameters' own by default)."""
    device = device or params["embed"]["table"].device
    tokens = tokens.to(device).long()
    n_lead = cfg.first_k_dense_replace
    with _no_tf32():
        x = params["embed"]["table"][tokens].to(device=device, dtype=torch.float32)
        cos, sin = rope_tables(cfg, torch.arange(x.shape[0], device=device))
        for i in range(cfg.n_layers):
            p = _f32(_layer(params["lead"], i) if i < n_lead else _layer(params["units"], i - n_lead)["sub0"],
                     device)
            x = x + attention(cfg, p["attn"], rms_norm(x, p["attn_norm"]["scale"], cfg.norm_eps), cos, sin)
            h = rms_norm(x, p["ffn_norm"]["scale"], cfg.norm_eps)
            x = x + (mlp(p["mlp"], h) if i < n_lead else moe(cfg, p["moe"], h))
            del p, h
        if rows is not None:
            x = x[torch.as_tensor(list(rows), device=device)]
        x = rms_norm(x, params["final_norm"]["scale"].to(device=device, dtype=torch.float32), cfg.norm_eps)
        return x @ params["lm_head"]["w"].to(device=device, dtype=torch.float32)
