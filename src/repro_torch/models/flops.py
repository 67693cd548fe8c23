"""Analytic parameter counts and MODEL_FLOPS (the roofline numerator); a copy
of the reference's ``models/flops.py``.

Conventions (PaLM-appendix style):
* matmul-parameter FLOPs: 6·N_active per trained token (2 fwd + 4 bwd),
  2·N_active per decoded token (fwd only). Embedding *lookup* is a gather
  (0 FLOPs); the unembed projection is a matmul and is counted.
* attention-score FLOPs (not in N): per token per attention layer,
  fwd = 4·s_ctx·H·hd (QKᵀ + PV), bwd = 2×fwd. Causal full attention uses
  s_ctx = (s+1)/2; windowed layers use min(window, ·); decode uses the
  actual cache length.
* SSD (Mamba-2) sequence-mix FLOPs per token: 2·Q·(g·n + h·p) intra-chunk
  + 4·h·p·n inter-chunk state ops (fwd; ×3 for training).

``MODEL_FLOPS / HLO_FLOPs`` per cell is reported in EXPERIMENTS.md §Roofline
— it exposes remat recompute, masked-block waste and dispatch overheads.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from .config import FFNKind, LayerKind, ModelConfig


@dataclass(frozen=True)
class ParamCounts:
    total: int            # all parameters
    active: int           # per-token active (MoE: top-k routed + shared)
    embedding: int        # embedding (+untied head) parameters
    matmul_active: int    # active params participating in per-token matmuls
                          # (includes unembed; excludes gather-only embedding)


def _attn_params(cfg: ModelConfig) -> int:
    hd = cfg.resolved_head_dim
    p = cfg.d_model * cfg.n_heads * hd          # q
    p += 2 * cfg.d_model * cfg.n_kv_heads * hd  # k, v
    p += cfg.n_heads * hd * cfg.d_model         # o
    if cfg.qk_norm:
        p += 2 * hd
    return p


def _mlp_params(cfg: ModelConfig, d_ff: int) -> int:
    mult = 3 if cfg.activation in ("swiglu", "geglu") else 2
    return mult * cfg.d_model * d_ff


def _moe_params(cfg: ModelConfig) -> Dict[str, int]:
    f = cfg.resolved_moe_d_ff
    routed_each = _mlp_params(cfg, f)
    shared = 0
    if cfg.n_shared_experts > 0:
        shared = _mlp_params(cfg, cfg.resolved_shared_d_ff) + cfg.d_model
    router = cfg.d_model * cfg.n_experts
    total = router + cfg.n_experts * routed_each + shared
    active = router + cfg.top_k * routed_each + shared
    return {"total": total, "active": active}


def _mamba_params(cfg: ModelConfig) -> int:
    d, di = cfg.d_model, cfg.d_inner
    g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    k = cfg.ssm_conv_kernel
    p = 2 * d * di            # wz, wx
    p += 2 * d * g * n        # wB, wC
    p += d * h                # wdt
    p += k * (di + 2 * g * n)  # convs
    p += 3 * h                # A_log, D, dt_bias
    p += di                   # gated norm
    p += di * d               # out proj
    return p


def param_counts(cfg: ModelConfig) -> ParamCounts:
    embed = cfg.vocab_size * cfg.d_model
    if not cfg.tie_embeddings:
        embed += cfg.d_model * cfg.vocab_size

    total = 0
    active = 0
    for spec in cfg.pattern_unit():
        if spec.kind in (LayerKind.ATTN, LayerKind.ATTN_LOCAL):
            a = _attn_params(cfg)
            total += a
            active += a
        else:
            m = _mamba_params(cfg)
            total += m
            active += m
        if spec.ffn is FFNKind.MOE:
            moe = _moe_params(cfg)
            total += moe["total"]
            active += moe["active"]
        elif cfg.d_ff > 0:
            mp = _mlp_params(cfg, cfg.d_ff)
            total += mp
            active += mp
    total *= cfg.n_units
    active *= cfg.n_units

    if cfg.is_encoder_decoder:
        enc = cfg.n_encoder_layers * (_attn_params(cfg) + _mlp_params(cfg, cfg.d_ff))
        cross = cfg.n_layers * _attn_params(cfg)
        total += enc + cross
        active += enc + cross

    # unembed matmul params (tied weights still do the matmul)
    unembed = cfg.d_model * cfg.vocab_size
    matmul_active = active + unembed

    return ParamCounts(
        total=total + embed,
        active=active + embed,
        embedding=embed,
        matmul_active=matmul_active,
    )


def _attn_layer_count(cfg: ModelConfig) -> Dict[str, int]:
    full = local = mamba = 0
    for spec in cfg.pattern_unit():
        if spec.kind is LayerKind.ATTN:
            full += 1
        elif spec.kind is LayerKind.ATTN_LOCAL:
            local += 1
        else:
            mamba += 1
    return {
        "full": full * cfg.n_units,
        "local": local * cfg.n_units,
        "mamba": mamba * cfg.n_units,
    }


def _seq_mix_flops_per_token(cfg: ModelConfig, s_ctx_full: float, s_ctx_local: float) -> float:
    """Forward sequence-mixing FLOPs per token across all layers."""
    counts = _attn_layer_count(cfg)
    hd = cfg.resolved_head_dim
    per_full = 4.0 * s_ctx_full * cfg.n_heads * hd
    per_local = 4.0 * s_ctx_local * cfg.n_heads * hd
    f = counts["full"] * per_full + counts["local"] * per_local
    if counts["mamba"]:
        q = cfg.ssm_chunk
        g, n = cfg.ssm_groups, cfg.ssm_state
        h, p = cfg.ssm_heads, cfg.ssm_head_dim
        per_mamba = 2.0 * q * (g * n + h * p) + 4.0 * h * p * n
        f += counts["mamba"] * per_mamba
    if cfg.is_encoder_decoder:
        # decoder cross-attention + encoder self-attention (bidirectional)
        f += cfg.n_layers * 4.0 * cfg.encoder_seq * cfg.n_heads * hd
        # encoder tokens aren't the denominating tokens; fold per dec token:
        f += cfg.n_encoder_layers * 4.0 * cfg.encoder_seq * cfg.n_heads * hd
    return f


def training_flops(cfg: ModelConfig, batch: int, seq: int) -> float:
    """MODEL_FLOPS for one training step over batch x seq tokens."""
    pc = param_counts(cfg)
    tokens = batch * seq
    s_full = (seq + 1) / 2.0
    s_local = min(cfg.sliding_window or seq, seq) if cfg.sliding_window else s_full
    s_local = min(s_local, s_full) if cfg.sliding_window else s_full
    mix_fwd = _seq_mix_flops_per_token(cfg, s_full, s_local)
    return tokens * (6.0 * pc.matmul_active + 3.0 * mix_fwd)


def decode_flops(cfg: ModelConfig, batch: int, kv_len: int) -> float:
    """MODEL_FLOPS for one decode step (one new token per sequence)."""
    pc = param_counts(cfg)
    s_local = min(cfg.sliding_window or kv_len, kv_len)
    mix_fwd = _seq_mix_flops_per_token(cfg, float(kv_len), float(s_local))
    return batch * (2.0 * pc.matmul_active + mix_fwd)


def prefill_flops(cfg: ModelConfig, batch: int, seq: int) -> float:
    """MODEL_FLOPS for a prefill pass (forward only)."""
    pc = param_counts(cfg)
    tokens = batch * seq
    s_full = (seq + 1) / 2.0
    s_local = min(cfg.sliding_window or seq, seq) if cfg.sliding_window else s_full
    mix_fwd = _seq_mix_flops_per_token(cfg, s_full, min(s_local, s_full))
    return tokens * (2.0 * pc.matmul_active + mix_fwd)
