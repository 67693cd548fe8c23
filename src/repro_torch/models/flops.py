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
* latent attention (MLA) counts its parameters (W_UK and W_UV among them)
  and the decompressed form's scores, 2·s_ctx·H·(dn + dr + dv);
  :func:`mla_algorithm_flops` counts an extend step's four algorithms.
* SSD (Mamba-2) sequence-mix FLOPs per token: 2·Q·(g·n + h·p) intra-chunk
  + 4·h·p·n inter-chunk state ops (fwd; ×3 for training).
* KDA (Kimi Delta Attention) sequence-mix FLOPs per token: the chunked
  core's, :func:`kda_chunk_flops` over the tokens (fwd; ×3 for training).
* A layer that holds a share of its experts (``experts_held``) counts the
  experts it holds; routing still picks ``top_k`` of all of them.

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
    if cfg.is_mla:
        return _mla_params(cfg)
    hd = cfg.resolved_head_dim
    p = cfg.d_model * cfg.n_heads * hd          # q
    p += 2 * cfg.d_model * cfg.n_kv_heads * hd  # k, v
    p += cfg.n_heads * hd * cfg.d_model         # o
    if cfg.qk_norm:
        p += 2 * hd
    return p


def _mla_params(cfg: ModelConfig) -> int:
    d, h, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return d * h * (dn + dr) + d * (r + dr) + r + r * h * (dn + dv) + h * dv * d


def mla_algorithm_flops(cfg: ModelConfig, q: int, kv_len: int, batch: int = 1) -> Dict[str, float]:
    """Analytic FLOPs of latent attention's four algorithms for ``q`` new
    tokens against ``kv_len`` cached positions (the new ones among them),
    the full q x kv_len score rectangle counted: the shared projections
    (queries, latent down-projection, output), then for ``decompress`` the
    expansion of every cached latent into per-head K and V and attention
    at qk dn+dr, v dv; for ``absorb`` W_UK folded into the queries,
    attention at qk r+dr, v r, and W_UV on the output. Blockwise scores
    (``_chunked``) compute the same products."""
    d, h, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    shared = 2.0 * q * d * h * (dn + dr) + 2.0 * q * d * (r + dr) + 2.0 * q * h * dv * d
    decompress = (shared + 2.0 * kv_len * r * h * (dn + dv)
                  + 2.0 * q * kv_len * h * (dn + dr) + 2.0 * q * kv_len * h * dv)
    absorb = (shared + 2.0 * q * h * dn * r + 2.0 * q * kv_len * h * (r + dr)
              + 2.0 * q * kv_len * h * r + 2.0 * q * h * r * dv)
    return {"absorb": batch * absorb, "absorb_chunked": batch * absorb,
            "decompress": batch * decompress, "decompress_chunked": batch * decompress}


def _kda_params(cfg: ModelConfig) -> int:
    d, h, dk, r, k = cfg.d_model, cfg.kda_heads, cfg.kda_head_dim, cfg.kda_gate_rank, cfg.kda_conv_kernel
    hd = h * dk
    p = 3 * d * hd            # wq, wk, wv
    p += 3 * k * hd           # short convolutions
    p += 2 * (d * r + r * hd)  # decay (f) and output-gate (g) projections
    p += d * h                # beta
    p += h + hd + dk          # A_log, dt_bias, the output norm
    p += hd * d               # out proj
    return p


def kda_chunk_flops(b: int, s: int, h: int, dk: int, dv: int, chunk: int, sub: int = 16) -> float:
    """FLOPs of :func:`~.kda.kda_chunked` at chunk length C (a sequence
    padded to whole chunks), every product at leading order, elementwise
    scalings left out, per chunk and head: the pairs below the diagonal
    sub-blocks for A and P, 2·2·d_k·C·(C − sub); the diagonal sub-blocks,
    whole, 2·2·C·sub·d_k; the UT transform's triangular solve, C²·(d_k +
    d_v); the state pass, U = U' − W S and S ← … + K̄ᵀ U, 2·2·C·d_k·d_v;
    the output, 2·C·d_k·d_v + 2·C²·d_v (P U with P's zero half)."""
    n = -(-s // chunk)
    per_chunk = (3 * chunk * chunk * (dk + dv) + 2 * chunk * sub * dk + 6 * chunk * dk * dv)
    return float(b * n * h * per_chunk)


def _mlp_params(cfg: ModelConfig, d_ff: int) -> int:
    mult = 3 if cfg.activation in ("swiglu", "geglu") else 2
    return mult * cfg.d_model * d_ff


def _moe_params(cfg: ModelConfig) -> Dict[str, int]:
    f = cfg.resolved_moe_d_ff
    routed_each = _mlp_params(cfg, f)
    shared = 0
    if cfg.n_shared_experts > 0:
        shared = _mlp_params(cfg, cfg.resolved_shared_d_ff) + (cfg.d_model if cfg.moe_shared_gate else 0)
    router = cfg.d_model * cfg.n_experts
    total = router + cfg.n_experts_held * routed_each + shared
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

    def layers(specs):
        total = active = 0
        for spec in specs:
            mixer = _mixer_params(cfg, spec.kind)
            total += mixer
            active += mixer
            if spec.ffn is FFNKind.MOE:
                moe = _moe_params(cfg)
                total += moe["total"]
                active += moe["active"]
            elif cfg.d_ff > 0:
                mp = _mlp_params(cfg, cfg.d_ff)
                total += mp
                active += mp
        return total, active

    unit_total, unit_active = layers(cfg.pattern_unit())
    # leading dense layers (their mixer and a dense MLP each), then the tail
    lead_total, lead_active = layers([cfg.lead_spec()] * cfg.first_k_dense_replace)
    tail_total, tail_active = layers(cfg.pattern_tail())
    total = unit_total * cfg.n_units + lead_total + tail_total
    active = unit_active * cfg.n_units + lead_active + tail_active

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


def _mixer_params(cfg: ModelConfig, kind: LayerKind) -> int:
    if kind in (LayerKind.ATTN, LayerKind.ATTN_LOCAL):
        return _attn_params(cfg)
    return _kda_params(cfg) if kind is LayerKind.KDA else _mamba_params(cfg)


def _attn_layer_count(cfg: ModelConfig) -> Dict[str, int]:
    kinds = cfg.layer_kinds()
    return {
        "full": kinds.count(LayerKind.ATTN),
        "local": kinds.count(LayerKind.ATTN_LOCAL),
        "mamba": kinds.count(LayerKind.MAMBA),
        "kda": kinds.count(LayerKind.KDA),
    }


def _seq_mix_flops_per_token(cfg: ModelConfig, s_ctx_full: float, s_ctx_local: float) -> float:
    """Forward sequence-mixing FLOPs per token across all layers."""
    counts = _attn_layer_count(cfg)
    hd = cfg.resolved_head_dim
    per_full = 4.0 * s_ctx_full * cfg.n_heads * hd
    per_local = 4.0 * s_ctx_local * cfg.n_heads * hd
    if cfg.is_mla:  # the decompressed form's QK^T (dn + dr) and PV (dv)
        width = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim + cfg.v_head_dim
        per_full = 2.0 * s_ctx_full * cfg.n_heads * width
        per_local = 2.0 * s_ctx_local * cfg.n_heads * width
    f = counts["full"] * per_full + counts["local"] * per_local
    if counts["mamba"]:
        q = cfg.ssm_chunk
        g, n = cfg.ssm_groups, cfg.ssm_state
        h, p = cfg.ssm_heads, cfg.ssm_head_dim
        per_mamba = 2.0 * q * (g * n + h * p) + 4.0 * h * p * n
        f += counts["mamba"] * per_mamba
    if counts["kda"]:
        dk = cfg.kda_head_dim
        f += counts["kda"] * kda_chunk_flops(1, cfg.kda_chunk, cfg.kda_heads, dk, dk, cfg.kda_chunk) / cfg.kda_chunk
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
