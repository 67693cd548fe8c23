"""Transformer / Mamba blocks and the repeating pattern unit (the
reference's ``models/blocks.py``).

A *unit* is the smallest repeating group of sublayers (see
``ModelConfig.pattern_unit``); the model loops over stacked unit
parameters. Every block is a pure function; serving modes thread a state
tree (KV caches / SSM states):

* mode="train"    — full sequence, no state.
* mode="prefill"  — full sequence, writes K/V + final SSM states into state.
* mode="decode"   — single token, reads+updates state.
* mode="extend"   — new tokens against a cache that holds ``cache_len``
  (a host integer) before them; latent attention and KDA only.

The serving modes write into the state tree they are given, in place, and
return it (the reference returns a new tree; ``lm_prefill`` and
``lm_decode_step`` keep that form by copying the state first). Decode takes
``cache_len`` as a 0-d integer tensor on the device: positions, ring slots
and masks are built there from it and nothing is read back to the host, so
a decode step can be captured as one CUDA graph.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from ..device import DeviceLike, resolve_device
from .attention import (
    attention,
    attention_reference,
    decode_attention,
    init_attention,
    init_kv_cache,
    project_out,
    project_qkv,
    write_kv_cache,
)
from .config import FFNKind, LayerKind, ModelConfig, SublayerSpec
from .kda import apply_kda, init_kda, init_kda_state
from .layers import Params, apply_mlp, apply_norm, constrain, gather_dp, init_mlp, init_norm
from .mamba2 import apply_mamba, init_mamba
from .mla import init_latent_cache, init_mla, mla_attention
from .moe import apply_moe, init_moe

BlockState = Optional[Dict[str, Any]]


# ------------------------------------------------------------------ init ---

def init_sublayer(cfg: ModelConfig, gen: torch.Generator, spec: SublayerSpec) -> Params:
    dev = gen.device
    params: Params = {}
    if spec.kind in (LayerKind.ATTN, LayerKind.ATTN_LOCAL):
        params["attn_norm"] = init_norm(cfg, cfg.d_model, dev)
        params["attn"] = init_mla(cfg, gen) if cfg.is_mla else init_attention(cfg, gen)
        if cfg.post_sublayer_norm:
            params["attn_post_norm"] = init_norm(cfg, cfg.d_model, dev)
    elif spec.kind is LayerKind.KDA:
        params["kda_norm"] = init_norm(cfg, cfg.d_model, dev)
        params["kda"] = init_kda(cfg, gen)
    else:  # MAMBA
        params["mamba_norm"] = init_norm(cfg, cfg.d_model, dev)
        params["mamba"] = init_mamba(cfg, gen)

    has_ffn = spec.ffn is FFNKind.MOE or cfg.d_ff > 0
    if has_ffn and not cfg.parallel_block:
        params["ffn_norm"] = init_norm(cfg, cfg.d_model, dev)
    if has_ffn:
        if spec.ffn is FFNKind.MOE:
            params["moe"] = init_moe(cfg, gen)
        else:
            params["mlp"] = init_mlp(cfg, gen)
        if cfg.post_sublayer_norm:
            params["ffn_post_norm"] = init_norm(cfg, cfg.d_model, dev)
    return params


def init_unit(cfg: ModelConfig, gen: torch.Generator, specs=None) -> Params:
    """One unit's sublayers (``specs``, the pattern unit by default)."""
    specs = cfg.pattern_unit() if specs is None else specs
    return {f"sub{i}": init_sublayer(cfg, gen, spec) for i, spec in enumerate(specs)}


# ------------------------------------------------------------ attention ----

def _attn_full(
    cfg: ModelConfig,
    params: Params,
    x: torch.Tensor,
    positions: torch.Tensor,
    local: bool,
    causal: bool,
    opts,
    kv_out: Optional[Dict[str, torch.Tensor]],
) -> torch.Tensor:
    """Full-sequence attention; optionally writes the cache ``kv_out`` in
    place (prefill)."""
    q, k, v = project_qkv(cfg, params, x, positions)
    if kv_out is not None:
        s = k.shape[1]
        s_len = kv_out["k"].shape[1]
        if s_len >= s:
            write_kv_cache(kv_out, k, v, 0)
        else:
            # Ring cache (windowed layer): keep the last s_len positions at
            # their ring slots (position p -> slot p % s_len). The block of
            # trailing positions wraps once.
            start = s % s_len
            seg1 = s_len - start
            k_last, v_last = k[:, -s_len:], v[:, -s_len:]
            write_kv_cache(kv_out, k_last[:, :seg1], v_last[:, :seg1], start)
            if start > 0:
                write_kv_cache(kv_out, k_last[:, seg1:], v_last[:, seg1:], 0)
    if opts.gqa_mode == "broadcast" and k.shape[2] != q.shape[2]:
        g = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    q = constrain(q, opts.attn_q_sharding)
    k = constrain(k, opts.attn_kv_sharding)
    v = constrain(v, opts.attn_kv_sharding)
    qb = opts.attn_q_block
    if causal:
        o = attention(
            cfg, q, k, v, local=local, impl=opts.attn_impl,
            q_block=(q.shape[1] if qb == -1 else (qb or 512)),
        )
    else:
        o = attention_reference(
            q, k, v, causal=False,
            window=cfg.sliding_window if local else None,
            logit_cap=cfg.attn_logit_softcap,
        )
    return project_out(params, constrain(o, opts.attn_q_sharding))


def _attn_decode(
    cfg: ModelConfig,
    params: Params,
    x: torch.Tensor,
    cache: Dict[str, torch.Tensor],
    cache_len: torch.Tensor,         # 0-d int64 on x's device
    local: bool,
) -> torch.Tensor:
    """One token's attention; writes its K/V into ``cache`` in place."""
    positions = cache_len.reshape(1)  # new token at cache_len
    q, k, v = project_qkv(cfg, params, x, positions)
    s_len = cache["k"].shape[1]
    kv_positions = None
    if local and cfg.sliding_window:
        # Ring buffer: windowed layers allocate only ~window slots. Slot i
        # holds absolute position p = cache_len - ((cache_len - i) mod S)
        # (negative => unwritten). K is RoPE'd at its absolute position
        # before the write, so only the mask needs the ring mapping.
        write_kv_cache(cache, k, v, torch.remainder(cache_len, s_len))
        idx = torch.arange(s_len, device=x.device)
        kv_positions = cache_len - torch.remainder(cache_len - idx, s_len)
    else:
        write_kv_cache(cache, k, v, cache_len)
    o = decode_attention(
        q,
        cache["k"],
        cache["v"],
        cache_len + 1,
        window=cfg.sliding_window if local else None,
        logit_cap=cfg.attn_logit_softcap,
        kv_positions=kv_positions,
    )
    return project_out(params, o)


# ----------------------------------------------------------------- apply ---

def apply_sublayer(
    cfg: ModelConfig,
    params: Params,
    spec: SublayerSpec,
    x: torch.Tensor,
    *,
    mode: str = "train",                 # train | prefill | decode | extend
    positions: Optional[torch.Tensor] = None,
    state: BlockState = None,
    cache_len: Optional[Union[int, torch.Tensor]] = None,
    causal: bool = True,
    opts=None,
) -> Tuple[torch.Tensor, BlockState, torch.Tensor]:
    """Returns (x, new_state_or_None, moe_aux_loss). In the serving modes
    the new state is ``state``, written in place."""
    if opts is None:
        from .model import ForwardOptions

        opts = ForwardOptions()
    opts.check()
    params = gather_dp(params)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    local = spec.kind is LayerKind.ATTN_LOCAL
    if mode == "extend" and not (spec.kind is LayerKind.KDA or (cfg.is_mla and spec.kind is LayerKind.ATTN)):
        raise NotImplementedError("an extend step is written for latent attention and KDA only")

    # ---- mixer ----
    if spec.kind is LayerKind.KDA:
        h = apply_norm(cfg, params["kda_norm"], x)
        x = x + apply_kda(cfg, params["kda"], h, mode, state)
        mixer_out = None
    elif cfg.is_mla and spec.kind is LayerKind.ATTN:
        h = apply_norm(cfg, params["attn_norm"], x)
        cache = state["latent"] if mode != "train" else None
        start = 0 if mode in ("train", "prefill") else cache_len
        x = x + mla_attention(cfg, params["attn"], h, start, cache, impl=opts.mla_impl,
                              scores=opts.attn_impl)
        mixer_out = None
    elif spec.kind in (LayerKind.ATTN, LayerKind.ATTN_LOCAL):
        h = apply_norm(cfg, params["attn_norm"], x)
        if mode == "decode":
            o = _attn_decode(cfg, params["attn"], h, state["kv"], cache_len, local)
        else:
            kv_out = state["kv"] if mode == "prefill" else None
            o = _attn_full(cfg, params["attn"], h, positions, local, causal, opts, kv_out)
        if cfg.post_sublayer_norm:
            o = apply_norm(cfg, params["attn_post_norm"], o)
        mixer_out: Optional[torch.Tensor] = None
        if cfg.parallel_block:
            mixer_out = o
        else:
            x = x + o
    else:  # MAMBA
        h = apply_norm(cfg, params["mamba_norm"], x)
        o, ssm_state, conv_state = apply_mamba(
            cfg,
            params["mamba"],
            h,
            ssm_state=state.get("ssm") if mode == "decode" else None,
            conv_state=state.get("conv") if mode == "decode" else None,
            impl="step" if mode == "decode" else opts.mamba_impl,
        )
        if mode in ("decode", "prefill"):
            # the mixer is functional (the reference's); its new SSM state
            # and conv window are written into the state it was given
            state["ssm"].copy_(ssm_state)
            for name, window in conv_state.items():
                state["conv"][name].copy_(window)
        x = x + o
        mixer_out = None

    # ---- FFN ----
    has_ffn = spec.ffn is FFNKind.MOE or cfg.d_ff > 0
    if has_ffn:
        if cfg.parallel_block:
            hf = apply_norm(cfg, params["attn_norm"], x)  # shared input norm
        else:
            hf = apply_norm(cfg, params["ffn_norm"], x)
        if spec.ffn is FFNKind.MOE:
            f, aux = apply_moe(cfg, params["moe"], hf, dispatch=opts.moe_dispatch,
                               shardings=opts.moe_compute_shardings)
        else:
            f = apply_mlp(cfg, params["mlp"], hf)
        if cfg.post_sublayer_norm:
            f = apply_norm(cfg, params["ffn_post_norm"], f)
        if cfg.parallel_block and mixer_out is not None:
            x = x + mixer_out + f
        else:
            x = x + f
    elif cfg.parallel_block and mixer_out is not None:
        x = x + mixer_out

    return x, (state if mode != "train" else None), aux


# ----------------------------------------------------------- decode state --

def init_sublayer_state(
    cfg: ModelConfig, spec: SublayerSpec, batch: int, max_len: int, dtype: torch.dtype,
    device: DeviceLike = "cuda",
) -> Dict[str, Any]:
    """Decode-state tree for ONE sublayer."""
    dev = resolve_device(device)
    sub: Dict[str, Any] = {}
    if spec.kind is LayerKind.KDA:
        sub.update(init_kda_state(cfg, batch, dtype, dev))
    elif cfg.is_mla and spec.kind is LayerKind.ATTN:
        sub["latent"] = init_latent_cache(cfg, batch, max_len, dtype, dev)
    elif spec.kind in (LayerKind.ATTN, LayerKind.ATTN_LOCAL):
        # Windowed layers only ever read the trailing window: allocate a
        # ring buffer of ~window slots instead of max_len.
        s_len = max_len
        if spec.kind is LayerKind.ATTN_LOCAL and cfg.sliding_window:
            s_len = min(max_len, _round_up(cfg.sliding_window + 1, 128))
        sub["kv"] = init_kv_cache(batch, s_len, cfg.n_kv_heads, cfg.resolved_head_dim, dtype, dev)
    else:
        k = cfg.ssm_conv_kernel
        sub["ssm"] = torch.zeros(
            (batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state), dtype=torch.float32, device=dev
        )
        sub["conv"] = {
            "x": torch.zeros((batch, k - 1, cfg.d_inner), dtype=dtype, device=dev),
            "B": torch.zeros((batch, k - 1, cfg.ssm_groups * cfg.ssm_state), dtype=dtype, device=dev),
            "C": torch.zeros((batch, k - 1, cfg.ssm_groups * cfg.ssm_state), dtype=dtype, device=dev),
        }
    return sub


def init_unit_state(
    cfg: ModelConfig, batch: int, max_len: int, dtype: torch.dtype, device: DeviceLike = "cuda",
    specs=None,
) -> Dict[str, Any]:
    """Decode-state tree for ONE unit (unstacked) of ``specs``, the
    pattern unit by default."""
    specs = cfg.pattern_unit() if specs is None else specs
    return {f"sub{i}": init_sublayer_state(cfg, spec, batch, max_len, dtype, device)
            for i, spec in enumerate(specs)}


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m
