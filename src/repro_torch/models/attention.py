"""Attention: GQA with qk-norm / logit softcap / sliding window, in several
mathematically equivalent implementations (the ``attention_impl`` autotune
site), plus KV-cache decode — the reference's ``models/attention.py``.

* ``attention_reference`` — materialises the ``[.., sq, skv]`` scores; the
  correctness oracle. ``gqa="grouped"`` keeps K/V at kv-head granularity,
  ``"broadcast"`` repeats them to the query heads: equal FLOPs, different
  memory traffic.
* ``attention_chunked`` — blockwise online softmax (the flash formulation)
  as nested loops over q and kv blocks; masked blocks are computed too.
* ``attention_local_chunked`` — sliding window, each q block slicing only
  the kv span it can see.

``attention`` picks one of them by sequence length, as the reference's
dispatcher does; like the reference's model path it reaches no kernel.
The reference's ``lax.scan`` loops are Python loops here.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .config import ModelConfig
from .layers import (Params, apply_rope, is_dtensor, local_like, normal_init, ones_init, param_dtype,
                     rms_head_norm, seq_shard, softcap, update_slice, update_slice_)

NEG_INF = -2.0e38  # f32-safe mask value


# ---------------------------------------------------------------- params ---

def init_attention(cfg: ModelConfig, gen: torch.Generator) -> Params:
    dt = param_dtype(cfg)
    hd = cfg.resolved_head_dim
    out_std = 0.02 / np.sqrt(2 * cfg.n_layers)
    params: Params = {
        "wq": normal_init(gen, (cfg.d_model, cfg.n_heads, hd), ("embed", "q_heads", "head_dim"), dt),
        "wk": normal_init(gen, (cfg.d_model, cfg.n_kv_heads, hd), ("embed", "kv_heads", "head_dim"), dt),
        "wv": normal_init(gen, (cfg.d_model, cfg.n_kv_heads, hd), ("embed", "kv_heads", "head_dim"), dt),
        "wo": normal_init(gen, (cfg.n_heads, hd, cfg.d_model), ("q_heads", "head_dim", "embed"), dt, out_std),
    }
    if cfg.qk_norm:
        params["q_norm"] = ones_init((hd,), (None,), dt, gen.device)
        params["k_norm"] = ones_init((hd,), (None,), dt, gen.device)
    return params


def project_qkv(
    cfg: ModelConfig, params: Params, x: torch.Tensor, positions: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [b, s, d] -> q [b, s, H, hd], k/v [b, s, K, hd] with RoPE applied."""
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"].to(x.dtype))
    if cfg.qk_norm:
        q = rms_head_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_head_norm(k, params["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def project_out(params: Params, attn: torch.Tensor) -> torch.Tensor:
    wo = params["wo"].to(attn.dtype)
    if is_dtensor(attn):
        return _project_out_sharded(attn, wo)
    return torch.einsum("bshk,hkd->bsd", attn, wo)


def _project_out_sharded(attn: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """:func:`project_out` on DTensors, each rank on its own rows and heads
    (heads split: a partial sum over them), the output's sequence then
    gathered. The attention core may leave the queries' sequence split
    over a mesh axis; torch 2.11's DTensor refuses to flatten a split
    sequence into the product's rows."""
    from ..launch.compat import Partial, Replicate, Shard, shard_map

    mesh = attn.device_mesh
    a_pl = tuple(p if p.is_shard() and p.dim in (0, 1, 2) else Replicate() for p in attn.placements)
    w_pl = tuple(Shard(0) if p.is_shard(2) else Replicate() for p in a_pl)
    y_pl = tuple(Partial() if p.is_shard(2) else p for p in a_pl)
    y = shard_map(lambda a, w: torch.einsum("bshk,hkd->bsd", a, w), mesh=mesh,
                  in_placements=(a_pl, w_pl), out_placements=y_pl)(attn, wo)
    whole = tuple(Replicate() if p.is_shard(1) else p for p in y_pl)
    return y if whole == y_pl else y.redistribute(mesh, whole)


# ------------------------------------------------------------ mask logic ---

def _mask_bias(
    q_pos: torch.Tensor,      # [sq]
    kv_pos: torch.Tensor,     # [skv]
    causal: bool,
    window: Optional[int],
    kv_len: Optional[Union[int, torch.Tensor]] = None,  # valid cache length
) -> torch.Tensor:
    """Additive bias [sq, skv]: 0 where allowed, NEG_INF where masked."""
    allowed = torch.ones((q_pos.shape[0], kv_pos.shape[0]), dtype=torch.bool, device=q_pos.device)
    if causal:
        allowed &= kv_pos[None, :] <= q_pos[:, None]
    if window is not None:
        allowed &= kv_pos[None, :] > q_pos[:, None] - window
    if kv_len is not None:
        allowed &= kv_pos[None, :] < kv_len
    return torch.zeros(allowed.shape, dtype=torch.float32, device=q_pos.device).masked_fill(
        ~allowed, NEG_INF)


# -------------------------------------------------------------- variants ---

def attention_reference(
    q: torch.Tensor,          # [b, sq, H, hd]
    k: torch.Tensor,          # [b, skv, K, hd]
    v: torch.Tensor,          # [b, skv, K, hd]
    *,
    causal: bool = True,
    window: Optional[int] = None,
    logit_cap: Optional[float] = None,
    q_offset: Union[int, torch.Tensor] = 0,
    gqa: str = "grouped",  # "grouped" | "broadcast"
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Full-scores attention. O(sq*skv) memory; correctness oracle.

    ``scale`` defaults to 1/sqrt(hd); ``v`` may be narrower or wider than
    ``q`` and ``k`` (the output takes its width). ``q_offset``, the first
    query's position, may be a 0-d tensor on the device."""
    b, sq, h, hd = q.shape
    kheads = k.shape[2]
    g = h // kheads
    dv = v.shape[-1]
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    q_pos = torch.arange(sq, device=q.device) + q_offset
    kv_pos = torch.arange(k.shape[1], device=q.device)
    bias = _mask_bias(q_pos, kv_pos, causal, window)

    if gqa == "broadcast":
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
        scores = torch.einsum("bqhk,bshk->bhqs", q, k).float() * scale
        scores = softcap(scores, logit_cap) + bias[None, None]
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        return torch.einsum("bhqs,bshk->bqhk", probs, v)
    # grouped: keep K/V at kv-head granularity
    qg = q.reshape(b, sq, kheads, g, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float() * scale
    scores = softcap(scores, logit_cap) + bias[None, None, None]
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(b, sq, h, dv)


def attention_chunked(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    logit_cap: Optional[float] = None,
    q_block: int = 512,
    kv_block: int = 1024,
    q_offset: Union[int, torch.Tensor] = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Blockwise online-softmax attention (flash formulation, plain PyTorch).

    Outer loop over q blocks, inner loop over kv blocks, carrying
    (m, l, acc) running max / normaliser / weighted accumulator. Memory is
    O(q_block * kv_block) per step. Masked (future) blocks are computed and
    discarded. ``scale``, the value width and ``q_offset`` as in
    :func:`attention_reference`.
    """
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    kheads = k.shape[2]
    g = h // kheads
    dv = v.shape[-1]
    if sq % q_block != 0 or skv % kv_block != 0:
        raise ValueError(f"seq ({sq},{skv}) not divisible by blocks ({q_block},{kv_block})")
    nq, nk = sq // q_block, skv // kv_block
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    dev = q.device

    qb = q.reshape(b, nq, q_block, kheads, g, hd)
    kb = k.reshape(b, nk, kv_block, kheads, hd)
    vb = v.reshape(b, nk, kv_block, kheads, dv)

    blocks = []
    for i in range(nq):
        qi = qb[:, i]  # [b, q_block, K, g, hd]
        q_pos = torch.arange(q_block, device=dev) + i * q_block + q_offset
        m = torch.full((b, kheads, g, q_block), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, kheads, g, q_block), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, kheads, g, q_block, dv), dtype=torch.float32, device=dev)
        for j in range(nk):
            kj, vj = kb[:, j], vb[:, j]
            kv_pos = torch.arange(kv_block, device=dev) + j * kv_block
            s = torch.einsum("bqkgd,bskd->bkgqs", qi, kj).float() * scale
            s = softcap(s, logit_cap)
            allowed = torch.ones((q_block, kv_block), dtype=torch.bool, device=dev)
            if causal:
                allowed &= kv_pos[None, :] <= q_pos[:, None]
            if window is not None:
                allowed &= kv_pos[None, :] > q_pos[:, None] - window
            s = torch.where(allowed, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            # guard fully-masked rows (m_new == NEG_INF)
            m_safe = torch.where(m_new <= NEG_INF * 0.5, 0.0, m_new)
            p = torch.exp(s - m_safe[..., None])
            p = torch.where(allowed, p, 0.0)
            alpha = torch.where(m <= NEG_INF * 0.5, 0.0, torch.exp(m - m_safe))
            l = l * alpha + p.sum(dim=-1)
            pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(qi.dtype), vj).float()
            acc = acc * alpha[..., None] + pv
            m = m_new
        l_safe = torch.where(l == 0.0, 1.0, l)
        out = (acc / l_safe[..., None]).to(q.dtype)  # [b, K, g, qb, dv]
        blocks.append(out.permute(0, 3, 1, 2, 4))   # [b, qb, K, g, dv]
    return torch.cat(blocks, dim=1).reshape(b, sq, h, dv)


def attention_local_chunked(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    window: int,
    logit_cap: Optional[float] = None,
    q_block: int = 512,
    q_offset: int = 0,
) -> torch.Tensor:
    """Sliding-window attention with true FLOPs savings: each q block slices
    only the kv span it can see (length window + q_block), so cost is
    O(s * window) instead of O(s²). Causal by construction."""
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    kheads = k.shape[2]
    g = h // kheads
    if sq % q_block != 0:
        raise ValueError(f"sq {sq} % q_block {q_block} != 0")
    span = window + q_block  # slice length
    if span >= skv:
        return attention_chunked(
            q, k, v, causal=True, window=window, logit_cap=logit_cap,
            q_block=q_block, kv_block=min(skv, 1024), q_offset=q_offset,
        )
    nq = sq // q_block
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    qb = q.reshape(b, nq, q_block, kheads, g, hd)

    blocks = []
    for i in range(nq):
        qi = qb[:, i]
        q_start = i * q_block
        # kv span [q_start - window + 1, q_start + q_block); clamp to >= 0.
        start = max(q_start + q_block - span, 0)
        # lax.dynamic_slice clamps the slice into the array; the positions
        # below keep the unclamped start, as the reference's do.
        lo = min(start, skv - span)
        kj, vj = k[:, lo:lo + span], v[:, lo:lo + span]
        q_pos = torch.arange(q_block, device=dev) + q_start + q_offset
        kv_pos = torch.arange(span, device=dev) + start + q_offset
        s = torch.einsum("bqkgd,bskd->bkgqs", qi, kj).float() * scale
        s = softcap(s, logit_cap)
        allowed = (kv_pos[None, :] <= q_pos[:, None]) & (kv_pos[None, :] > q_pos[:, None] - window)
        s = torch.where(allowed, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bkgqs,bskd->bkgqd", p.to(qi.dtype), vj)
        blocks.append(out.permute(0, 3, 1, 2, 4))  # [b, qb, K, g, hd]
    return torch.cat(blocks, dim=1).reshape(b, sq, h, hd)


def decode_attention(
    q: torch.Tensor,            # [b, 1, H, hd] — single new query
    k_cache: torch.Tensor,      # [b, S, K, hd]
    v_cache: torch.Tensor,      # [b, S, K, hd]
    cache_len: Union[int, torch.Tensor],  # scalar or [b]: number of valid positions
    *,
    window: Optional[int] = None,
    logit_cap: Optional[float] = None,
    kv_positions: Optional[torch.Tensor] = None,  # [S] absolute positions (ring)
) -> torch.Tensor:
    """One-token attention over the cache; O(S) per step. ``kv_positions``
    supports ring-buffer caches (windowed layers): slot -> absolute
    position, negative for unwritten slots."""
    if is_dtensor(k_cache):
        return _decode_attention_sharded(q, k_cache, v_cache, cache_len, window=window,
                                         logit_cap=logit_cap, kv_positions=kv_positions)
    b, s, kheads, hd = k_cache.shape
    h = q.shape[2]
    g = h // kheads
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    qg = q.reshape(b, 1, kheads, g, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k_cache).float() * scale
    scores = softcap(scores, logit_cap)
    kv_pos = kv_positions.to(dev) if kv_positions is not None else torch.arange(s, device=dev)
    # query at cache_len - 1; a host integer stays one (a tensor made from it
    # would wait for the device's queue at every layer)
    q_pos = cache_len - 1 if isinstance(cache_len, int) else (cache_len.to(dev) - 1).reshape(-1, 1)
    allowed = (kv_pos[None, :] <= q_pos) & (kv_pos[None, :] >= 0)
    if window is not None:
        allowed &= kv_pos[None, :] > q_pos - window
    bias = torch.zeros(allowed.shape, dtype=torch.float32, device=dev).masked_fill(
        ~allowed, NEG_INF)  # [b or 1, S]
    scores = scores + bias[:, None, None, None, :]
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v_cache)
    return out.reshape(b, 1, h, hd)


def _decode_attention_sharded(q, k_cache, v_cache, cache_len, *, window, logit_cap, kv_positions):
    """:func:`decode_attention` over DTensor caches whose sequence may be
    sharded (the decode cells' ``cache_seq_spec``): each rank scores the
    query against its own slice of the cache, and the softmax's max and
    normaliser and the weighted values are all-reduced across the slices
    (split-K decoding). The query is gathered to the cache's layout first;
    the output is laid out so too, with the sequence's mesh dimensions
    replicated."""
    import torch.distributed as dist

    from ..launch.compat import DTensor, Replicate

    mesh = k_cache.device_mesh
    dims, off, length = seq_shard(k_cache, 1)
    groups = [mesh.get_group(i) for i in dims]
    k, v = k_cache.to_local(), v_cache.to_local()
    q = local_like(q, k_cache, 1)
    b, _, kheads, hd = k.shape
    h = q.shape[2]
    g = h // kheads
    dev = q.device
    scores = torch.einsum("bqkgd,bskd->bkgqs", q.reshape(b, 1, kheads, g, hd), k).float() / math.sqrt(hd)
    scores = softcap(scores, logit_cap)
    kv_pos = (kv_positions.to(dev)[off:off + length] if kv_positions is not None
              else torch.arange(off, off + length, device=dev))
    q_pos = cache_len - 1 if isinstance(cache_len, int) else (cache_len.to(dev) - 1).reshape(-1, 1)
    allowed = (kv_pos[None, :] <= q_pos) & (kv_pos[None, :] >= 0)
    if window is not None:
        allowed &= kv_pos[None, :] > q_pos - window
    scores = scores.masked_fill(~allowed[:, None, None, None, :], NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    for grp in groups:
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=grp)
    p = torch.exp(scores - m)
    den = p.sum(dim=-1, keepdim=True)
    for grp in groups:
        dist.all_reduce(den, group=grp)
    out = torch.einsum("bkgqs,bskd->bqkgd", (p / den).to(q.dtype), v).float()
    for grp in groups:
        dist.all_reduce(out, group=grp)
    pl = tuple(Replicate() if pp.is_shard(1) else pp for pp in k_cache.placements)
    return DTensor.from_local(out.to(q.dtype).reshape(b, 1, h, hd), mesh, pl, run_check=False)


# --------------------------------------------------------------- KV cache --

def init_kv_cache(
    batch: int, max_len: int, n_kv_heads: int, head_dim: int, dtype: torch.dtype,
    device: DeviceLike = "cuda",
) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    shape = (batch, max_len, n_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def write_kv_cache(
    cache: Dict[str, torch.Tensor],
    k_new: torch.Tensor,          # [b, s_new, K, hd]
    v_new: torch.Tensor,
    position: Union[int, torch.Tensor],  # scalar write offset
) -> Dict[str, torch.Tensor]:
    """Write ``k_new``/``v_new`` into ``cache`` at ``position``, in place,
    and return ``cache``. The offset is clamped so the update fits, as
    ``lax.dynamic_update_slice`` clamps it; a tensor offset (0-d, on the
    cache's device) is never read back to the host."""
    update_slice_(cache["k"], k_new, position, dim=1)
    update_slice_(cache["v"], v_new, position, dim=1)
    return cache


def update_kv_cache(
    cache: Dict[str, torch.Tensor],
    k_new: torch.Tensor,          # [b, s_new, K, hd]
    v_new: torch.Tensor,
    position: Union[int, torch.Tensor],  # scalar write offset
) -> Dict[str, torch.Tensor]:
    """A new cache with ``k_new``/``v_new`` written at ``position`` (the
    reference's functional form; the inputs are not changed)."""
    return {"k": update_slice(cache["k"], k_new, position, dim=1),
            "v": update_slice(cache["v"], v_new, position, dim=1)}


# ------------------------------------------------------------- dispatcher --

def attention(
    cfg: ModelConfig,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    local: bool = False,
    impl: str = "auto",
    q_block: int = 512,
    kv_block: int = 1024,
) -> torch.Tensor:
    """Select implementation by sequence length / layer kind / config."""
    if is_dtensor(q):
        return _attention_sharded(cfg, q, k, v, local=local, impl=impl, q_block=q_block, kv_block=kv_block)
    return _attention_local(cfg, q, k, v, local=local, impl=impl, q_block=q_block, kv_block=kv_block)


def _attention_sharded(cfg, q, k, v, *, local, impl, q_block, kv_block):
    """:func:`attention` on DTensors: the attention core is independent per
    batch row and per head, and per query row given the whole K/V, so each
    rank runs it on its own rows and heads — the layouts the sharding
    constraints pin (queries sequence- or head-sharded, K/V replicated or
    head-sharded with them). Queries sharded on the sequence take their
    causal offset from their slice. (DTensor's einsum rules would search
    every layout of the five-dimensional score products, which on a
    three-axis mesh does not finish.)"""
    from ..launch.compat import Replicate, shard_map

    mesh = q.device_mesh
    if impl == "auto":  # chosen by the whole sequence, as on one device
        impl = "reference" if q.shape[1] <= 1024 else "chunked"
    q_pl = tuple(p if p.is_shard() and p.dim in (0, 1, 2) else Replicate() for p in q.placements)
    kv_pl = tuple(Replicate() if p.is_shard(1) else p for p in q_pl)
    coord = mesh.get_coordinate()

    def rank_of(dims):  # (this rank's index, the count) over mesh dims split major to minor
        idx = 0
        for i in dims:
            idx = idx * mesh.size(i) + coord[i]
        return idx, int(np.prod([mesh.size(i) for i in dims]))

    idx, n = rank_of([i for i, p in enumerate(q_pl) if p.is_shard(1)])
    q_offset = idx * (q.shape[1] // n)
    # query heads split where the K/V heads cannot split with them (fewer
    # K/V heads than head shards: the head_q strategy): K/V stay whole and
    # each rank takes the K/V head of each of its query heads
    idx, n = rank_of([i for i, p in enumerate(q_pl) if p.is_shard(2)])
    kv_heads = None
    if k.shape[2] % n:
        kv_pl = tuple(Replicate() if p.is_shard(2) else p for p in kv_pl)
        h_local = q.shape[2] // n
        kv_heads = torch.arange(idx * h_local, (idx + 1) * h_local) // (q.shape[2] // k.shape[2])

    def core(q_l, k_l, v_l):
        if kv_heads is not None:
            k_l = k_l.index_select(2, kv_heads.to(k_l.device))
            v_l = v_l.index_select(2, kv_heads.to(v_l.device))
        return _attention_local(cfg, q_l, k_l, v_l, local=local, impl=impl, q_block=q_block,
                                kv_block=kv_block, q_offset=q_offset)

    return shard_map(core, mesh=mesh, in_placements=(q_pl, kv_pl, kv_pl), out_placements=q_pl)(q, k, v)


def _attention_local(
    cfg: ModelConfig,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    local: bool = False,
    impl: str = "auto",
    q_block: int = 512,
    kv_block: int = 1024,
    q_offset: int = 0,
) -> torch.Tensor:
    window = cfg.sliding_window if local else None
    cap = cfg.attn_logit_softcap
    sq = q.shape[1]
    if impl == "auto":
        impl = "reference" if sq <= 1024 else "chunked"
    if impl == "reference":
        return attention_reference(q, k, v, causal=True, window=window, logit_cap=cap, q_offset=q_offset)
    if impl == "chunked":
        # (the windowed slicing takes q and k at one offset: a query slice
        # of a longer sequence runs the masked blocks instead)
        if window is not None and window + q_block < k.shape[1] and q_offset == 0:
            return attention_local_chunked(
                q, k, v, window=window, logit_cap=cap, q_block=min(q_block, sq), q_offset=q_offset
            )
        return attention_chunked(
            q, k, v, causal=True, window=window, logit_cap=cap,
            q_block=min(q_block, sq), kv_block=min(kv_block, k.shape[1]), q_offset=q_offset,
        )
    raise ValueError(f"unknown attention impl {impl!r}")
