"""Multi-head latent attention (DeepSeek-V2, arXiv:2405.04434 §2.1), the
port's own: the reference has no latent attention.

Each token is cached as one latent row: ``c`` (``kv_lora_rank`` wide, RMS
normed) and a rope key ``kr`` (``qk_rope_head_dim`` wide) shared by every
head. The queries are not compressed. Per head, the key is
[W_UK c, kr] and the value W_UV c. The same attention can be computed in
two orders, the choice the paper studies inside a model:

* ``decompress`` — expand the cached latents into per-head K and V
  (``rt.mla.expand``), then attend with H kv heads (qk dn+dr, v dv);
* ``absorb`` — fold W_UK into the queries, attend in the latent space with
  one shared kv head (qk r+dr, v r), then apply W_UV per head
  (``rt.mla.absorb``, both products).

Each with materialised scores (:func:`~.attention.attention_reference`) or
the blockwise online softmax (:func:`~.attention.attention_chunked`):
equal FLOPs inside an order. :func:`pick_algorithm` chooses by analytic
FLOPs (:func:`~.flops.mla_algorithm_flops`): decompress for a prefill,
absorb for a decode step, and by new tokens against the cache's length for
an extend step; the dispatch is a zero-length span ``rt.mla.pick.absorb``
or ``rt.mla.pick.decompress``. The latent write is ``rt.mla.cache``.

Kimi-Linear's latent attention is the NoPE variant (``mla_rope`` False):
the ``qk_rope_head_dim`` channels stay a key part shared by every head, but
nothing is rotated, and there is no YaRN.

Departures from the published code: the rope halves are split, not
interleaved pairs (the two differ by a fixed permutation of the rope
projection's columns, which random weights do not see), and the RMS norm
of ``c`` multiplies by its weight in float32 before the cast back.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Union

import numpy as np
import torch

from ..spans import span
from .attention import attention_chunked, attention_reference
from .config import ModelConfig
from .flops import mla_algorithm_flops
from .layers import Params, normal_init, ones_init, param_dtype, rms_head_norm, update_slice_

ALGORITHMS = ("absorb", "absorb_chunked", "decompress", "decompress_chunked")
Start = Union[int, torch.Tensor]


# ---------------------------------------------------------------- params ---

def init_mla(cfg: ModelConfig, gen: torch.Generator) -> Params:
    dt = param_dtype(cfg)
    d, h, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    out_std = 0.02 / np.sqrt(2 * cfg.n_layers)
    return {
        "wq": normal_init(gen, (d, h, dn + dr), ("embed", "q_heads", "head_dim"), dt),
        "wkv_a": normal_init(gen, (d, r + dr), ("embed", None), dt),
        "kv_norm": ones_init((r,), (None,), dt, gen.device),
        "wuk": normal_init(gen, (r, h, dn), (None, "q_heads", "head_dim"), dt),
        "wuv": normal_init(gen, (r, h, dv), (None, "q_heads", "head_dim"), dt),
        "wo": normal_init(gen, (h, dv, d), ("q_heads", "head_dim", "embed"), dt, out_std),
    }


def init_latent_cache(cfg: ModelConfig, batch: int, max_len: int, dtype: torch.dtype,
                      device: torch.device) -> Dict[str, torch.Tensor]:
    return {"c": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype, device=device),
            "kr": torch.zeros((batch, max_len, cfg.qk_rope_head_dim), dtype=dtype, device=device)}


# ----------------------------------------------------------------- YaRN ---

def yarn_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_frequencies(cfg: ModelConfig) -> np.ndarray:
    """The rope's inverse frequencies [dr/2] under YaRN: the low
    frequencies interpolated by ``rope_factor``, the high ones kept, a
    linear ramp between the correction dimensions of ``beta_fast`` and
    ``beta_slow`` (plain rope for a factor of 1)."""
    dim, base = cfg.qk_rope_head_dim, cfg.rope_theta
    extra = 1.0 / base ** (np.arange(0, dim, 2, dtype=np.float64) / dim)
    if cfg.rope_factor <= 1:
        return extra

    def correction(rotations: float) -> float:
        return dim * math.log(cfg.rope_original_max_position / (rotations * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(correction(cfg.rope_beta_fast)), 0)
    high = min(math.ceil(correction(cfg.rope_beta_slow)), dim - 1)
    ramp = np.clip((np.arange(dim // 2) - low) / ((high - low) or 0.001), 0.0, 1.0)
    return extra / cfg.rope_factor * ramp + extra * (1.0 - ramp)


def softmax_scale(cfg: ModelConfig) -> float:
    """(dn + dr)^-1/2 times the square of YaRN's attention factor."""
    m = yarn_mscale(cfg.rope_factor, cfg.rope_mscale_all_dim) if cfg.rope_mscale_all_dim else 1.0
    return (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5 * m * m


@functools.lru_cache(maxsize=16)
def _frequencies_on(cfg: ModelConfig, device: torch.device) -> torch.Tensor:
    """The f32 frequencies on ``device``, copied there once."""
    return torch.tensor(yarn_frequencies(cfg), dtype=torch.float32, device=device)


def apply_yarn_rope(cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Rotate x [b, s, heads, dr] (halves split) at ``positions`` [s]."""
    freqs = _frequencies_on(cfg, x.device)
    m = yarn_mscale(cfg.rope_factor, cfg.rope_mscale) / yarn_mscale(cfg.rope_factor, cfg.rope_mscale_all_dim)
    angles = positions.float()[:, None] * freqs
    cos, sin = torch.cos(angles)[:, None, :], torch.sin(angles)[:, None, :]
    if m != 1.0:
        cos, sin = cos * m, sin * m
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ------------------------------------------------------------ dispatcher ---

def pick_algorithm(cfg: ModelConfig, q: int, kv_len: int, impl: str = "auto",
                   scores: str = "auto") -> str:
    """The algorithm for ``q`` new tokens against ``kv_len`` cached ones:
    ``impl`` itself, or for ``"auto"`` the order with fewer analytic FLOPs
    (decompress on a tie), its scores materialised up to 1024 queries and
    blockwise beyond, or as ``scores`` (the attention's ``reference`` or
    ``chunked``) says."""
    if impl != "auto":
        if impl not in ALGORITHMS:
            raise ValueError(f"unknown MLA algorithm {impl!r}; known: {ALGORITHMS}")
        family = impl.split("_")[0]
    else:
        f = mla_algorithm_flops(cfg, q, kv_len)
        family = "absorb" if f["absorb"] < f["decompress"] else "decompress"
        chunked = q > 1024 if scores == "auto" else scores == "chunked"
        impl = family + ("_chunked" if chunked else "")
    if family == "absorb":
        with span("rt.mla.pick.absorb"):
            pass
    else:
        with span("rt.mla.pick.decompress"):
            pass
    return impl


# -------------------------------------------------------------- sublayer ---

def _padded(x: torch.Tensor, block: int) -> torch.Tensor:
    """``x`` [b, n, ...] with zero rows appended up to a multiple of ``block``."""
    extra = -x.shape[1] % block
    return x if extra == 0 else torch.cat([x, x.new_zeros((x.shape[0], extra) + x.shape[2:])], dim=1)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_offset: Start, scale: float,
            chunked: bool, q_block: int = 512, kv_block: int = 1024) -> torch.Tensor:
    if not chunked:
        return attention_reference(q, k, v, causal=True, q_offset=q_offset, scale=scale)
    # zero rows past the end are masked for every real query (causal)
    sq = q.shape[1]
    qb, kb = min(q_block, sq), min(kv_block, k.shape[1])
    out = attention_chunked(_padded(q, qb), _padded(k, kb), _padded(v, kb), causal=True,
                            q_block=qb, kv_block=kb, q_offset=q_offset, scale=scale)
    return out[:, :sq]


def mla_attention(
    cfg: ModelConfig,
    params: Params,
    x: torch.Tensor,                  # [b, s, d]: the new tokens, normed
    start: Start = 0,                 # position of the first new token
    cache: Optional[Dict[str, torch.Tensor]] = None,
    impl: str = "auto",
    scores: str = "auto",
) -> torch.Tensor:
    """The attention sublayer's output [b, s, d] for ``s`` new tokens.

    Without ``cache`` the tokens attend to themselves (a training forward).
    With it their latents are written at ``start`` in place, and they
    attend to the cache: to its first ``start + s`` rows for a host
    ``start`` (prefill, extend), to all of it under the causal mask for a
    0-d device ``start`` (a decode step, read nowhere on the host, so that
    it can be captured as one CUDA graph)."""
    b, s, _ = x.shape
    h, r = cfg.n_heads, cfg.kv_lora_rank
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    positions = torch.arange(s, device=x.device) + start
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(x.dtype))
    q_nope, q_pe = q.split([dn, dr], dim=-1)
    kv = x @ params["wkv_a"].to(x.dtype)
    c, kr = kv.split([r, dr], dim=-1)
    c = rms_head_norm(c, params["kv_norm"], cfg.norm_eps)
    if cfg.mla_rope:
        q_pe = apply_yarn_rope(cfg, q_pe, positions)
        kr = apply_yarn_rope(cfg, kr[:, :, None, :], positions)[:, :, 0]
    if cache is None:
        c_all, kr_all = c, kr
    else:
        with span("rt.mla.cache"):
            update_slice_(cache["c"], c, start, dim=1)
            update_slice_(cache["kr"], kr, start, dim=1)
        c_all, kr_all = cache["c"], cache["kr"]
        if not isinstance(start, torch.Tensor):
            c_all, kr_all = c_all[:, :start + s], kr_all[:, :start + s]
    algorithm = pick_algorithm(cfg, s, c_all.shape[1], impl, scores)
    chunked = algorithm.endswith("_chunked")
    scale = softmax_scale(cfg)
    wuk, wuv = params["wuk"].to(x.dtype), params["wuv"].to(x.dtype)
    if algorithm.startswith("absorb"):
        with span("rt.mla.absorb"):
            q_lat = torch.einsum("bshn,rhn->bshr", q_nope, wuk)
        k = torch.cat([c_all, kr_all], dim=-1)[:, :, None, :]      # one kv head, r + dr
        o_lat = _attend(torch.cat([q_lat, q_pe], dim=-1), k, c_all[:, :, None, :], start, scale, chunked)
        with span("rt.mla.absorb"):
            o = torch.einsum("bshr,rhv->bshv", o_lat, wuv)
    else:
        with span("rt.mla.expand"):
            k_nope = torch.einsum("blr,rhn->blhn", c_all, wuk)
            v = torch.einsum("blr,rhv->blhv", c_all, wuv)
            k = torch.cat([k_nope, kr_all[:, :, None, :].expand(-1, -1, h, -1)], dim=-1)
        o = _attend(torch.cat([q_nope, q_pe], dim=-1), k, v, start, scale, chunked)
    return torch.einsum("bshv,hvd->bsd", o, params["wo"].to(o.dtype))
