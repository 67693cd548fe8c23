"""The plain reference of the ``mla-extend-16k`` cell: one extend step of
DeepSeek-V2's latent-attention sublayer by the published equations.

Plain PyTorch, importing nothing of the program, in float64: the new
tokens' queries, latents (RMS normed) and rope keys (YaRN, as the
published ``DeepseekV2YarnRotaryEmbedding``, whose angles are float32
products, halves split as the program splits them), the latents written after the cached rows, each head's key
[W_UK c, k_pe] and value W_UV c decompressed, causal softmax attention
one head at a time, and the output projection. The control computes the
same in float32 with the operands of every product rounded to TF32.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Tuple

import torch

from .formulas_mla import widths
from .reference import tf32

Mm = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _f64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a.double() @ b.double()


def _tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return tf32(a) @ tf32(b)


def _mscale(factor: float, m: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def rope_tables(config: Mapping, positions: torch.Tensor, dtype: torch.dtype):
    """(cos, sin) [s, dr/2] of YaRN rope at ``positions``; the frequencies
    rounded once to float32 and each angle a float32 product, as the
    published table's, its cosine and sine then taken in ``dtype``."""
    rs = config["rope_scaling"]
    dim, base, factor = int(config["qk_rope_head_dim"]), float(config["rope_theta"]), float(rs["factor"])

    def corr(rot):
        return dim * math.log(rs["original_max_position_embeddings"] / (rot * 2 * math.pi)) / (2 * math.log(base))

    extra = 1.0 / base ** (torch.arange(0, dim, 2, dtype=torch.float64) / dim)
    low = max(math.floor(corr(rs["beta_fast"])), 0)
    high = min(math.ceil(corr(rs["beta_slow"])), dim - 1)
    ramp = ((torch.arange(dim // 2, dtype=torch.float64) - low) / ((high - low) or 0.001)).clamp(0, 1)
    inv = extra / factor * ramp + extra * (1 - ramp)
    m = _mscale(factor, rs["mscale"]) / _mscale(factor, rs["mscale_all_dim"])
    # the angle as the published table makes it: position times frequency in float32
    angles = (positions.float()[:, None] * inv.float().to(positions.device)).double()
    return (torch.cos(angles) * m).to(dtype), (torch.sin(angles) * m).to(dtype)


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (cos.shape[-1],)
    cos, sin = cos.reshape(shape), sin.reshape(shape)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def extend(config: Mapping, params: Dict[str, torch.Tensor], x: torch.Tensor, c: torch.Tensor,
           kr: torch.Tensor, control: bool = False) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(output [b, q, d], new latents [b, q, r], new rope keys [b, q, dr])
    of ``x`` [b, q, d] appended after the cached rows of ``c`` [b, L, r] and
    ``kr`` [b, L, dr] (rows L − q on are the new ones and are not read)."""
    w = widths(config)
    d, h, r, dn, dr, dv = (w[k] for k in ("d", "h", "r", "dn", "dr", "dv"))
    mm: Mm = _tf32 if control else _f64
    dt = torch.float32 if control else torch.float64
    b, q, _ = x.shape
    L = c.shape[1]
    eps = float(config["rms_norm_eps"])
    rs = config["rope_scaling"]
    m = _mscale(float(rs["factor"]), rs["mscale_all_dim"]) if rs.get("mscale_all_dim") else 1.0
    scale = (dn + dr) ** -0.5 * m * m
    p = {k: v.to(dt) for k, v in params.items()}
    cos, sin = rope_tables(config, torch.arange(L - q, L, device=x.device), dt)
    w_kv = torch.cat([p["wuk"], p["wuv"]], dim=-1).reshape(r, h * (dn + dv))
    future = torch.ones((q, L), dtype=torch.bool, device=x.device).triu(L - q + 1)
    outs, cs, krs = [], [], []
    for i in range(b):
        xi = x[i].to(dt)
        qh = mm(xi, p["wq"].reshape(d, -1)).reshape(q, h, dn + dr)
        q_pe = _rope(qh[..., dn:], cos, sin)
        ckv = mm(xi, p["wkv_a"])
        cn = ckv[:, :r]
        cn = cn * torch.rsqrt(cn.square().mean(dim=-1, keepdim=True) + eps) * p["kv_norm"]
        k_pe_new = _rope(ckv[:, r:], cos, sin)
        c_all = torch.cat([c[i, :L - q].to(dt), cn])
        k_pe = torch.cat([kr[i, :L - q].to(dt), k_pe_new])
        kv = mm(c_all, w_kv).reshape(L, h, dn + dv)
        o = torch.empty((q, h, dv), dtype=dt, device=x.device)
        for j in range(h):
            k = torch.cat([kv[:, j, :dn], k_pe], dim=-1)
            scores = mm(torch.cat([qh[:, j, :dn], q_pe[:, j]], dim=-1), k.T) * scale
            probs = torch.softmax(scores.masked_fill_(future, float("-inf")), dim=-1)
            o[:, j] = mm(probs, kv[:, j, dn:])
            del k, scores, probs
        outs.append(mm(o.reshape(q, h * dv), p["wo"].reshape(h * dv, d)))
        cs.append(cn)
        krs.append(k_pe_new)
        del kv, c_all, k_pe
    return torch.stack(outs), torch.stack(cs), torch.stack(krs)
