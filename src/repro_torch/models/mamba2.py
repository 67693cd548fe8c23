"""Mamba-2 mixer via SSD (state-space duality) — the reference's
``models/mamba2.py``.

``ssd_chunked`` splits the sequence into chunks of length Q: within a chunk
the recurrence is evaluated in its dual quadratic form, and a loop over
chunk states carries it between chunks. The chunk length is mathematically
inert (any Q gives the same result up to reassociation), so chunk lengths
are equal-FLOPs variants — the ``ssd_chunk`` autotune site.
``ssd_reference`` is the sequential oracle, one step per token; decode runs
it (``impl="step"``). ``apply_mamba`` is the full mixer: projections, the
causal depthwise convolution, the scan, the gate, the norm and the
out-projection. Like the reference's model path it reaches no kernel.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import P, Params, is_dtensor, normal_init, ones_init, param_dtype


def init_mamba(cfg: ModelConfig, gen: torch.Generator) -> Params:
    dt = param_dtype(cfg)
    dev = gen.device
    d, di = cfg.d_model, cfg.d_inner
    g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    k = cfg.ssm_conv_kernel
    out_std = 0.02 / np.sqrt(2 * cfg.n_layers)
    # dt bias init: softplus^-1 of dt in [1e-3, 1e-1] (mamba2 default range);
    # numpy-drawn as in the reference, so these leaves equal its values
    rng = np.random.default_rng(42)
    dt_init = np.exp(
        rng.uniform(np.log(1e-3), np.log(1e-1), size=(h,))
    ).astype(np.float32)
    dt_bias = np.log(np.expm1(dt_init))
    a_init = rng.uniform(1.0, 16.0, size=(h,)).astype(np.float32)
    return {
        "wz": normal_init(gen, (d, di), ("embed", "ffn"), dt),
        "wx": normal_init(gen, (d, di), ("embed", "ffn"), dt),
        "wB": normal_init(gen, (d, g * n), ("embed", None), dt),
        "wC": normal_init(gen, (d, g * n), ("embed", None), dt),
        "wdt": normal_init(gen, (d, h), ("embed", "heads"), dt),
        "conv_x": normal_init(gen, (k, di), (None, "ffn"), dt, 0.1),
        "conv_B": normal_init(gen, (k, g * n), (None, None), dt, 0.1),
        "conv_C": normal_init(gen, (k, g * n), (None, None), dt, 0.1),
        "A_log": P(torch.from_numpy(np.log(a_init)).to(dev), ("heads",)),
        "D": ones_init((h,), ("heads",), torch.float32, dev),
        "dt_bias": P(torch.from_numpy(dt_bias).to(dev), ("heads",)),
        "norm": ones_init((di,), ("ffn",), dt, dev),
        "wo": normal_init(gen, (di, d), ("ffn", "embed"), dt, out_std),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, state: Optional[torch.Tensor] = None):
    """Depthwise causal conv along seq. x [b, s, c], w [k, c].

    Returns (y [b, s, c], new_state [b, k-1, c]) — state carries the last
    k-1 inputs for decode.
    """
    k = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # [b, s+k-1, c]
    y = sum(xp[:, i: i + x.shape[1], :] * w[i][None, None, :] for i in range(k))
    new_state = xp[:, -(k - 1):, :]
    return F.silu(y), new_state


def _cumsum64(log_a: torch.Tensor, dim: int) -> torch.Tensor:
    """Cumulative sum of log-decays in f64. |cum| grows about linearly with
    the chunk (hundreds at chunk 512), and an f32 cum carries ulp(|cum|)
    into every decay exp(cum_i - cum_j): at chunk 512 that alone reaches
    the 3e-4 tolerance against the sequential scan. Differences are taken
    in f64 and only then cast to f32, as the CUDA SSD kernel does."""
    return torch.cumsum(log_a.double(), dim=dim)


def _segsum_decay(log_a: torch.Tensor) -> torch.Tensor:
    """L[i, j] = exp(sum_{j<t<=i} log_a_t) for i >= j, else 0.

    log_a [..., Q, h] -> L [..., h, Q, Q]. Numerically: difference of
    cumulative sums, taken in f64 before the f32 exp (see ``_cumsum64``);
    above the diagonal the difference is replaced by -inf before the exp,
    which gives the same 0. Selecting after the exp would let an overflow
    there (inf, at chunk 256 and real step sizes) reach the backward as
    0 * inf = NaN.
    """
    q = log_a.shape[-2]
    cum = _cumsum64(log_a, dim=-2).movedim(-1, -2)         # [..., h, Q]
    diff = (cum[..., :, None] - cum[..., None, :]).float()  # [..., h, Q, Q]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=log_a.device))
    return torch.exp(torch.where(mask, diff, -math.inf))


def ssd_chunked(
    x: torch.Tensor,       # [b, s, h, p]   (dt-scaled inputs NOT yet applied)
    dt: torch.Tensor,      # [b, s, h]      (positive step sizes)
    a_log: torch.Tensor,   # [h]            (A = -exp(a_log))
    b_mat: torch.Tensor,   # [b, s, g, n]
    c_mat: torch.Tensor,   # [b, s, g, n]
    chunk: int,
    init_state: Optional[torch.Tensor] = None,  # [b, h, p, n]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan. Returns (y [b, s, h, p], final_state [b, h, p, n])."""
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    hg = h // g
    if s % chunk != 0:
        raise ValueError(f"seq {s} % chunk {chunk} != 0")
    nc = s // chunk

    a = -torch.exp(a_log.float())                          # [h], negative
    log_da = dt.float() * a                                # [b, s, h]
    xbar = x.float() * dt.float()[..., None]

    # chunked views
    xc = xbar.reshape(bsz, nc, chunk, h, p)
    dac = log_da.reshape(bsz, nc, chunk, h)
    bc = b_mat.float().reshape(bsz, nc, chunk, g, n)
    cc = c_mat.float().reshape(bsz, nc, chunk, g, n)

    # ---- intra-chunk (dual quadratic form) ----
    decay = _segsum_decay(dac)                             # [b, nc, h, Q, Q]
    cb = torch.einsum("bzign,bzjgn->bzgij", cc, bc)        # [b, nc, g, Q, Q]
    cb = cb.repeat_interleave(hg, dim=2)                   # [b, nc, h, Q, Q]
    y_intra = torch.einsum("bzhij,bzjhp->bzihp", cb * decay, xc)

    # ---- per-chunk state contribution ----
    cum = _cumsum64(dac, dim=2)                            # [b, nc, Q, h], f64
    total = cum[:, :, -1:, :]                              # [b, nc, 1, h]
    decay_to_end = torch.exp((total - cum).float())        # [b, nc, Q, h]
    # state_k = sum_j exp(sum_{j<t<=Q} log_da_t) * xbar_j ⊗ B_j
    if g == 1:
        s_chunk = torch.einsum("bzjh,bzjhp,bzjn->bzhpn", decay_to_end, xc, bc[:, :, :, 0, :])
    else:
        bfull = bc.repeat_interleave(hg, dim=3)            # [b, nc, Q, h, n]
        s_chunk = torch.einsum("bzjh,bzjhp,bzjhn->bzhpn", decay_to_end, xc, bfull)

    # ---- inter-chunk recurrence over states ----
    chunk_decay = torch.exp(total[:, :, 0, :].float())     # [b, nc, h]
    state = (init_state.float() if init_state is not None
             else torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device))
    prev = []
    for z in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, z, :, None, None] + s_chunk[:, z]
    prev_states = torch.stack(prev, dim=1)                 # [b, nc, h, p, n]

    # ---- inter-chunk contribution ----
    decay_from_start = torch.exp(cum.float())              # [b, nc, Q, h]
    if g == 1:
        y_inter = torch.einsum("bzin,bzih,bzhpn->bzihp",
                               cc[:, :, :, 0, :], decay_from_start, prev_states)
    else:
        cfull = cc.repeat_interleave(hg, dim=3)            # [b, nc, Q, h, n]
        y_inter = torch.einsum("bzihn,bzih,bzhpn->bzihp", cfull, decay_from_start, prev_states)

    y = (y_intra + y_inter).reshape(bsz, s, h, p)
    return y.to(x.dtype), state


def _ssd_sharded(scan, x, dt, a_log, b_mat, c_mat, init_state=None):
    """An SSD scan (:func:`ssd_chunked`, :func:`ssd_reference`) on
    DTensors: the scan is independent per batch row and per head, so each
    rank scans its own rows and heads (the reference's GSPMD keeps the scan
    local; DTensor's view rules refuse its strided chunk views, and torch
    2.11's its flattening of split batch and heads). B and C follow the
    heads where the groups split with them, and are whole where there is
    one group."""
    from ..launch.compat import Replicate, Shard, shard_map

    mesh, g = x.device_mesh, b_mat.shape[2]
    x_pl = tuple(p if p.is_shard(0) or p.is_shard(2) else Replicate() for p in x.placements)
    heads = [i for i, p in enumerate(x_pl) if p.is_shard(2)]
    if g > 1 and any(g % mesh.size(i) for i in heads):
        raise NotImplementedError(f"{g} SSM groups do not split with the heads over {heads}")
    bc_pl = tuple(Replicate() if p.is_shard(2) and g == 1 else p for p in x_pl)
    dt_pl = x_pl
    a_pl = tuple(Shard(0) if p.is_shard(2) else Replicate() for p in x_pl)
    st_pl = tuple(Shard(1) if p.is_shard(2) else p for p in x_pl)
    fn = shard_map(lambda *a: scan(*a[:5], init_state=a[5] if len(a) > 5 else None), mesh=mesh,
                   in_placements=(x_pl, dt_pl, a_pl, bc_pl, bc_pl) + ((st_pl,) if init_state is not None else ()),
                   out_placements=[x_pl, st_pl])
    return fn(x, dt, a_log, b_mat, c_mat, *(() if init_state is None else (init_state,)))


def ssd_reference(
    x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
    b_mat: torch.Tensor, c_mat: torch.Tensor,
    init_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential (primal) scan oracle — one step per token."""
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    hg = h // g
    a = -torch.exp(a_log.float())
    xf, dtf = x.float(), dt.float()
    bf, cf = b_mat.float(), c_mat.float()
    state = (init_state.float() if init_state is not None
             else torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device))
    ys = []
    for t in range(s):
        xt, dtt = xf[:, t], dtf[:, t]                      # [b,h,p], [b,h]
        da = torch.exp(dtt * a[None])                      # [b, h]
        bt_h = bf[:, t].repeat_interleave(hg, dim=1)       # [b, h, n]
        ct_h = cf[:, t].repeat_interleave(hg, dim=1)
        state = state * da[..., None, None] + torch.einsum(
            "bhp,bhn->bhpn", xt * dtt[..., None], bt_h)
        ys.append(torch.einsum("bhpn,bhn->bhp", state, ct_h))
    return torch.stack(ys, dim=1).to(x.dtype), state


def apply_mamba(
    cfg: ModelConfig,
    params: Params,
    xin: torch.Tensor,               # [b, s, d]
    ssm_state: Optional[torch.Tensor] = None,
    conv_state: Optional[Dict[str, torch.Tensor]] = None,
    impl: str = "chunked",
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Full Mamba-2 mixer. Returns (y [b,s,d], ssm_state, conv_state)."""
    b, s, d = xin.shape
    h, p = cfg.ssm_heads, cfg.ssm_head_dim
    g, n = cfg.ssm_groups, cfg.ssm_state

    z = xin @ params["wz"].to(xin.dtype)
    xr = xin @ params["wx"].to(xin.dtype)
    br = xin @ params["wB"].to(xin.dtype)
    cr = xin @ params["wC"].to(xin.dtype)
    dt_raw = xin @ params["wdt"].to(xin.dtype)

    cs_in = conv_state or {}
    xr, cs_x = _causal_conv(xr, params["conv_x"].to(xin.dtype), cs_in.get("x"))
    br, cs_b = _causal_conv(br, params["conv_B"].to(xin.dtype), cs_in.get("B"))
    cr, cs_c = _causal_conv(cr, params["conv_C"].to(xin.dtype), cs_in.get("C"))
    new_conv_state = {"x": cs_x, "B": cs_b, "C": cs_c}

    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())
    xh = xr.reshape(b, s, h, p)
    bm = br.reshape(b, s, g, n)
    cm = cr.reshape(b, s, g, n)

    if impl == "chunked" and s > 1:
        chunk = min(cfg.ssm_chunk, s)
        if s % chunk != 0:
            chunk = 1 << int(np.floor(np.log2(s)))
            chunk = max(1, min(chunk, s))
            while s % chunk != 0:
                chunk //= 2
        scan = functools.partial(ssd_chunked, chunk=chunk)
    else:
        scan = ssd_reference
    if is_dtensor(xh):
        y, final_state = _ssd_sharded(scan, xh, dt, params["A_log"], bm, cm, ssm_state)
    else:
        y, final_state = scan(xh, dt, params["A_log"], bm, cm, init_state=ssm_state)

    # skip connection D, gate, norm, out-projection
    y = y + xh.to(y.dtype) * params["D"].to(y.dtype)[None, None, :, None]
    y = y.reshape(b, s, cfg.d_inner)
    y = y * F.silu(z.to(y.dtype))
    yf = y.float()
    ms = yf.square().mean(dim=-1, keepdim=True)
    yf = yf * torch.rsqrt(ms + cfg.norm_eps) * params["norm"].float()
    y = yf.to(xin.dtype)
    out = y @ params["wo"].to(xin.dtype)
    return out, final_state, new_conv_state
