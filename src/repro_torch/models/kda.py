"""Kimi Delta Attention (KDA; the Kimi Linear report, arXiv:2510.26692), the
port's own: the reference has no linear attention.

Per head, with d_k = d_v the head width and x the normed hidden state:

* q, k, v = SiLU(ShortConv(W_{q,k,v} x)), each convolution depthwise and
  causal (:func:`~.mamba2._causal_conv`); q and k L2-normalised per head,
  q scaled by d_k^-1/2;
* g_t = -exp(A_log) * softplus(W_f_up W_f_down x_t + dt_bias), one decay
  rate per key channel (a projection of rank ``kda_gate_rank``), α_t =
  exp(g_t); β_t = sigmoid(W_β x_t), one per head;
* S_t = (I - β_t k_t k_tᵀ) Diag(α_t) S_{t-1} + β_t k_t v_tᵀ, o_t = S_tᵀ q_t
  (S [d_k, d_v]: a gated delta rule with a decay per channel);
* y = W_o [RMSNorm_head(o) * sigmoid(W_g_up W_g_down x)].

:func:`kda_chunked` computes the recurrence in chunks of C tokens by the
UT transform (the WY form of the delta rule); :func:`kda_recurrent` one
token at a time (the oracle, and the decode step). Within a chunk the
decay differs per channel, so the pairwise decays exp(Γ_t − Γ_s) (Γ the
cumulative g, non-increasing) cannot be factored as the SSD's scalar one
is, and a [C, C, d_k] tensor of them would take 34 GB at 16384 tokens.
Instead every factor used is exp of a non-positive number, so nothing
overflows and nothing is clamped: pairs below the diagonal sub-blocks (of
:data:`SUB` tokens) are factored at the start r of t's sub-block,
exp(Γ_t − Γ_r) · exp(Γ_r − Γ_s), both at most 1; pairs inside a diagonal
sub-block are taken pairwise (a group of chunks at a time, so that
their [.., 16, 16, d_k] temporaries stay within :data:`DIAG_ELEMENTS`);
the terms between chunks use the decays
from the chunk's start and to its end. Across chunks the state pass is a
sequence of matrix products, one chunk after another: the chunk length
trades FLOPs (:func:`~.flops.kda_chunk_flops`) against the loop's length,
the ``kda_chunk`` autotune site.

Spans (:mod:`repro_torch.spans`): ``rt.kda.conv``, ``rt.kda.gates``,
``rt.kda.chunk`` with ``rt.kda.pass`` inside it, ``rt.kda.state``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..spans import span
from .config import ModelConfig
from .layers import P, Params, normal_init, ones_init, param_dtype
from .mamba2 import _causal_conv

#: sub-block length of the chunked core's intra-chunk pairs
SUB = 16
#: the L2 norm's epsilon under the square root (the report's kernels')
L2_EPS = 1e-6
#: the largest temporary of the diagonal sub-blocks' pairwise decays, in
#: elements (1 GiB in f32): at 16384 tokens of 32 heads of 128 they hold
#: 2^30, taken in four groups of chunks
DIAG_ELEMENTS = 1 << 28


def init_kda(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """One KDA layer's weights: projections normal (std 0.02; the output
    0.02 / sqrt(2 n_layers)), convolutions normal (std 0.1), A_log = log
    U[1, 16] per head, dt_bias = softplus⁻¹ of a rate log-uniform in
    [1e-3, 1e-1] per key channel, the output norm's weight 1."""
    dt = param_dtype(cfg)
    dev = gen.device
    d, h, dk, r, kc = cfg.d_model, cfg.kda_heads, cfg.kda_head_dim, cfg.kda_gate_rank, cfg.kda_conv_kernel
    hd = h * dk
    out_std = 0.02 / np.sqrt(2 * cfg.n_layers)
    params = {
        "wq": normal_init(gen, (d, hd), ("embed", "ffn"), dt),
        "wk": normal_init(gen, (d, hd), ("embed", "ffn"), dt),
        "wv": normal_init(gen, (d, hd), ("embed", "ffn"), dt),
        "conv_q": normal_init(gen, (kc, hd), (None, "ffn"), dt, 0.1),
        "conv_k": normal_init(gen, (kc, hd), (None, "ffn"), dt, 0.1),
        "conv_v": normal_init(gen, (kc, hd), (None, "ffn"), dt, 0.1),
        "wf_a": normal_init(gen, (d, r), ("embed", None), dt),
        "wf_b": normal_init(gen, (r, hd), (None, "ffn"), dt),
        "wb": normal_init(gen, (d, h), ("embed", "heads"), dt),
        "wg_a": normal_init(gen, (d, r), ("embed", None), dt),
        "wg_b": normal_init(gen, (r, hd), (None, "ffn"), dt),
        "o_norm": ones_init((dk,), (None,), dt, dev),
        "wo": normal_init(gen, (hd, d), ("ffn", "embed"), dt, out_std),
    }
    a = torch.empty((h,), dtype=torch.float32, device=dev)
    rate = torch.empty((hd,), dtype=torch.float32, device=dev)
    if not a.is_meta:
        a.uniform_(1.0, 16.0, generator=gen)
        rate.uniform_(math.log(1e-3), math.log(1e-1), generator=gen).exp_()
    params["A_log"] = P(torch.log(a), ("heads",))
    params["dt_bias"] = P(rate + torch.log(-torch.expm1(-rate)), ("ffn",))  # softplus⁻¹(rate)
    return params


def init_kda_state(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                   device: torch.device) -> Dict[str, Any]:
    """A KDA layer's serving state: the recurrent state ``rec`` [b, h, d_k,
    d_v] (f32) and the convolutions' last k-1 inputs ``conv``."""
    h, dk, k = cfg.kda_heads, cfg.kda_head_dim, cfg.kda_conv_kernel
    return {"rec": torch.zeros((batch, h, dk, dk), dtype=torch.float32, device=device),
            "conv": {n: torch.zeros((batch, k - 1, h * dk), dtype=dtype, device=device)
                     for n in ("q", "k", "v")}}


# ------------------------------------------------------------------ core ---

def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """x / sqrt(Σx² + ε) over the last axis."""
    return x * torch.rsqrt(x.square().sum(dim=-1, keepdim=True) + L2_EPS)


def kda_recurrent(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                  beta: torch.Tensor, initial_state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence one token at a time, in f32: (o [b, s, h, d_v], final
    state [b, h, d_k, d_v]). q, k, g [b, s, h, d_k], v [b, s, h, d_v],
    beta [b, s, h]."""
    b, s, h, dk = k.shape
    state = (initial_state.float() if initial_state is not None
             else q.new_zeros((b, h, dk, v.shape[-1]), dtype=torch.float32))
    q, k, v, g, beta = (t.float() for t in (q, k, v, g, beta))
    outs = []
    for t in range(s):
        state = state * torch.exp(g[:, t])[..., None]
        u = beta[:, t, :, None] * (v[:, t] - torch.einsum("bhkv,bhk->bhv", state, k[:, t]))
        state = state + k[:, t, :, :, None] * u[:, :, None, :]
        outs.append(torch.einsum("bhkv,bhk->bhv", state, q[:, t]))
    return torch.stack(outs, dim=1), state


def _chunks(x: torch.Tensor, chunk: int) -> torch.Tensor:
    """[b, s, h, ...] (s a multiple of ``chunk``) as [n, b, h, C, ...]."""
    b, s, h = x.shape[:3]
    x = x.reshape((b, s // chunk, chunk, h) + x.shape[3:])
    return x.permute((1, 0, 3, 2) + tuple(range(4, x.dim()))).contiguous()


def kda_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                beta: torch.Tensor, chunk: int, initial_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence of :func:`kda_recurrent` in chunks of ``chunk`` tokens
    (a multiple of :data:`SUB`): (o [b, s, h, d_v] in v's dtype, final state
    [b, h, d_k, d_v] f32). A sequence that ``chunk`` does not divide is
    padded with tokens of β = 0 and g = 0, which leave the state as it is.

    Per chunk, Γ the cumulative g from its start (in f64, so that its
    differences keep their digits), A_ts = β_t Σ_c k_tc k_sc exp(Γ_tc − Γ_sc)
    (s < t) and P_ts = Σ_c q_tc k_sc exp(Γ_tc − Γ_sc) (s ≤ t); the UT
    transform solves (I + A) [W | U'] = β [exp(Γ) k | v]; then chunk by
    chunk from the incoming state S: U = U' − W S, O = exp(Γ) q S + P U,
    S ← exp(Γ_C) S + (exp(Γ_C − Γ) k)ᵀ U."""
    b, s, h, dk = k.shape
    dv = v.shape[-1]
    if chunk % SUB:
        raise ValueError(f"chunk {chunk} is not a multiple of {SUB}")
    with span("rt.kda.chunk"):
        pad = -s % chunk
        q, k, v, g, beta = (t.float() for t in (q, k, v, g, beta))
        if pad:
            q, k, v, g, beta = (torch.cat([t, t.new_zeros((b, pad) + t.shape[2:])], dim=1)
                                for t in (q, k, v, g, beta))
        n, ns = (s + pad) // chunk, chunk // SUB
        qc, kc, vc = _chunks(q, chunk), _chunks(k, chunk), _chunks(v, chunk)   # [n, b, h, C, d]
        bc = _chunks(beta, chunk)                                               # [n, b, h, C]
        gam = torch.cumsum(_chunks(g, chunk).double(), dim=-2)                 # Γ, f64
        sub = (n, b, h, ns, SUB, dk)
        starts = gam.view(sub)[..., :1, :]                                      # Γ_r per sub-block
        rel = (gam.view(sub) - starts).float()                                  # Γ_t − Γ_r ≤ 0
        inner = torch.exp(rel)
        k6, q6 = kc.view(sub), qc.view(sub)
        kt, qt = k6 * inner, q6 * inner

        # pairs below the diagonal sub-blocks, factored at t's sub-block start
        A = kc.new_zeros((n, b, h, chunk, chunk))
        Pm = kc.new_zeros((n, b, h, chunk, chunk))
        A6, P6 = A.view(n, b, h, ns, SUB, chunk), Pm.view(n, b, h, ns, SUB, chunk)
        for i in range(1, ns):
            r = i * SUB
            ks = (kc[..., :r, :] * torch.exp((starts[:, :, :, i] - gam[..., :r, :]).float())).transpose(-1, -2)
            A6[:, :, :, i, :, :r] = kt[:, :, :, i] @ ks
            P6[:, :, :, i, :, :r] = qt[:, :, :, i] @ ks
            del ks
        # pairs inside a diagonal sub-block, pairwise, a group of chunks at
        # a time so that no temporary passes DIAG_ELEMENTS
        causal = torch.ones((SUB, SUB), dtype=torch.bool, device=k.device).tril()
        step = max(1, DIAG_ELEMENTS // (b * h * ns * SUB * SUB * dk))
        a_diag, p_diag = [], []
        for z in range(0, n, step):
            rz, kz = rel[z:z + step], k6[z:z + step]
            ks = torch.exp(torch.where(causal[:, :, None], rz[..., :, None, :] - rz[..., None, :, :],
                                       -math.inf)) * kz[..., None, :, :]        # [.., t, s, d_k]
            a_diag.append((ks @ kz[..., None]).squeeze(-1))
            p_diag.append((ks @ q6[z:z + step, ..., None]).squeeze(-1))
            del ks
        a_diag = torch.cat(a_diag).masked_fill(~causal.tril(-1), 0.0)
        p_diag = torch.cat(p_diag)
        A.view(n, b, h, ns, SUB, ns, SUB).diagonal(dim1=3, dim2=5).copy_(a_diag.permute(0, 1, 2, 4, 5, 3))
        Pm.view(n, b, h, ns, SUB, ns, SUB).diagonal(dim1=3, dim2=5).copy_(p_diag.permute(0, 1, 2, 4, 5, 3))
        A = A * bc[..., None]

        # the terms between chunks: decays from the chunk's start, to its end
        last = gam[..., -1:, :]
        from_start = torch.exp(gam.float())
        k_start, q_start = kc * from_start, qc * from_start
        k_end = (kc * torch.exp((last - gam).float())).transpose(-1, -2)        # [n, b, h, d_k, C]
        chunk_decay = torch.exp(last.float()).transpose(-1, -2)                 # [n, b, h, d_k, 1]
        del gam, from_start

        # the UT transform: (I + A) X = β [exp(Γ) k | v]
        rhs = torch.cat([k_start, vc], dim=-1) * bc[..., None]
        x = torch.linalg.solve_triangular(A, rhs, upper=False, unitriangular=True)
        w, u0 = x[..., :dk], x[..., dk:]

        state = (initial_state.float() if initial_state is not None
                 else kc.new_zeros((b, h, dk, dv)))
        prev, us = [], []
        with span("rt.kda.pass"):
            for z in range(n):
                prev.append(state)
                u = u0[z] - w[z] @ state
                us.append(u)
                state = chunk_decay[z] * state + k_end[z] @ u
        o = q_start @ torch.stack(prev) + Pm @ torch.stack(us)                  # [n, b, h, C, d_v]
        o = o.permute(1, 0, 3, 2, 4).reshape(b, n * chunk, h, dv)[:, :s]
    return o.to(v.dtype), state


# ----------------------------------------------------------------- mixer ---

def kda_gates(cfg: ModelConfig, params: Params, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(g [b, s, h, d_k], β [b, s, h]) of hidden states x [b, s, d], f32."""
    b, s, _ = x.shape
    h, dk = cfg.kda_heads, cfg.kda_head_dim
    with span("rt.kda.gates"):
        f = (x @ params["wf_a"].to(x.dtype)) @ params["wf_b"].to(x.dtype)
        g = -torch.exp(params["A_log"].float())[:, None] * F.softplus(
            (f.float() + params["dt_bias"].float()).view(b, s, h, dk))
        beta = torch.sigmoid((x @ params["wb"].to(x.dtype)).float())
    return g, beta


def apply_kda(cfg: ModelConfig, params: Params, x: torch.Tensor, mode: str = "train",
              state: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """The KDA sublayer's output [b, s, d] for normed hidden states x.

    ``mode`` train: from a zero state, nothing kept. prefill: from a zero
    state, the final recurrent state and the convolutions' windows written
    into ``state`` in place. extend and decode: from ``state``, written
    back in place; a decode step (one token) applies the recurrence
    directly and reads nothing on the host, so that it can be captured as
    one CUDA graph."""
    b, s, _ = x.shape
    h, dk = cfg.kda_heads, cfg.kda_head_dim
    carried = state if mode in ("extend", "decode") else None
    with span("rt.kda.conv"):
        qkv = {}
        for n in ("q", "k", "v"):
            proj = x @ params[f"w{n}"].to(x.dtype)
            qkv[n], window = _causal_conv(proj, params[f"conv_{n}"].to(x.dtype),
                                          carried["conv"][n] if carried else None)
            if state is not None:
                state["conv"][n].copy_(window)
    q = l2_normalize(qkv["q"].float().view(b, s, h, dk)) * dk ** -0.5
    k = l2_normalize(qkv["k"].float().view(b, s, h, dk))
    v = qkv["v"].float().view(b, s, h, dk)
    g, beta = kda_gates(cfg, params, x)
    initial = carried["rec"] if carried else None
    if mode == "decode":
        with span("rt.kda.state"):
            o, final = kda_recurrent(q, k, v, g, beta, initial)
            state["rec"].copy_(final)
    else:
        o, final = kda_chunked(q, k, v, g, beta, min(cfg.kda_chunk, -(-s // SUB) * SUB), initial)
        if state is not None:
            with span("rt.kda.state"):
                state["rec"].copy_(final)
    o = o * torch.rsqrt(o.square().mean(dim=-1, keepdim=True) + cfg.norm_eps) * params["o_norm"].float()
    gate = torch.sigmoid(((x @ params["wg_a"].to(x.dtype)) @ params["wg_b"].to(x.dtype)).float())
    y = (o.reshape(b, s, h * dk) * gate).to(x.dtype)
    return y @ params["wo"].to(x.dtype)
