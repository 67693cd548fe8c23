"""Kimi-Linear's forward pass by the published equations, in plain float32
torch: the yardstick that the port's KDA and latent-attention model is held
to.

It follows the Kimi Linear report (arXiv:2510.26692) and the published
configuration (moonshotai/Kimi-Linear-48B-A3B-Instruct, config.json) for
one sequence: per layer an RMS norm, then the mixer of the layer's kind,
then an RMS norm and the FFN (a dense MLP in the leading layers, the MoE
after them), each added to the residual stream.

* KDA, one token at a time: q, k, v = SiLU(causal depthwise conv of
  width 4 of W_{q,k,v} h), q and k L2-normalised per head and q scaled by
  d_k^-1/2; g = -exp(A_log) softplus(W_f_up W_f_down h + dt_bias), β =
  sigmoid(W_β h); S_t = (I - β_t k_t k_tᵀ) Diag(exp g_t) S_{t-1} + β_t k_t
  v_tᵀ, o_t = S_tᵀ q_t; y = W_o [RMSNorm_head(o) sigmoid(W_g_up W_g_down h)].
* Latent attention (NoPE) by the decompressed equations: per head the key
  [W_UK c, k_pe] and the value W_UV c, c the RMS-normed latent, k_pe the
  shared 64 channels, unrotated; causal softmax one head at a time, scale
  (dn + dr)^-1/2.
* MoE: sigmoid scores of all ``n_experts``, the top ``top_k`` renormalised
  and scaled by ``moe_routed_scale``; the held experts (``experts_held``)
  computed densely, every token through each, weighted by its routing
  weight (0 where the expert was not chosen); the shared expert, ungated.

It keeps no cache, takes no batch, imports nothing of the port, switches
TF32 off for its products, and reads the port's parameter tree
(``init_lm_params``'s values: ``lead``, ``units``, ``tail``), converting
one layer at a time to float32 on ``device``. The configuration is read by
attribute only.

Departures from the published code, shared with the port: the router's
selection bias (``e_score_correction_bias``) is zero, and the top-k
weights are divided by their sum without the published 1e-20; the L2 norm
is x / sqrt(Σx² + 1e-6), the report's kernels' form; the output gate's
low-rank projection has no bias (the report's equations); the held
experts' part alone is computed (one card's share of an expert-parallel
layer, as the port computes it).
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


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


def layers(cfg, params: Dict[str, Any]) -> List[Tuple[str, bool, Any]]:
    """(mixer kind "kda" or "attn", whether its FFN is the MoE, the layer's
    parameter tree) of every layer, first to last: the leading layers, the
    units, the tail."""
    unit = [str(getattr(k, "value", k)) for k in cfg.unit_kinds]
    tail = [str(getattr(k, "value", k)) for k in cfg.tail_kinds]
    n_lead = cfg.first_k_dense_replace
    n_units = (cfg.n_layers - n_lead - len(tail)) // len(unit)
    out = [(str(getattr(cfg.lead_kind, "value", cfg.lead_kind)), False, _layer(params["lead"], i))
           for i in range(n_lead)]
    for u in range(n_units):
        out += [(kind, True, _layer(params["units"][f"sub{j}"], u)) for j, kind in enumerate(unit)]
    out += [(kind, True, _layer(params["tail"][f"sub{j}"], 0)) for j, kind in enumerate(tail)]
    return out


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * w


def short_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SiLU of the causal depthwise convolution of x [s, c] with w [k, c]:
    y_t = Σ_i w_i x_{t-k+1+i}, zeros before the first token."""
    k = w.shape[0]
    xp = torch.cat([x.new_zeros((k - 1, x.shape[1])), x])
    return F.silu(sum(w[i] * xp[i: i + x.shape[0]] for i in range(k)))


def l2_norm(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().sum(dim=-1, keepdim=True) + 1e-6)


def kda(cfg, p: Dict[str, torch.Tensor], h: torch.Tensor) -> torch.Tensor:
    """Kimi Delta Attention of a whole sequence h [s, d], token by token."""
    s = h.shape[0]
    nh, dk = cfg.kda_heads, cfg.kda_head_dim
    q = l2_norm(short_conv(h @ p["wq"], p["conv_q"]).reshape(s, nh, dk)) * dk ** -0.5
    k = l2_norm(short_conv(h @ p["wk"], p["conv_k"]).reshape(s, nh, dk))
    v = short_conv(h @ p["wv"], p["conv_v"]).reshape(s, nh, dk)
    g = -torch.exp(p["A_log"])[:, None] * F.softplus((h @ p["wf_a"] @ p["wf_b"] + p["dt_bias"]).reshape(s, nh, dk))
    beta = torch.sigmoid(h @ p["wb"])                                     # [s, h]
    state = h.new_zeros((nh, dk, dk))
    o = torch.empty((s, nh, dk), dtype=h.dtype, device=h.device)
    for t in range(s):
        state = state * torch.exp(g[t])[:, :, None]
        u = beta[t][:, None] * (v[t] - torch.einsum("hkv,hk->hv", state, k[t]))
        state = state + k[t][:, :, None] * u[:, None, :]
        o[t] = torch.einsum("hkv,hk->hv", state, q[t])
    o = rms_norm(o, p["o_norm"], cfg.norm_eps) * torch.sigmoid(h @ p["wg_a"] @ p["wg_b"]).reshape(s, nh, dk)
    return o.reshape(s, nh * dk) @ p["wo"]


def attention(cfg, p: Dict[str, torch.Tensor], h: torch.Tensor) -> torch.Tensor:
    """Multi-head latent attention without rope, of h [s, d], causal."""
    s = h.shape[0]
    nh, r = cfg.n_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q = (h @ p["wq"].reshape(h.shape[1], -1)).reshape(s, nh, dn + dr)
    ckv = h @ p["wkv_a"]
    c = rms_norm(ckv[:, :r], p["kv_norm"], cfg.norm_eps)
    k_pe = ckv[:, r:]                                                     # [s, dr], all heads
    kv = (c @ torch.cat([p["wuk"], p["wuv"]], dim=-1).reshape(r, -1)).reshape(s, nh, dn + dv)
    future = torch.ones((s, s), dtype=torch.bool, device=h.device).triu(1)
    out = torch.empty((s, nh, dv), dtype=torch.float32, device=h.device)
    for i in range(nh):
        key = torch.cat([kv[:, i, :dn], k_pe], dim=-1)
        scores = (q[:, i] @ key.T) * (dn + dr) ** -0.5
        probs = torch.softmax(scores.masked_fill_(future, float("-inf")), dim=-1)
        out[:, i] = probs @ kv[:, i, dn:]
        del key, scores, probs
    return out.reshape(s, nh * dv) @ p["wo"].reshape(nh * dv, -1)


def mlp(p: Dict[str, torch.Tensor], h: torch.Tensor) -> torch.Tensor:
    """down(silu(gate(h)) * up(h)): ``wg`` the gate, ``wi`` up, ``wo`` down."""
    return (F.silu(h @ p["wg"]) * (h @ p["wi"])) @ p["wo"]


def moe(cfg, p: Dict[str, torch.Tensor], h: torch.Tensor) -> torch.Tensor:
    """Sigmoid router over all experts, top-k renormalised and scaled; the
    held experts densely; plus the shared expert."""
    scores = torch.sigmoid(h @ p["router"])
    weight, expert = torch.topk(scores, cfg.top_k, dim=-1)
    weight = weight / weight.sum(dim=-1, keepdim=True) * cfg.moe_routed_scale
    combine = torch.zeros_like(scores).scatter_(1, expert, weight)       # [s, n_experts]
    lo, hi = cfg.experts_held or (0, cfg.n_experts)
    y = mlp(p["shared"], h)
    for e in range(lo, hi):
        ep = {k: p[k][e - lo] for k in ("wi", "wg", "wo")}
        y = y + mlp(ep, h) * combine[:, e, None]
    return y


def forward(cfg, params: Dict[str, Any], tokens: torch.Tensor,
            rows: Optional[Sequence[int]] = None, device: Optional[torch.device] = None) -> torch.Tensor:
    """Logits [len(rows) or s, vocab] float32 of one sequence ``tokens`` [s]
    at the positions ``rows`` (all by default), the layers computed one at
    a time from ``params`` converted to float32 on ``device`` (the
    parameters' own by default)."""
    device = device or params["embed"]["table"].device
    tokens = tokens.to(device).long()
    eps = cfg.norm_eps
    with _no_tf32():
        x = params["embed"]["table"][tokens].to(device=device, dtype=torch.float32)
        for kind, is_moe, tree in layers(cfg, params):
            p = _f32(tree, device)
            if kind == "kda":
                x = x + kda(cfg, p["kda"], rms_norm(x, p["kda_norm"]["scale"], eps))
            else:
                x = x + attention(cfg, p["attn"], rms_norm(x, p["attn_norm"]["scale"], eps))
            h = rms_norm(x, p["ffn_norm"]["scale"], eps)
            x = x + (moe(cfg, p["moe"], h) if is_moe else mlp(p["mlp"], h))
            del p, h
        if rows is not None:
            x = x[torch.as_tensor(list(rows), device=device)]
        x = rms_norm(x, params["final_norm"]["scale"].to(device=device, dtype=torch.float32), eps)
        return x @ params["lm_head"]["w"].to(device=device, dtype=torch.float32)
