"""The plain reference of the ``kda-prefill-16k`` cell: Kimi Delta
Attention's recurrence one token at a time, by the published equations.

Plain PyTorch, importing nothing of the program, in float64: per token
S ← Diag(exp g_t) S, u = β_t (v_t − Sᵀ k_t), S ← S + k_t uᵀ, o_t = Sᵀ q_t
(S = S_{t-1} decayed, then the delta rule's update), from each sequence's
incoming state; the output and the final state. The control computes the
same in float32 with the operands of its three products (Sᵀ k, k uᵀ and
Sᵀ q) rounded to TF32.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .reference import tf32


def recurrence(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
               beta: torch.Tensor, state: torch.Tensor, control: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o [b, s, h, d_v], final state [b, h, d_k, d_v]) of q, k, g [b, s,
    h, d_k], v [b, s, h, d_v], beta [b, s, h] from ``state``."""
    if control:
        rnd, dt = tf32, torch.float32
    else:
        rnd, dt = (lambda t: t), torch.float64
    q, k, v, g, beta, state = (t.to(dt) for t in (q, k, v, g, beta, state))
    out = torch.empty(v.shape, dtype=dt, device=v.device)
    for t in range(q.shape[1]):
        state = state * torch.exp(g[:, t])[..., None]
        kt = rnd(k[:, t])
        u = beta[:, t, :, None] * (v[:, t] - (rnd(state) * kt[..., None]).sum(-2))
        state = state + kt[..., None] * rnd(u)[:, :, None, :]
        out[:, t] = (rnd(state) * rnd(q[:, t])[..., None]).sum(-2)
    return out, state
