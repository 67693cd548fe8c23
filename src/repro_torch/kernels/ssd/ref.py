"""Plain PyTorch version of the SSD chunk kernel: the sequential (primal)
scan, one step per token (the CPU path and the version the CUDA kernel is
held against on the card).

Layout matches the reference's kernel: head-flattened ``xbar [bh, s, p]``,
per-token decay logs ``logda [bh, s]``, B/C broadcast per head
``[bh, s, n]`` (``dt`` scaling and ``A = -exp(A_log)`` are applied by
``ops.py`` before either path).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def ssd_scan_ref(
    xbar: torch.Tensor,     # [bh, s, p] (dt-scaled inputs)
    logda: torch.Tensor,    # [bh, s]    (dt * A, negative)
    b_mat: torch.Tensor,    # [bh, s, n]
    c_mat: torch.Tensor,    # [bh, s, n]
    init_state: Optional[torch.Tensor] = None,  # [bh, p, n]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(y [bh, s, p] in xbar's dtype, final state [bh, p, n] f32)``."""
    bh, s, p = xbar.shape
    n = b_mat.shape[-1]
    x, lg = xbar.float(), logda.float()
    bm, cm = b_mat.float(), c_mat.float()
    state = (init_state.float() if init_state is not None
             else torch.zeros((bh, p, n), dtype=torch.float32, device=xbar.device))
    ys = []
    for t in range(s):
        da = torch.exp(lg[:, t])[:, None, None]
        state = state * da + x[:, t, :, None] * bm[:, t, None, :]
        ys.append(torch.einsum("bpn,bn->bp", state, cm[:, t]))
    y = torch.stack(ys, dim=1) if ys else x.new_zeros((bh, 0, p))
    return y.to(xbar.dtype), state
