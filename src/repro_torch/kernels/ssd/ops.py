"""``ssd_mix``: the Mamba-2 mixer's layout plumbing around the SSD kernel.

Takes the mixer's natural layout (``x [b, s, h, p]``, ``dt [b, s, h]``,
``A_log [h]``, ``B/C [b, s, g, n]``) and precomputes the kernel's inputs
(``xbar = dt * x``, ``logda = dt * A`` with ``A = -exp(A_log)``). The kernel
route reads each head's B/C group in place; ``use_kernel=False`` repeats the
groups to heads, flattens heads and runs the plain sequential scan, as the
reference's wrapper does.
"""

from __future__ import annotations

import torch

from .ref import ssd_scan_ref
from .ssd import heads_flat, ssd_scan_kernel


def ssd_mix(
    x: torch.Tensor,        # [b, s, h, p]
    dt: torch.Tensor,       # [b, s, h] (positive)
    a_log: torch.Tensor,    # [h]
    b_mat: torch.Tensor,    # [b, s, g, n]
    c_mat: torch.Tensor,    # [b, s, g, n]
    *,
    chunk: int = 256,
    use_kernel: bool = True,
) -> torch.Tensor:
    """SSD output ``[b, s, h, p]`` in ``x``'s dtype: the kernel (plain
    version for CPU tensors) or, with ``use_kernel=False``, the plain scan."""
    b, s, h, p = x.shape
    a = -torch.exp(a_log.float())
    logda = dt.float() * a                                # [b, s, h]
    xbar = x.float() * dt.float()[..., None]              # [b, s, h, p]
    if use_kernel:
        y = ssd_scan_kernel(xbar, logda, b_mat, c_mat, chunk=chunk)
    else:
        yf, _ = ssd_scan_ref(*heads_flat(xbar, logda, b_mat, c_mat))
        y = yf.reshape(b, h, s, p).transpose(1, 2)
    return y.to(x.dtype)
