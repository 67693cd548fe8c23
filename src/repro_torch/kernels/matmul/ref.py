"""Plain PyTorch version of the hand-written GEMM (the CPU path and the
oracle the kernel is held against on the card)."""

from __future__ import annotations

from typing import Optional

import torch


def matmul_ref(
    a: torch.Tensor, b: torch.Tensor, out_dtype: Optional[torch.dtype] = None
) -> torch.Tensor:
    """f32 product cast to ``out_dtype`` (default ``a.dtype``), as the
    reference's ``jnp.dot(..., preferred_element_type=float32)``. Full f32
    on the card only with TF32 off (``torch.backends.cuda.matmul.allow_tf32``)."""
    return (a.float() @ b.float()).to(out_dtype or a.dtype)
