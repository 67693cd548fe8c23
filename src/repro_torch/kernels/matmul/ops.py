"""``matmul`` and ``chain_matmul`` on the hand-written Hopper GEMM.

``chain_matmul`` executes a :class:`repro_torch.expressions.ChainAlgorithm`'s
GEMM sequence with the kernel — the paper's algorithms running on the
port's own building block (the kernel-backed variant set for the
discriminant test at kernel level). Tiles default to
:data:`~repro_torch.kernels.matmul.matmul.DEFAULT_TILE`, a supported tile
(the reference's 256 x 256 x 512 default does not exist on Hopper).
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.expressions.algorithms import execute_steps
from repro_torch.expressions.chain import ChainAlgorithm

from .matmul import DEFAULT_TILE, matmul_kernel
from .ref import matmul_ref


def matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    block_m: int = DEFAULT_TILE[0],
    block_n: int = DEFAULT_TILE[1],
    block_k: int = DEFAULT_TILE[2],
    use_kernel: bool = True,
) -> torch.Tensor:
    """``a @ b`` in ``a.dtype``: the kernel (plain version for CPU tensors)
    or, with ``use_kernel=False``, the plain version on any device."""
    if use_kernel:
        return matmul_kernel(a, b, block_m=block_m, block_n=block_n, block_k=block_k)
    return matmul_ref(a, b)


def chain_matmul(
    alg: ChainAlgorithm,
    matrices: Sequence[torch.Tensor],
    *,
    use_kernel: bool = True,
    block_m: int = DEFAULT_TILE[0],
    block_n: int = DEFAULT_TILE[1],
    block_k: int = DEFAULT_TILE[2],
) -> torch.Tensor:
    """Execute one chain algorithm's instruction sequence with the kernel
    (asynchronously on the card: the caller synchronises)."""

    def gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return matmul(a, b, use_kernel=use_kernel,
                      block_m=block_m, block_n=block_n, block_k=block_k)

    return execute_steps(alg.steps, {f"M{i}": m for i, m in enumerate(matrices)}, gemm)
