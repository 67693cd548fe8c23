"""The yardstick's arithmetic: FLOP and byte formulas and the table of peaks.

Frozen copies, so that a later change to the program cannot move the
yardstick. A chain's algorithms are enumerated and numbered as the paper's
Expression 1 numbers them in the port (trees split left to right, stably
sorted by FLOPs, one algorithm per instruction order), but every count
here is the function's work, not an implementation's: a GEMM is 2mnk FLOPs
however it is computed (3xTF32 spends three tensor-core products per
useful one; they are not counted).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import List, Sequence, Tuple, Union

#: NVIDIA H100 SXM data sheet, dense: TF32 on the tensor cores, the fastest
#: rate at which the chip computes f32 inputs there, and HBM3 bandwidth.
PEAK_TF32_FLOPS = 494.7e12
PEAK_HBM_BYTES_PER_S = 3.35e12

Tree = Union[int, Tuple["Tree", "Tree"]]
Gemm = Tuple[int, int, int]  # (m, k, n) of one product [m, k] @ [k, n]


def gemm_flops(m: int, k: int, n: int) -> int:
    return 2 * m * k * n


def gemm_bytes(m: int, k: int, n: int, itemsize: int = 4) -> int:
    """Each input read once and the output written once."""
    return (m * k + k * n + m * n) * itemsize


def gemm_bound_s(m: int, k: int, n: int, itemsize: int = 4) -> float:
    """Least time the chip could take for one f32 GEMM."""
    return max(gemm_flops(m, k, n) / PEAK_TF32_FLOPS,
               gemm_bytes(m, k, n, itemsize) / PEAK_HBM_BYTES_PER_S)


@lru_cache(maxsize=None)
def trees(n: int) -> Tuple[Tree, ...]:
    """Every parenthesisation of a chain of ``n`` matrices, in the order in
    which a left-to-right split enumerates them."""

    def build(i: int, j: int) -> Tuple[Tree, ...]:
        if i == j:
            return (i,)
        return tuple((left, right) for k in range(i, j)
                     for left in build(i, k) for right in build(k + 1, j))

    return build(0, n - 1)


def _shape(tree: Tree, dims: Sequence[int]) -> Tuple[int, int]:
    if isinstance(tree, int):
        return dims[tree], dims[tree + 1]
    return _shape(tree[0], dims)[0], _shape(tree[1], dims)[1]


def tree_gemms(tree: Tree, dims: Sequence[int]) -> List[Gemm]:
    if isinstance(tree, int):
        return []
    m, k = _shape(tree[0], dims)
    n = _shape(tree[1], dims)[1]
    return tree_gemms(tree[0], dims) + tree_gemms(tree[1], dims) + [(m, k, n)]


def _internal(tree: Tree) -> int:
    return 0 if isinstance(tree, int) else 1 + _internal(tree[0]) + _internal(tree[1])


def _orders(tree: Tree) -> int:
    """Instruction orders of a tree: orderings of its products in which each
    comes after both of its operands' products."""
    if isinstance(tree, int):
        return 1
    a, b = _internal(tree[0]), _internal(tree[1])
    return _orders(tree[0]) * _orders(tree[1]) * math.comb(a + b, a)


def chain_algorithms(dims: Sequence[int]) -> List[Tuple[str, int, List[Gemm]]]:
    """(name, FLOPs, GEMM shapes) of every algorithm of the chain ``dims``
    (``len(dims)`` = matrices + 1), named ``algorithm0`` … in ascending
    FLOPs."""
    ordered = sorted(trees(len(dims) - 1),
                     key=lambda t: sum(gemm_flops(*g) for g in tree_gemms(t, dims)))
    out = []
    for tree in ordered:
        gemms = tree_gemms(tree, dims)
        flops = sum(gemm_flops(*g) for g in gemms)
        for _ in range(_orders(tree)):
            out.append((f"algorithm{len(out)}", flops, gemms))
    return out


def ssd_chunk_flops(b: int, s: int, h: int, p: int, n: int, q: int) -> float:
    """The ``ssd_chunk`` site's leading-order FLOPs at chunk length ``q``:
    scores C·Bᵀ (2qn), their product with the inputs (2qp), and the chunk
    states in and out (4pn), per token and head."""
    return float(b * s * h * (2 * q * n + 2 * q * p + 4 * p * n))
