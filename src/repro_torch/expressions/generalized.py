"""Beyond-chain linear-algebra expression families.

Linnea-class generators emit variants for general expressions, not just
chains. We implement a small set of families whose variant spaces exercise
different mathematical identities (the paper's Sec. II situates chains within
this broader LAMP space):

* ``GramFamily``     — ``X = A Aᵀ B``: associativity + symmetry (``(AAᵀ)B``
  vs ``A(AᵀB)``; syrk-style half-FLOPs accounting for the symmetric product).
* ``DistributiveFamily`` — ``X = (A + B) C`` vs ``AC + BC``: distributivity
  *changes* the FLOP count (one GEMM vs two) — a family where FLOPs should
  discriminate strongly.
* ``SolveFamily``    — ``x = A⁻¹ b``: explicit inverse + GEMV vs LU solve —
  the canonical "never invert" example; FLOPs 2n³(inv) + 2n² vs ~(2/3)n³.
* ``BilinearFamily`` — ``y = uᵀ M v``: ``(uᵀM)v`` vs ``uᵀ(Mv)`` — equal
  FLOPs for square M, different memory-access patterns (row vs column
  traversal): the equal-FLOPs regime again.

Each family yields named variants with analytic FLOP counts and PyTorch
callables, pluggable into the same ranking pipeline as the chains. The
family factories, variant names and FLOP tables are the reference's
(``repro.expressions.generalized``), unchanged. The workloads are library
calls, as they were XLA's in the reference: ``torch.matmul`` (cuBLAS on the
card) and ``torch.linalg`` (cuSOLVER). Inputs come from a
``torch.Generator`` on the workload's device with the reference's scalings,
so their numbers differ from ``jax.random``'s; to run both packages on the
same bytes, make the inputs with numpy and pass them to
:meth:`ExpressionFamily.workloads_from_reference`.

Nothing runs when a family is constructed or its FLOP table read, so the
cost-model census backend never touches a device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, block, resolve_device
from .algorithms import inputs_from_reference


@dataclass(frozen=True)
class ExpressionVariant:
    name: str
    label: str
    flops: float
    build: Callable[..., Callable[[], Any]]  # (*tensors) -> thunk


@dataclass(frozen=True)
class ExpressionFamily:
    name: str
    variants: Tuple[ExpressionVariant, ...]
    make_inputs: Callable[[int, int, torch.device], List[torch.Tensor]]  # (size, seed, device)

    def flops_table(self) -> Dict[str, float]:
        return {v.name: v.flops for v in self.variants}

    def workloads(
        self, size: int, seed: int = 0, warmup: bool = True, device: DeviceLike = "cuda"
    ) -> Dict[str, Callable[[], Any]]:
        return self._table(self.make_inputs(size, seed, resolve_device(device)), warmup)

    def workloads_from_reference(
        self, arrays: Sequence[np.ndarray], warmup: bool = True, device: DeviceLike = "cuda"
    ) -> Dict[str, Callable[[], Any]]:
        """The family's workloads on the given inputs (numpy arrays, e.g.
        the reference's, bit for bit) instead of :attr:`make_inputs`'."""
        return self._table(inputs_from_reference(arrays, device=device), warmup)

    def _table(self, tensors: Sequence[torch.Tensor], warmup: bool) -> Dict[str, Callable[[], Any]]:
        table: Dict[str, Callable[[], Any]] = {}
        for v in self.variants:
            thunk = v.build(*tensors)
            if warmup:
                thunk()
            table[v.name] = thunk
        return table


def _thunk(fn: Callable[..., torch.Tensor], *tensors: torch.Tensor) -> Callable[[], torch.Tensor]:
    """Run ``fn`` once (library set-up stays outside the timed region, as
    the reference's compile does) and return a thunk that runs it and waits
    for the result."""
    block(fn(*tensors))

    def run() -> torch.Tensor:
        return block(fn(*tensors))

    return run


def _normal(gen: torch.Generator, shape: Tuple[int, ...], dev: torch.device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)


# ----------------------------------------------------------------- Gram ----

def gram_family(n: int, k: int) -> ExpressionFamily:
    """``X = A Aᵀ B`` with A: n×k, B: n×n."""

    def inputs(size: int, seed: int, dev: torch.device) -> List[torch.Tensor]:
        kk = max(1, int(k * size / n))
        gen = torch.Generator(device=dev).manual_seed(seed)
        a = _normal(gen, (size, kk), dev) / math.sqrt(kk)
        b = _normal(gen, (size, size), dev) / math.sqrt(size)
        return [a, b]

    def left_first(a, b):
        return _thunk(lambda a, b: (a @ a.T) @ b, a, b)

    def right_first(a, b):
        return _thunk(lambda a, b: a @ (a.T @ b), a, b)

    def left_syrk(a, b):
        # Symmetric rank-k update semantics: same math; in BLAS syrk halves
        # the FLOPs of AAᵀ. Like XLA, torch.matmul has no syrk — the
        # *analytic* count differs, which is the interesting case for the
        # discriminant test.
        return _thunk(lambda a, b: (a @ a.T) @ b, a, b)

    # FLOP accounting at the nominal size n (scaled at measurement time the
    # ratios are invariant, which is all RF needs).
    f_gemm_aat = 2 * n * n * k
    f_gemm_ab = 2 * n * n * n
    f_atb = 2 * k * n * n
    f_a_atb = 2 * n * k * n
    variants = (
        ExpressionVariant("gram_left", "(AAt)B", f_gemm_aat + f_gemm_ab, left_first),
        ExpressionVariant("gram_right", "A(AtB)", f_atb + f_a_atb, right_first),
        ExpressionVariant(
            "gram_left_syrk", "syrk(A)B", f_gemm_aat / 2 + f_gemm_ab, left_syrk
        ),
    )
    return ExpressionFamily("gram", variants, inputs)


# -------------------------------------------------------- Distributive ----

def distributive_family(n: int) -> ExpressionFamily:
    """``X = (A + B) C`` vs ``AC + BC`` (A, B, C: n×n)."""

    def inputs(size: int, seed: int, dev: torch.device) -> List[torch.Tensor]:
        gen = torch.Generator(device=dev).manual_seed(seed)
        return [_normal(gen, (size, size), dev) / math.sqrt(size) for _ in range(3)]

    def factored(a, b, c):
        return _thunk(lambda a, b, c: (a + b) @ c, a, b, c)

    def expanded(a, b, c):
        return _thunk(lambda a, b, c: a @ c + b @ c, a, b, c)

    variants = (
        ExpressionVariant("dist_factored", "(A+B)C", n * n + 2 * n**3, factored),
        ExpressionVariant("dist_expanded", "AC+BC", 4 * n**3 + n * n, expanded),
    )
    return ExpressionFamily("distributive", variants, inputs)


# ---------------------------------------------------------------- Solve ----

def solve_family(n: int) -> ExpressionFamily:
    """``x = A⁻¹ b``: explicit inverse vs LU solve (A: n×n SPD-ish)."""

    def inputs(size: int, seed: int, dev: torch.device) -> List[torch.Tensor]:
        gen = torch.Generator(device=dev).manual_seed(seed)
        a = _normal(gen, (size, size), dev) / math.sqrt(size)
        a = a @ a.T + size * torch.eye(size, dtype=torch.float32, device=dev)  # well-conditioned
        b = _normal(gen, (size,), dev)
        return [a, b]

    def via_inverse(a, b):
        return _thunk(lambda a, b: torch.linalg.inv(a) @ b, a, b)

    def via_solve(a, b):
        return _thunk(torch.linalg.solve, a, b)

    def via_cholesky(a, b):
        def f(a, b):
            l = torch.linalg.cholesky(a)
            y = torch.linalg.solve_triangular(l, b[:, None], upper=False)
            return torch.linalg.solve_triangular(l.T, y, upper=True)[:, 0]

        return _thunk(f, a, b)

    variants = (
        ExpressionVariant("solve_inverse", "inv(A)b", 2.0 * n**3 + 2.0 * n * n, via_inverse),
        ExpressionVariant("solve_lu", "solve(A,b)", (2.0 / 3.0) * n**3 + 2.0 * n * n, via_solve),
        ExpressionVariant("solve_chol", "chol-solve", (1.0 / 3.0) * n**3 + 2.0 * n * n, via_cholesky),
    )
    return ExpressionFamily("solve", variants, inputs)


# ------------------------------------------------------------- Bilinear ----

def bilinear_family(n: int) -> ExpressionFamily:
    """``y = uᵀ M v``: row-major vs column-major traversal, equal FLOPs."""

    def inputs(size: int, seed: int, dev: torch.device) -> List[torch.Tensor]:
        gen = torch.Generator(device=dev).manual_seed(seed)
        u = _normal(gen, (size,), dev)
        m = _normal(gen, (size, size), dev) / math.sqrt(size)
        v = _normal(gen, (size,), dev)
        return [u, m, v]

    def left(u, m, v):
        return _thunk(lambda u, m, v: (u @ m) @ v, u, m, v)

    def right(u, m, v):
        return _thunk(lambda u, m, v: u @ (m @ v), u, m, v)

    f = 2.0 * n * n + 2.0 * n
    variants = (
        ExpressionVariant("bilinear_left", "(utM)v", f, left),
        ExpressionVariant("bilinear_right", "ut(Mv)", f, right),
    )
    return ExpressionFamily("bilinear", variants, inputs)


FAMILIES: Dict[str, Callable[..., ExpressionFamily]] = {
    "gram": lambda n=512: gram_family(n, max(1, n // 4)),
    "distributive": lambda n=512: distributive_family(n),
    "solve": lambda n=512: solve_family(n),
    "bilinear": lambda n=1024: bilinear_family(n),
}
