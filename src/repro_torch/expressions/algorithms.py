"""Executable PyTorch implementations of chain algorithms.

Each :class:`~repro_torch.expressions.chain.ChainAlgorithm` lowers to a
sequence of GEMMs executed in the algorithm's instruction order, by
``torch.matmul`` (cuBLAS on the card, the counterpart of the reference's
``jnp.dot``) or by any other ``gemm(a, b)`` — e.g. the hand-written Hopper
GEMM of :mod:`repro_torch.kernels.matmul.ops`. The builder returns a
zero-argument callable that ends in ``torch.cuda.synchronize()`` for CUDA
tensors, suitable for :class:`repro_torch.core.WallClockTimer`.

``jit=True``, the reference's one XLA executable per algorithm, captures
the step sequence on the card once as a CUDA graph and replays it
(:func:`repro_torch.graphs.capture`); the synchronize stays outside the
graph. ``jit=False`` launches the steps eagerly one by one. On CPU tensors
both modes run eagerly.

Note on instruction order: under XLA, independent GEMMs inside one jitted
function may be reordered by the compiler, so two instruction orders of the
same parenthesization typically compile to identical HLO — i.e. they are
*equivalent algorithms*, which is exactly the situation the paper's
three-way comparison is designed to detect. A CUDA graph keeps the order of
its captured launches on one stream, and eager launches cannot reorder
either: the port runs the steps in the given order in both ``jit`` modes,
so order-distinct algorithms that tied under XLA may separate here. That is
a measurement, not a fault.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Mapping, Sequence

import numpy as np
import torch

from ..device import DeviceLike, block, resolve_device
from ..graphs import capture
from ..spans import span
from .chain import ChainAlgorithm, Step

Gemm = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def make_chain_inputs(
    dims: Sequence[int],
    dtype: torch.dtype = torch.float32,
    seed: int = 0,
    device: DeviceLike = "cuda",
) -> List[torch.Tensor]:
    """Concrete random matrices M0..M_{n-1} for a chain instance.

    Drawn from a CPU ``torch.Generator`` seeded with ``seed`` (so the CPU
    and the card get the same numbers), scaled by ``1/sqrt(cols)`` as in
    the reference. The numbers differ from ``jax.random``'s for the same
    seed: to hold the port against the reference on equal inputs, make them
    with numpy and pass them through :func:`inputs_from_reference`. The
    draw and the copy are the span ``rt.inputs``.
    """
    dev = resolve_device(device)
    with span("rt.inputs"):
        gen = torch.Generator().manual_seed(seed)
        return [
            (torch.randn((dims[i], dims[i + 1]), generator=gen) / math.sqrt(dims[i + 1]))
            .to(device=dev, dtype=dtype)
            for i in range(len(dims) - 1)
        ]


def inputs_from_reference(
    arrays: Sequence[np.ndarray], device: DeviceLike = "cuda"
) -> List[torch.Tensor]:
    """The reference's matrices (numpy arrays, e.g. ``np.asarray`` of a
    ``jax.Array``) as the port's tensors, bit for bit. bfloat16 arrays
    (``ml_dtypes``) go through float32, which holds every bf16 value."""
    dev = resolve_device(device)
    out = []
    for arr in arrays:
        arr = np.asarray(arr)
        if arr.dtype.name == "bfloat16":
            t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr, copy=True))
        out.append(t.to(dev))
    return out


def execute_steps(
    steps: Sequence[Step], operands: Mapping[str, torch.Tensor], gemm: Gemm
) -> torch.Tensor:
    env = dict(operands)
    last = None
    for dest, lhs, rhs in steps:
        env[dest] = gemm(env[lhs], env[rhs])
        last = env[dest]
    if last is None:
        raise ValueError("algorithm has no GEMM steps")
    return last


def build_algorithm_fn(
    alg: ChainAlgorithm,
    matrices: Sequence[torch.Tensor],
    jit: bool = True,
    gemm: Gemm = torch.matmul,
) -> Callable[[], torch.Tensor]:
    """Zero-arg callable running one algorithm to completion.

    With ``jit`` on CUDA tensors the steps are captured here, once, as a
    CUDA graph (after an eager warm-up on the capture stream), and each
    call replays it; a capture that fails raises. Otherwise each call
    launches the steps eagerly in instruction order.
    """
    operands = {f"M{i}": m for i, m in enumerate(matrices)}
    if jit and any(m.is_cuda for m in matrices):
        return capture(lambda: execute_steps(alg.steps, operands, gemm), matrices[0].device)

    def run() -> torch.Tensor:
        return block(execute_steps(alg.steps, operands, gemm))

    return run


def build_workloads(
    algs: Sequence[ChainAlgorithm],
    matrices: Sequence[torch.Tensor],
    jit: bool = True,
    warmup: bool = True,
    gemm: Gemm = torch.matmul,
) -> Dict[str, Callable[[], torch.Tensor]]:
    """name -> callable table for :class:`repro_torch.core.WallClockTimer`.

    With ``warmup=True`` each callable is executed once here so that
    library set-up ("library overheads", paper Sec. I step 1: cuBLAS
    handles, the hand GEMM's first load; with ``jit`` on the card, the
    graph's first replay) never lands inside a timed region. The whole
    build is the span ``rt.build``.
    """
    table: Dict[str, Callable[[], torch.Tensor]] = {}
    with span("rt.build"):
        for alg in algs:
            fn = build_algorithm_fn(alg, matrices, jit=jit, gemm=gemm)
            if warmup:
                fn()
            table[alg.name] = fn
    return table


def reference_product(matrices: Sequence[torch.Tensor]) -> torch.Tensor:
    """Left-to-right oracle product for correctness checks."""
    out = matrices[0]
    for m in matrices[1:]:
        out = torch.matmul(out, m)
    return out


def verify_algorithms(
    algs: Sequence[ChainAlgorithm],
    matrices: Sequence[torch.Tensor],
    rtol: float = 1e-4,
    atol: float = 1e-4,
) -> None:
    """Assert every algorithm computes the same product (mathematical
    equivalence — distinct parenthesizations differ only by fp rounding).
    The tolerances hold for float32 only without TF32."""
    ref = reference_product(matrices).double().cpu().numpy()
    for alg in algs:
        out = build_algorithm_fn(alg, matrices, jit=False)()
        np.testing.assert_allclose(
            out.double().cpu().numpy(), ref, rtol=rtol, atol=atol, err_msg=alg.name
        )
