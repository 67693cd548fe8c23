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

import contextlib
import math
import os
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from contextvars import ContextVar
from typing import Callable, Deque, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, block, resolve_device
from ..graphs import capture
from ..spans import span
from .chain import ChainAlgorithm, Step

Gemm = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def draw_chain_inputs(dims: Sequence[int], seed: int = 0) -> List[torch.Tensor]:
    """The host's draw of :func:`make_chain_inputs`: f32 CPU matrices
    M0..M_{n-1}, in order, from one CPU ``torch.Generator`` seeded with
    ``seed``, each scaled by ``1/sqrt(cols)``."""
    gen = torch.Generator().manual_seed(seed)
    return [
        torch.randn((dims[i], dims[i + 1]), generator=gen) / math.sqrt(dims[i + 1])
        for i in range(len(dims) - 1)
    ]


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
    draw and the copy are the span ``rt.inputs``, on the caller's thread.

    Inside :func:`drawing_ahead` (a census on a CUDA device) an instance
    planned ahead was drawn on a host thread by the same seeded generator,
    so the matrices are the same bytes: ``rt.inputs`` then spans the wait
    for the rest of its draw, if any, and the copy.
    """
    dev = resolve_device(device)
    ahead = _AHEAD.get()
    with span("rt.inputs"):
        host = ahead.take(dims, seed) if ahead is not None else None
        if host is None:
            host = draw_chain_inputs(dims, seed)
        return [m.to(device=dev, dtype=dtype) for m in host]


_Key = Tuple[Tuple[int, ...], int]


def _key(dims: Sequence[int], seed: int) -> _Key:
    return tuple(int(d) for d in dims), int(seed)


class DrawAhead:
    """Chain instances' host matrices drawn ahead on a few host threads.

    :meth:`plan` queues instances ``(dims, seed)`` in the order the caller
    will build them and starts their draws, each by
    :func:`draw_chain_inputs` on its own seeded generator, so the bytes do
    not depend on which thread draws or when it finishes. At most
    ``workers`` instances are drawn and not yet taken: ``workers`` is the
    plan's length, capped at the usable cores less the caller's one, and
    at least 1. :meth:`take` hands one instance's matrices to the caller,
    which copies them to the device, raises there what its draw raised,
    and starts the next queued draw. :meth:`close` drops what was not
    taken and joins the threads. Nothing is kept once taken.
    """

    def __init__(self) -> None:
        self.workers = 1
        self._queued: Deque[_Key] = deque()
        self._drawing: Dict[_Key, Future] = {}
        self._pool: Optional[ThreadPoolExecutor] = None

    def plan(self, jobs: Sequence[Tuple[Sequence[int], int]]) -> None:
        cores = max(1, len(os.sched_getaffinity(0)) - 1)
        self.workers = max(1, min(len(jobs), cores))
        self._queued.extend(_key(dims, seed) for dims, seed in jobs)
        if self._pool is None and self._queued:
            self._pool = ThreadPoolExecutor(cores, thread_name_prefix="rt-draw")
        self._start()

    def _start(self) -> None:
        while self._queued and len(self._drawing) < self.workers:
            key = self._queued.popleft()
            self._drawing[key] = self._pool.submit(draw_chain_inputs, *key)

    def take(self, dims: Sequence[int], seed: int) -> Optional[List[torch.Tensor]]:
        """The host matrices of a planned instance, waiting for its draw if
        need be (the counter ``rt.inputs.ready`` or ``rt.inputs.waited``);
        None for an instance not being drawn, which the caller draws."""
        key = _key(dims, seed)
        future = self._drawing.pop(key, None)
        if future is None:
            return None
        with span("rt.inputs.ready" if future.done() else "rt.inputs.waited"):
            pass
        try:
            return future.result()
        finally:
            self._start()

    def close(self) -> None:
        self._queued.clear()
        self._drawing.clear()
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None


_AHEAD: ContextVar[Optional[DrawAhead]] = ContextVar("repro_torch_draw_ahead", default=None)


def draws_ahead(device: DeviceLike) -> bool:
    """Whether a census building on ``device`` draws its chain instances
    ahead: only where its workloads run on a CUDA device. On the CPU a
    draw beside the timed workloads would perturb their times."""
    return torch.device(device).type == "cuda"


@contextlib.contextmanager
def drawing_ahead(device: DeviceLike) -> Iterator[None]:
    """While open, :func:`plan_chain_inputs` starts draws that
    :func:`make_chain_inputs` takes, if :func:`draws_ahead` on ``device``;
    otherwise nothing changes. On exit no draw thread is left.

    The draw-ahead is the current context's (a ``ContextVar``): the
    census's builders are reached through the family registry, whose
    ``entry`` takes only the instance."""
    if not draws_ahead(device):
        yield
        return
    ahead = DrawAhead()
    token = _AHEAD.set(ahead)
    try:
        yield
    finally:
        _AHEAD.reset(token)
        ahead.close()


def plan_chain_inputs(jobs: Sequence[Tuple[Sequence[int], int]]) -> None:
    """Start drawing the instances ``(dims, seed)``, in the order they will
    be built, inside :func:`drawing_ahead`; elsewhere a no-op."""
    ahead = _AHEAD.get()
    if ahead is not None:
        ahead.plan(jobs)


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
