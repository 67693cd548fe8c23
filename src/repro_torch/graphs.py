"""CUDA-graph capture: the port's counterpart of one XLA executable.

The reference compiles its ``jax.jit`` sites into XLA executables, each
launched as one unit: ``jit=True`` chain algorithms, the serving engine's
prefill and decode steps, and the timed thunks of the generalized families
and the autotune sites. On the card the port captures each one's launches
once into a CUDA graph and replays it (:func:`capture`, which waits for the
output, as a timer needs; :func:`capture_async`, which does not, as a
generation loop needs; :func:`measured_thunk` for the timed thunks):

- The function first runs eagerly on a side stream, outside the capture:
  one-time set-up (cuBLAS's workspace for that stream, the hand GEMM's
  once-per-instantiation ``cudaFuncSetAttribute``) must not be recorded.
- It is then captured once on the same stream. The graph, and its warm-up
  before it, allocate from a memory pool that no other live graph uses, so
  two graphs never alias each other's outputs however their replays
  interleave. When the replay is collected its pool goes back on its
  device's free list, and a later capture takes it (first returned, first
  taken; a new pool only when the list is empty): the blocks it
  already holds serve that capture, so a caller that builds and drops
  graphs verdict after verdict stops paying ``cudaMalloc`` and
  ``cudaFree`` for them. A tensor that outlives its graph stays an
  allocated block no later capture can take, and a capture's side stream
  waits for the current stream, where the dropped graph replayed, before
  it touches the pool. Pools on the free list stay reserved, whatever
  ``torch.cuda.empty_cache()`` does, until :func:`release_pools`. Getting a
  pool is the span ``rt.graph.pool.reused`` or ``rt.graph.pool.new``.
- The replay holds the graph, its output and the captured function: the
  graph reads the memory of the operands the function closes over, so
  they live as long as the replay does, whatever the caller drops.
- A capture that fails raises; nothing falls back to eager launches.
- The whole of it, warm-up to the streams' join, is the span
  ``rt.graph.capture`` (:mod:`repro_torch.spans`).

Each hand kernel counts its launches through :func:`count_launch`
(:meth:`repro_torch.kernels.build.HandKernel.count`): at once when it
launches, or, while a stream is being captured, at each replay of the graph
that recorded the launch. A kernel's counts are thus its real launches, and
a capture adds nothing to them.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import functools
import threading
import warnings
import weakref
from typing import Any, Callable, Deque, Dict, Iterator, List

import torch

from .device import block
from .spans import span

#: launches recorded by the captures in progress, innermost last
_recording: List[List[Callable[[], None]]] = []


def count_launch(bump: Callable[[], None]) -> None:
    """Count one launch of a hand kernel by calling ``bump`` now or, when
    the current stream is being captured by :func:`capture`, at each replay
    of the graph. A launch captured by anything else raises: its replays
    would launch the kernel uncounted."""
    if not torch.cuda.is_current_stream_capturing():
        bump()
        return
    if not _recording:
        raise RuntimeError(
            "a hand kernel was launched into a CUDA graph that "
            "repro_torch.graphs.capture does not own; its replays would go "
            "uncounted"
        )
    _recording[-1].append(bump)


@functools.lru_cache(maxsize=None)
def _capture_stream(index: int) -> torch.cuda.Stream:
    """One side stream a device for warm-ups and captures (cuBLAS keeps a
    workspace per stream: the warm-up sets it up for the capture)."""
    return torch.cuda.Stream(device=index)


#: per device index, the pools of dropped graphs in the order they came back
_free_pools: Dict[int, Deque[Any]] = {}
#: re-entrant: a collection inside a locked section may run a replay's finalizer
_pools_lock = threading.RLock()


class _Pool:
    """A memory pool on the current device that one graph at a time
    captures into. A ``torch.cuda.MemPool`` holds its device blocks. An
    empty graph captured into it, never replayed, keeps a graph on the pool
    at all times: the pinned-memory allocator keeps a pool whose last graph
    died at a use count of zero, and a later capture into it fails an
    internal assertion (torch 2.11)."""

    def __init__(self) -> None:
        self.mem = torch.cuda.MemPool()
        self.anchor = torch.cuda.CUDAGraph()
        with torch.cuda.stream(_capture_stream(torch.cuda.current_device())):
            self.anchor.capture_begin(pool=self.mem.id)
            with warnings.catch_warnings():
                warnings.filterwarnings("ignore", message="The CUDA Graph is empty")
                self.anchor.capture_end()


def _take_pool(index: int) -> Any:
    """A pool for one new graph on device ``index``: the one that came back
    to the device's free list first, else a new one. Graphs built together
    are dropped in the order they were built, so each graph of the next
    such build gets the pool that its counterpart grew."""
    with _pools_lock:
        free = _free_pools.get(index)
        pool = free.popleft() if free else None
    if pool is not None:
        with span("rt.graph.pool.reused"):
            return pool
    with span("rt.graph.pool.new"):
        return _Pool()


def _give_back(index: int, pool: Any) -> None:
    with _pools_lock:
        _free_pools.setdefault(index, collections.deque()).append(pool)


def _return_pool_with(owner: Any, index: int, pool: Any) -> None:
    """Put ``pool`` back on device ``index``'s free list once ``owner``, the
    only holder of the graph that uses it, is collected."""
    weakref.finalize(owner, _give_back, index, pool).atexit = False


def release_pools() -> None:
    """Drop every device's free list: a later ``torch.cuda.empty_cache()``
    can then return the pools' memory. Pools of live graphs are kept. Call
    it with no capture in progress on any thread: a pool destroyed during
    a capture aborts the process (torch 2.11)."""
    with _pools_lock:
        _free_pools.clear()


def capture_async(fn: Callable[[], Any], device: torch.device) -> Callable[[], Any]:
    """``fn``'s launches on ``device`` as one CUDA graph: warm ``fn`` up,
    capture it once and return a zero-arg callable that replays the graph
    on the current stream and returns ``fn``'s output (what it returned
    during capture, rewritten by every replay) without waiting for it."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    with span("rt.graph.capture"), torch.cuda.device(index):
        pool = _take_pool(index)
        side = _capture_stream(index)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side), torch.cuda.use_mem_pool(pool.mem, device=index):
            fn()
        graph = torch.cuda.CUDAGraph()
        launches: List[Callable[[], None]] = []
        _recording.append(launches)
        try:
            with torch.cuda.stream(side):
                graph.capture_begin(pool=pool.mem.id)
                try:
                    out = fn()
                finally:
                    graph.capture_end()
        finally:
            _recording.pop()
        torch.cuda.current_stream().wait_stream(side)

    def replay() -> Any:
        graph.replay()
        for bump in launches:
            bump()
        return out

    replay.fn = fn  # the operands fn closes over: the graph reads their memory
    _return_pool_with(replay, index, pool)
    return replay


def capture(fn: Callable[[], torch.Tensor], device: torch.device) -> Callable[[], torch.Tensor]:
    """:func:`capture_async`, whose replay waits for its output tensor."""
    replay = capture_async(fn, device)

    def run() -> torch.Tensor:
        return block(replay())

    return run


_eager_thunks = contextvars.ContextVar("eager_thunks", default=False)


@contextlib.contextmanager
def eager_thunks() -> Iterator[None]:
    """Measured thunks built inside this block run eagerly on the card too,
    one launch per operation: the yardstick of their graphs."""
    token = _eager_thunks.set(True)
    try:
        yield
    finally:
        _eager_thunks.reset(token)


def measured_thunk(fn: Callable[..., torch.Tensor], *tensors: torch.Tensor) -> Callable[[], torch.Tensor]:
    """The timed zero-arg thunk of ``fn(*tensors)``, the counterpart of the
    reference's jitted thunk. On CUDA tensors: one CUDA graph (:func:`capture`:
    eager warm-up, one capture, a replay that waits for the output; a capture
    that fails raises). On CPU tensors, or inside :func:`eager_thunks`: ``fn``
    runs once here (library set-up stays outside the timed region, as the
    reference's compile does) and each call runs it and waits."""
    device = tensors[0].device
    if device.type == "cuda" and not _eager_thunks.get():
        return capture(lambda: fn(*tensors), device)
    block(fn(*tensors))

    def run() -> torch.Tensor:
        return block(fn(*tensors))

    return run
