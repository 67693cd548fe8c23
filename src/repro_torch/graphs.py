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
- It is then captured once on the same stream. The graph allocates from a
  private memory pool of its own, so two graphs never alias each other's
  outputs however their replays interleave, and the pool is freed with
  the graph.
- The replay holds the graph, its output and the captured function: the
  graph reads the memory of the operands the function closes over, so
  they live as long as the replay does, whatever the caller drops.
- A capture that fails raises; nothing falls back to eager launches.
- The whole of it, warm-up to the streams' join, is the span
  ``rt.graph.capture`` (:mod:`repro_torch.spans`).

The hand GEMM's wrapper counts its launches through :func:`count_launch`:
at once when it launches, or, while a stream is being captured, at each
replay of the graph that recorded the launch. The counter thus counts the
kernel's real launches, and a capture adds nothing to it. (Flash attention
and the SSD scan are never captured: their wrappers count directly.)
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import Any, Callable, Iterator, List

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


def capture_async(fn: Callable[[], Any], device: torch.device) -> Callable[[], Any]:
    """``fn``'s launches on ``device`` as one CUDA graph: warm ``fn`` up,
    capture it once and return a zero-arg callable that replays the graph
    on the current stream and returns ``fn``'s output (what it returned
    during capture, rewritten by every replay) without waiting for it."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    with span("rt.graph.capture"), torch.cuda.device(index):
        side = _capture_stream(index)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        graph = torch.cuda.CUDAGraph()
        launches: List[Callable[[], None]] = []
        _recording.append(launches)
        try:
            with torch.cuda.stream(side):
                graph.capture_begin()  # no pool given: a private pool of its own
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
