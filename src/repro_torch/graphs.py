"""CUDA-graph capture: the port's counterpart of one XLA executable.

The reference compiles a ``jit=True`` chain algorithm into one XLA
executable, launched as one unit. On the card the port captures the
algorithm's launches once into a CUDA graph and replays it
(:func:`capture`):

- The function first runs eagerly on a side stream, outside the capture:
  one-time set-up (cuBLAS's workspace for that stream, the hand GEMM's
  once-per-instantiation ``cudaFuncSetAttribute``) must not be recorded.
- It is then captured once on the same stream. The graph allocates from a
  private memory pool of its own, so two graphs never alias each other's
  outputs however their replays interleave, and the pool is freed with
  the graph.
- A capture that fails raises; nothing falls back to eager launches.

The hand GEMM's wrapper counts its launches through :func:`count_launch`:
at once when it launches, or, while a stream is being captured, at each
replay of the graph that recorded the launch. The counter thus counts the
kernel's real launches, and a capture adds nothing to it. (Flash attention
and the SSD scan are never captured: their wrappers count directly.)
"""

from __future__ import annotations

import functools
from typing import Callable, List

import torch

from .device import block

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


def capture(fn: Callable[[], torch.Tensor], device: torch.device) -> Callable[[], torch.Tensor]:
    """``fn``'s launches on ``device`` as one CUDA graph: warm ``fn`` up,
    capture it once and return a zero-arg callable that replays the graph
    and waits for its output (the tensor ``fn`` returned during capture,
    rewritten by every replay)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    with torch.cuda.device(index):
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

    def replay() -> torch.Tensor:
        graph.replay()
        for bump in launches:
            bump()
        return block(out)

    return replay
