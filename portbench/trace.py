"""The profiler's trace of a window, reduced in memory to what the readers need.

``Tracer`` wraps ``torch.profiler`` (CPU and, on the card, CUDA activity)
around the measured window and marks it with the annotation ``pb.window``.
The drivers mark their phases (``pb.inputs``, ``pb.build``, ``pb.rank`` …)
and each timed call (``pb.call:<i>``) with ``record_function``; outside a
traced run the marks cost nothing. Nothing of the trace is written to disk.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import torch

Interval = Tuple[int, int]


@dataclass
class TraceData:
    window: Interval                                    # ns
    device: List[Tuple[int, int, str, int]]             # start, end, name, correlation
    host: List[Tuple[int, int, str, int]]
    calls: Dict[int, Interval] = field(default_factory=dict)  # pb.call:<i> spans

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy(self) -> List[Interval]:
        """Union of the device's activity, clipped to the window."""
        lo, hi = self.window
        merged: List[List[int]] = []
        for start, end, _, _ in sorted(self.device):
            start, end = max(start, lo), min(end, hi)
            if end <= start:
                continue
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([start, end])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) / 1e9

    def device_ops(self, top: int = 10) -> List[List]:
        """Device seconds by operation name, largest first."""
        total: Dict[str, int] = defaultdict(int)
        for start, end, name, _ in self.device:
            total[name] += end - start
        return [[name, ns / 1e9] for name, ns in
                sorted(total.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """The device's idle seconds in the window by what the host was
        doing: the innermost host event (an operator, a runtime call, a
        phase mark) running at the middle of each gap."""
        lo, hi = self.window
        gaps, cursor = [], lo
        for a, b in self.busy():
            if a > cursor:
                gaps.append((cursor, a))
            cursor = max(cursor, b)
        if hi > cursor:
            gaps.append((cursor, hi))
        host = sorted(self.host, key=lambda e: (e[0], -e[1]))
        total: Dict[str, int] = defaultdict(int)
        stack: List[Tuple[int, int, str, int]] = []
        i = 0
        for a, b in gaps:  # gaps are in time order: one sweep with a stack
            mid = (a + b) // 2
            while i < len(host) and host[i][0] <= mid:
                while stack and stack[-1][1] < host[i][0]:
                    stack.pop()
                stack.append(host[i])
                i += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            name = stack[-1][2] if stack else "untraced host work"
            total[name[:name.index(":")] if name.startswith("pb.call:") else name] += b - a
        return [[name, ns / 1e9] for name, ns in
                sorted(total.items(), key=lambda kv: -kv[1])[:top]]

    def call_device_s(self) -> Dict[int, float]:
        """Device seconds of the work launched inside each ``pb.call:<i>``
        span: kernels whose launch (a CUDA runtime or driver call, matched by
        correlation) lies in the span."""
        spans = sorted((a, b, i) for i, (a, b) in self.calls.items())
        starts = [s[0] for s in spans]
        owner: Dict[int, int] = {}
        for start, _, name, corr in self.host:
            if corr <= 0 or not name.startswith("cu"):  # runtime and driver calls only
                continue
            k = bisect.bisect_right(starts, start) - 1
            if k >= 0 and start <= spans[k][1]:
                owner[corr] = spans[k][2]
        out: Dict[int, float] = defaultdict(float)
        for start, end, _, corr in self.device:
            if corr in owner:
                out[owner[corr]] += (end - start) / 1e9
        return dict(out)


class Tracer:
    """Traces the window when ``on``; otherwise every mark is a no-op."""

    def __init__(self, on: bool, cuda: bool):
        self.on = on
        self.cuda = cuda
        self._prof = None
        self.data: Optional[TraceData] = None

    def mark(self, name: str):
        if not self.on or self._prof is None:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    @contextlib.contextmanager
    def window(self) -> Iterator[None]:
        if not self.on:
            yield
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        try:
            with torch.profiler.record_function("pb.window"):
                yield
        finally:
            if self.cuda:
                torch.cuda.synchronize()
            self._prof.__exit__(None, None, None)
            self.data = self._reduce(self._prof.profiler.kineto_results.events())
            self._prof = None

    @staticmethod
    def _reduce(events) -> TraceData:
        device, host, calls = [], [], {}
        window = None
        for e in events:
            name = e.name()
            start, end = e.start_ns(), e.end_ns()
            if "CUDA" in str(e.device_type()):
                if not name.startswith("pb."):  # the marks' projections onto the device's timeline
                    device.append((start, end, name, e.correlation_id()))
                continue
            host.append((start, end, name, e.correlation_id()))
            if name == "pb.window":
                window = (start, end)
            elif name.startswith("pb.call:"):
                calls[int(name[8:])] = (start, end)
        if window is None:
            raise RuntimeError("the trace holds no pb.window span")
        return TraceData(window=window, device=device, host=host, calls=calls)
