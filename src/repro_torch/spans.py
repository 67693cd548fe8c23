"""Named spans of the program's stages, on the profiler's clock.

Wrap any call of the port in ``torch.profiler.profile`` and the trace names
the stage that was running at each moment, on the same clock as the
device's activity:

- ``rt.build``: an instance's or a site's workloads built (inputs, capture,
  warm-up), :func:`repro_torch.expressions.algorithms.build_workloads` and
  :meth:`repro_torch.autotune.variants.VariantSite.workloads`;
- ``rt.graph.capture``: one CUDA graph captured, its eager warm-up
  included (:func:`repro_torch.graphs.capture_async`);
- ``rt.measure``: one batch of samples of one workload, calibration
  included (:meth:`repro_torch.core.measure.WallClockTimer.measure_many`);
- ``rt.rank.step``: one Procedure-4 iteration
  (:meth:`repro_torch.core.session.MeasurementSession.step`);
- ``rt.rank.update``: its host work after the batch (store, shuffle, mean
  ranks, convergence norm, record).

Each span is a host event of kind ``cpu_op``; unlike ``record_function``'s
user annotations, the profiler never projects it onto the device's
timeline. Names are fixed, so they aggregate. There is nothing to switch
on: with no profiler running, :func:`span` reads the profiler's flag and
returns a shared ``nullcontext``.
"""

from __future__ import annotations

import contextlib
import sys
from typing import ContextManager

_OFF = contextlib.nullcontext()


def span(name: str) -> ContextManager:
    """A span named ``name`` while a profiler runs; otherwise a no-op.

    Imports nothing: a process that never imported torch runs no profiler,
    so the cost-model paths stay free of torch."""
    profiler = sys.modules.get("torch.autograd.profiler")
    if profiler is None or not profiler._is_profiler_enabled:
        return _OFF
    import torch

    return torch._C._profiler._RecordFunctionFast(name)
