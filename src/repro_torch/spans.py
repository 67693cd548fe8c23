"""Named spans of the program's stages, on the profiler's clock.

Wrap any call of the port in ``torch.profiler.profile`` and the trace names
the stage that was running at each moment, on the same clock as the
device's activity:

- ``rt.build``: an instance's or a site's workloads built (inputs, capture,
  warm-up), :func:`repro_torch.expressions.algorithms.build_workloads` and
  :meth:`repro_torch.autotune.variants.VariantSite.workloads`;
- ``rt.graph.capture``: one CUDA graph captured, its eager warm-up
  included (:func:`repro_torch.graphs.capture_async`);
- ``rt.graph.pool.reused`` or ``rt.graph.pool.new``, inside it: the
  capture's memory pool taken from its device's free list, or made because
  the list was empty;
- ``rt.measure``: one batch of samples of one workload, calibration
  included (:meth:`repro_torch.core.measure.WallClockTimer.measure_many`);
- ``rt.rank.step``: one Procedure-4 iteration
  (:meth:`repro_torch.core.session.MeasurementSession.step`);
- ``rt.rank.update``: its host work after the batch (store, shuffle, mean
  ranks, convergence norm, record);
- ``rt.inputs``: a chain instance's matrices drawn on the host and copied
  to the device (:func:`repro_torch.expressions.algorithms.make_chain_inputs`);
- ``rt.mla.cache``: latent attention's new latent rows written into its
  cache; ``rt.mla.expand``: the cached latents expanded into per-head K and
  V (the decompressed order); ``rt.mla.absorb``: W_UK folded into the
  queries, and W_UV applied to the latent output (the absorbed order, two
  spans a call) (:func:`repro_torch.models.mla.mla_attention`);
- ``rt.mla.pick.absorb`` or ``rt.mla.pick.decompress``: zero-length, one
  per call, at the dispatcher that chose the order
  (:func:`repro_torch.models.mla.pick_algorithm`): counters.

Spans fire where the host runs the program's Python: eagerly, in a
capture's warm-up and during the capture itself, never in a CUDA graph's
replay.

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
