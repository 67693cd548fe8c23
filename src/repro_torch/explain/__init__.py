"""repro_torch.explain — AnomalyExplainer: root-cause attribution for census
anomalies.

The paper stops at *detecting* anomalies ("an anomaly ... can then be used
in the investigation of the root cause of performance differences"); this
package performs that investigation, ELAPS-style, by decomposing each
algorithm into its kernel sequence and reconciling measured segment times
against a per-kernel roofline floor:

* :mod:`repro_torch.explain.decompose` — algorithm -> kernel sequence
  (GEMM/GEMV/SYRK/solve calls with shapes, exact analytic FLOPs/bytes),
  plus isolated-kernel PyTorch workloads for wall-clock re-measurement
  on an explicit device.
* :mod:`repro_torch.explain.attribution` — per-kernel efficiency factors: median
  measured segment time over the :class:`~repro_torch.roofline.MachineSpec`
  roofline prediction, rolled up into whole-algorithm attributions with a
  dispatch/overhead residual.
* :mod:`repro_torch.explain.distributions` — distribution-level statistics over
  the segment samples: the 2-means mode-mixture test (turbo/frequency
  regimes) and the median-gap significance behind the re-ranking probe.
* :mod:`repro_torch.explain.classify` — the cause taxonomy
  (``shape_kernel_efficiency`` / ``memory_bound_segment`` /
  ``dispatch_overhead`` / ``frequency_bimodality`` / ``cache_reuse_pair``
  / ``not_reproducible`` / ``unexplained``) with a numeric evidence score
  per cause (gap fraction explained, distribution share, or probe flip
  probability — see the module docstring).
* :mod:`repro_torch.explain.calibrate` — per-machine dispatch/GEMM-efficiency
  calibration from micro-measurements, so tiny-instance memory-vs-dispatch
  splits reconcile against the floor the machine actually has. CLI:
  ``python -m repro_torch explain calibrate``.
* :mod:`repro_torch.explain.runner` — :class:`ExplainSpec` + sharded, resumable
  explanation campaigns on the :class:`~repro_torch.core.engine.ExperimentEngine`
  (kill/resume byte-identical for the deterministic census backends),
  mirroring the DiscriminantSweep layout. CLI:
  ``python -m repro_torch explain``.

Nothing touches a device until a wall-clock workload is built, so
cost-model explanation workers stay as light as census workers. The
package's exports are the reference's ``repro.explain``'s.
"""

from .attribution import AlgorithmAttribution, KernelAttribution, attribute_algorithm
from .calibrate import (
    CalibrationResult,
    fit_calibration,
    load_calibrated_machine,
    micro_points_synthetic,
    micro_points_wall_clock,
    synthetic_truth,
)
from .classify import CAUSES, Explanation, classify_anomaly
from .decompose import KernelSpec, decompose_instance, kernels_from_record
from .distributions import (
    ModeMixture,
    SessionBimodality,
    median_gap_zscore,
    mode_mixture,
    session_bimodality,
)
from .runner import (
    ExplainSpec,
    build_explain_session,
    explain_progress,
    explain_summary,
    explain_targets,
    merge_explained,
    reranking_probe,
    run_explain_shard,
)

__all__ = [
    "AlgorithmAttribution",
    "CAUSES",
    "CalibrationResult",
    "Explanation",
    "ExplainSpec",
    "KernelAttribution",
    "KernelSpec",
    "ModeMixture",
    "SessionBimodality",
    "attribute_algorithm",
    "build_explain_session",
    "classify_anomaly",
    "decompose_instance",
    "explain_progress",
    "explain_summary",
    "explain_targets",
    "fit_calibration",
    "kernels_from_record",
    "load_calibrated_machine",
    "median_gap_zscore",
    "merge_explained",
    "micro_points_synthetic",
    "micro_points_wall_clock",
    "mode_mixture",
    "reranking_probe",
    "run_explain_shard",
    "session_bimodality",
    "synthetic_truth",
]
