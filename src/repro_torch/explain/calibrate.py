"""Per-machine dispatch / GEMM-efficiency calibration from micro-measurements.

The nominal :class:`~repro_torch.roofline.terms.MachineSpec` constants describe
the hardware's ceiling; tiny kernels run nowhere near it. On `cpu-1core`
a µs-scale n=32 GEMM sits 10-70x above the nominal roofline, which makes
every "memory vs dispatch" verdict below ~n=256 meaningless — the floor
the explainer reconciles against is fiction down there. ELAPS solves this
by *measuring the machine first*; this module does the same:

1. time an isolated GEMM at a ladder of tiny-to-small sizes
   (:func:`micro_points_wall_clock`, or :func:`micro_points_synthetic`
   against a known ground-truth machine for tests/CI);
2. fit ``t(flops) = dispatch + flops / (peak * eff(flops))``
   (:func:`fit_calibration`): a relative-error-weighted linear fit gives
   the dispatch intercept, and the per-point residual gives the achieved
   fraction-of-peak curve;
3. emit a calibrated :class:`MachineSpec` (same hardware, now with
   ``dispatch_overhead_s`` and ``eff_curve`` filled in) that
   ``python -m repro_torch explain calibrate`` saves to a JSON file and
   ``explain run --machine-file`` feeds back into attribution.

With the calibrated spec, a dispatch-dominated tiny instance shows up as
``dispatch_overhead`` through the *roofline* component (the loser needs
more launches) instead of masquerading as kernel inefficiency.

A copy of the reference's ``repro.explain.calibrate``; the wall-clock
ladder runs on an explicit device (default ``cuda``), and the fit, the
synthetic backend and the saved file are the reference's.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.roofline.terms import MachineSpec

from .decompose import KernelSpec

#: GEMM edge sizes of the micro-measurement ladder: dense below n=64 where
#: dispatch dominates, sparse above where the curve flattens toward peak.
DEFAULT_SIZES = (8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256)


@dataclass(frozen=True)
class CalibrationPoint:
    """One rung of the micro-measurement ladder: a square GEMM."""

    n: int
    flops: float
    t_median: float        # median measured seconds
    efficiency: float = 0.0  # fitted fraction of peak (fit output)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclass(frozen=True)
class CalibrationResult:
    """A fitted machine plus the evidence behind it."""

    machine: MachineSpec              # base spec + dispatch + eff_curve
    points: Tuple[CalibrationPoint, ...]
    dispatch_s: float
    r2: float                         # weighted fit quality, [0, 1]

    def to_dict(self) -> Dict[str, Any]:
        return {
            "version": 1,
            "machine": self.machine.to_dict(),
            "fit": {"dispatch_s": self.dispatch_s, "r2": self.r2},
            "points": [p.to_dict() for p in self.points],
        }

    def save(self, path: str) -> str:
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(self.to_dict(), fh, indent=1, sort_keys=True)
        os.replace(tmp, path)
        return path


def load_calibrated_machine(path: str) -> MachineSpec:
    """The MachineSpec a ``calibrate`` run saved (``--machine-file``)."""
    with open(path) as fh:
        d = json.load(fh)
    return MachineSpec.from_dict(d["machine"])


def _gemm_flops(n: int) -> float:
    return KernelSpec("gemm", (n, n, n)).flops


def micro_points_wall_clock(
    sizes: Sequence[int] = DEFAULT_SIZES,
    reps: int = 25,
    seed: int = 0,
    device: Any = "cuda",
) -> List[CalibrationPoint]:
    """Median wall-clock time of an isolated GEMM per ladder size on
    ``device`` (``torch.matmul``, cuBLAS on the card; blocking contract
    inherited from :func:`repro_torch.explain.decompose.build_kernel_workload`)."""
    import time

    from .decompose import build_kernel_workload

    points: List[CalibrationPoint] = []
    for n in sizes:
        fn = build_kernel_workload(KernelSpec("gemm", (n, n, n)), seed=seed,
                                   device=device)
        samples = []
        for _ in range(max(3, reps)):
            t0 = time.perf_counter()
            fn()
            samples.append(time.perf_counter() - t0)
        points.append(CalibrationPoint(
            n=int(n), flops=_gemm_flops(n), t_median=float(np.median(samples)),
        ))
    return points


def micro_points_synthetic(
    truth: MachineSpec,
    sizes: Sequence[int] = DEFAULT_SIZES,
    reps: int = 25,
    seed: int = 0,
    rel_sigma: float = 0.02,
) -> List[CalibrationPoint]:
    """Deterministic micro-measurements drawn from a known ground-truth
    machine (its calibrated ``t_compute`` + dispatch, under lognormal
    measurement noise) — the test/CI backend: the fit must recover
    ``truth``'s dispatch and efficiency curve from these."""
    rng = np.random.default_rng(seed)
    points: List[CalibrationPoint] = []
    for n in sizes:
        flops = _gemm_flops(n)
        base = truth.t_compute(flops) + truth.dispatch_overhead_s
        samples = base * np.exp(rng.normal(0.0, rel_sigma, max(3, reps)))
        points.append(CalibrationPoint(
            n=int(n), flops=flops, t_median=float(np.median(samples)),
        ))
    return points


def synthetic_truth(
    base: MachineSpec,
    dispatch_s: float,
    eff_knee: float = 64.0,
    sizes: Sequence[int] = DEFAULT_SIZES,
) -> MachineSpec:
    """A plausible ground-truth machine for the synthetic backend: the
    base hardware plus ``dispatch_s`` launch cost and a saturating
    efficiency curve ``eff(n) = n / (n + knee)`` anchored at the ladder
    sizes (tiny GEMMs far off peak, large ones approaching it).
    ``eff_knee=0`` keeps the nominal flat-peak machine."""
    curve: Tuple[Tuple[float, float], ...] = ()
    if eff_knee > 0:
        curve = tuple(
            (_gemm_flops(n), float(n) / (float(n) + eff_knee)) for n in sizes
        )
    return dataclasses.replace(
        base,
        name=f"{base.name}:truth",
        dispatch_overhead_s=float(dispatch_s),
        eff_curve=curve,
    )


def fit_calibration(
    base: MachineSpec, points: Sequence[CalibrationPoint]
) -> CalibrationResult:
    """Fit dispatch + efficiency curve to one micro-measurement ladder.

    The model is ``t = a + flops / (peak * eff(flops))``. Step 1 fits the
    intercept ``a`` (dispatch) by relative-error-weighted least squares of
    ``t`` on ``flops`` — the 1/t² weights make the µs-scale small sizes,
    where dispatch IS the signal, carry the fit instead of being rounding
    errors under the large sizes. Step 2 converts each point's remaining
    time into an achieved fraction of peak, which becomes the spec's
    ``eff_curve`` anchors.
    """
    if len(points) < 3:
        raise ValueError("calibration needs >= 3 ladder sizes")
    f = np.array([p.flops for p in points], dtype=np.float64)
    t = np.array([p.t_median for p in points], dtype=np.float64)
    if np.any(t <= 0):
        raise ValueError("calibration measurements must be positive")
    w = 1.0 / t**2
    A = np.stack([np.ones_like(f), f], axis=1)
    sw = np.sqrt(w)
    coef, *_ = np.linalg.lstsq(A * sw[:, None], t * sw, rcond=None)
    dispatch = float(max(coef[0], 0.0))
    pred = A @ coef
    ss_res = float(np.sum(w * (t - pred) ** 2))
    t_wmean = float(np.sum(w * t) / np.sum(w))
    ss_tot = float(np.sum(w * (t - t_wmean) ** 2))
    r2 = 1.0 - ss_res / ss_tot if ss_tot > 0 else 1.0

    fitted: List[CalibrationPoint] = []
    curve: List[Tuple[float, float]] = []
    floor = 1e-12
    for p in points:
        t_math = max(p.t_median - dispatch, floor)
        eff = p.flops / (base.peak_flops * t_math)
        eff = float(min(max(eff, 1e-4), 10.0))  # sanity clamp, not physics
        fitted.append(dataclasses.replace(p, efficiency=eff))
        curve.append((p.flops, eff))
    machine = dataclasses.replace(
        base,
        name=f"{base.name}:calibrated",
        dispatch_overhead_s=dispatch,
        eff_curve=tuple(curve),
    )
    return CalibrationResult(
        machine=machine, points=tuple(fitted), dispatch_s=dispatch,
        r2=float(max(0.0, min(1.0, r2))),
    )


def calibration_table(result: CalibrationResult) -> str:
    """Human-readable fit summary (the ``calibrate`` subcommand's stdout)."""
    m = result.machine
    out = [
        f"# calibrated {m.name}: dispatch {result.dispatch_s*1e6:.2f}us/kernel, "
        f"weighted R^2 {result.r2:.4f}",
        "# n      flops        t_median     eff(frac of peak)   floor",
    ]
    for p in result.points:
        t_c = m.t_compute(p.flops)
        bound = "dispatch" if m.dispatch_overhead_s > t_c else "compute"
        out.append(
            f"# {p.n:<6d} {p.flops:<12.4g} {p.t_median:<12.4g} "
            f"{p.efficiency:<19.4f} {bound}"
        )
    return "\n".join(out)
