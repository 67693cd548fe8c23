"""Roofline terms: the :class:`MachineSpec` registry and the terms helpers.

Hardware is a selectable :class:`MachineSpec` (the :data:`MACHINES`
registry). Each roofline term divides a count by one of its rates:

    T_comp = FLOPs / peak_FLOPs
    T_mem  = bytes / HBM_bw
    T_coll = collective_bytes / ICI_bw

The dominant term is the bottleneck; the roofline fraction is
T_ideal_compute / max(terms), where T_ideal_compute uses the analytic
MODEL_FLOPS.

The AnomalyExplainer needs per-kernel roofline floors on whatever machine
a census ran on: :func:`synthetic_machine` derives a spec from a
cost-model census's ``flop_rate``, ``cpu-1core`` models a pinned
BLAS-on-one-core host, and a card is described by the machine file that
``python -m repro_torch explain calibrate`` fits from micro-measurements.

A copy of the reference's ``repro.roofline.terms``: the registry keeps the
reference's entries and constants unchanged (explain records carry the
machine by name and by value, so the deterministic stores stay the
reference's byte for byte). The reference's counts come from XLA's HLO
text (``repro.roofline.hlo``), which PyTorch does not emit; that parser is
not part of the port, and :func:`terms_from_counts` takes any object with
``flops``, ``bytes``, ``total_collective_bytes`` and ``collective_bytes``.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Dict, Mapping, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MachineSpec:
    """The hardware constants every roofline term divides by.

    ``dispatch_overhead_s`` is the fixed per-kernel launch cost (Python
    dispatch + runtime) added on top of the compute/memory bound — zero for
    within-one-XLA-program analysis, nonzero when predicting sequences of
    separately dispatched kernels (the AnomalyExplainer's segment model).

    ``eff_curve`` is an optional calibrated GEMM-efficiency curve: sorted
    ``(flops, fraction_of_peak)`` anchor points fitted from
    micro-measurements (:mod:`repro_torch.explain.calibrate`). Real machines
    reach nowhere near peak on tiny kernels — a µs-scale n=32 GEMM runs
    10-70x off the nominal roofline — so :meth:`t_compute` divides by the
    log-interpolated achieved rate instead of raw peak whenever a curve is
    present. Empty curve = nominal peak (the historical behaviour).
    """

    name: str
    peak_flops: float                 # FLOP/s
    hbm_bw: float                     # bytes/s
    ici_bw: float = 0.0               # bytes/s/link (0: no interconnect)
    dispatch_overhead_s: float = 0.0  # seconds per dispatched kernel
    eff_curve: Tuple[Tuple[float, float], ...] = ()  # (flops, frac of peak)

    def __post_init__(self) -> None:
        # JSON round-trips turn the curve into nested lists; normalise so
        # from_dict(to_dict(spec)) == spec holds (frozen: bypass setattr)
        curve = tuple(
            sorted((float(f), float(e)) for f, e in self.eff_curve)
        )
        object.__setattr__(self, "eff_curve", curve)
        if any(e <= 0.0 for _, e in curve):
            raise ValueError(f"eff_curve efficiencies must be > 0: {curve}")

    def efficiency_at(self, flops: float) -> float:
        """Calibrated fraction of peak achieved by a kernel of ``flops``:
        piecewise log-linear in flops between anchor points, clamped at the
        curve's ends. 1.0 when no curve is fitted."""
        curve = self.eff_curve
        if not curve:
            return 1.0
        if flops <= curve[0][0]:
            return curve[0][1]
        if flops >= curve[-1][0]:
            return curve[-1][1]
        for (f0, e0), (f1, e1) in zip(curve, curve[1:]):
            if f0 <= flops <= f1:
                if f1 <= f0:
                    return e1
                w = (math.log(flops) - math.log(f0)) / (
                    math.log(f1) - math.log(f0)
                )
                return e0 + w * (e1 - e0)
        return curve[-1][1]  # pragma: no cover - loop covers the range

    def t_compute(self, flops: float) -> float:
        return flops / (self.peak_flops * self.efficiency_at(flops))

    def t_memory(self, nbytes: float) -> float:
        if self.hbm_bw <= 0:
            return 0.0
        return nbytes / self.hbm_bw

    def t_collective(self, nbytes: float) -> float:
        if nbytes <= 0:
            return 0.0
        if self.ici_bw <= 0:
            raise ValueError(
                f"machine {self.name!r} has no interconnect (ici_bw=0) but "
                f"the program moves {nbytes:.3e} collective bytes"
            )
        return nbytes / self.ici_bw

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, object]) -> "MachineSpec":
        return cls(**{f.name: d[f.name] for f in dataclasses.fields(cls)
                      if f.name in d})


#: Selectable hardware registry. ``tpu-v5e`` keeps the historical constants
#: (the module-level aliases below point at it); ``cpu-1core`` models the
#: census host: one pinned core of a ~3 GHz x86 (16 f32 FLOP/cycle FMA
#: throughput, one DDR channel's worth of bandwidth, ~µs JAX dispatch).
MACHINES: Dict[str, MachineSpec] = {
    "tpu-v5e": MachineSpec("tpu-v5e", peak_flops=197e12, hbm_bw=819e9,
                           ici_bw=50e9),
    "cpu-1core": MachineSpec("cpu-1core", peak_flops=5e10, hbm_bw=2e10,
                             dispatch_overhead_s=2e-6),
}

DEFAULT_MACHINE = MACHINES["tpu-v5e"]

#: Back-compat aliases (pre-MachineSpec callers import these).
PEAK_FLOPS = DEFAULT_MACHINE.peak_flops
HBM_BW = DEFAULT_MACHINE.hbm_bw
ICI_BW = DEFAULT_MACHINE.ici_bw


def get_machine(name: str) -> MachineSpec:
    if name not in MACHINES:
        raise KeyError(f"unknown machine {name!r}; one of {sorted(MACHINES)}")
    return MACHINES[name]


def register_machine(spec: MachineSpec) -> MachineSpec:
    """Add (or replace) a registry entry; returns the spec for chaining."""
    MACHINES[spec.name] = spec
    return spec


def synthetic_machine(name: str, flop_rate: float) -> MachineSpec:
    """The DiscriminantSweep cost-model backend as a MachineSpec: a pure
    compute machine running at ``flop_rate`` — its predicted time for any
    kernel is exactly ``flops / flop_rate``, so per-kernel efficiency
    factors recovered against this roofline are the sweep's injected
    per-algorithm efficiency factors. No memory system (the synthetic
    machine has none): the memory term is 0 by ``hbm_bw=0`` convention."""
    return MachineSpec(name=name, peak_flops=float(flop_rate), hbm_bw=0.0)


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    kind: str
    n_devices: int

    hlo_flops_per_dev: float
    hlo_bytes_per_dev: float
    collective_bytes_per_dev: float
    collective_breakdown: Dict[str, float]

    model_flops_total: float          # analytic 6ND-style
    memory_per_dev_bytes: float       # args + temp from memory_analysis

    machine: MachineSpec = DEFAULT_MACHINE
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0

    def __post_init__(self) -> None:
        self.t_compute = self.machine.t_compute(self.hlo_flops_per_dev)
        self.t_memory = self.machine.t_memory(self.hlo_bytes_per_dev)
        self.t_collective = self.machine.t_collective(
            self.collective_bytes_per_dev
        )

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def model_flops_ratio(self) -> float:
        """MODEL_FLOPS / HLO_FLOPs — how much compiled compute is useful."""
        total_hlo = self.hlo_flops_per_dev * self.n_devices
        return self.model_flops_total / total_hlo if total_hlo else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute roofline fraction (the §Perf score): ideal time
        for MODEL_FLOPS on all chips divided by the bounding term."""
        ideal = self.model_flops_total / (self.n_devices * self.machine.peak_flops)
        return ideal / self.t_bound if self.t_bound else 0.0

    def row(self) -> Dict[str, object]:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "kind": self.kind,
            "devices": self.n_devices,
            "t_compute_s": round(self.t_compute, 6),
            "t_memory_s": round(self.t_memory, 6),
            "t_collective_s": round(self.t_collective, 6),
            "dominant": self.dominant,
            "model_flops": f"{self.model_flops_total:.4e}",
            "hlo_flops_per_dev": f"{self.hlo_flops_per_dev:.4e}",
            "model_hlo_ratio": round(self.model_flops_ratio, 4),
            "roofline_fraction": round(self.roofline_fraction, 4),
            "mem_per_dev_gb": round(self.memory_per_dev_bytes / 2**30, 3),
            "collectives": {
                k: round(v / 2**30, 3) for k, v in self.collective_breakdown.items() if v
            },
        }


def terms_from_counts(
    arch: str,
    shape: str,
    mesh_desc: str,
    kind: str,
    n_devices: int,
    counts: Any,
    model_flops_total: float,
    memory_per_dev_bytes: float,
    machine: Optional[MachineSpec] = None,
) -> RooflineTerms:
    return RooflineTerms(
        arch=arch,
        shape=shape,
        mesh=mesh_desc,
        kind=kind,
        n_devices=n_devices,
        hlo_flops_per_dev=counts.flops,
        hlo_bytes_per_dev=counts.bytes,
        collective_bytes_per_dev=counts.total_collective_bytes,
        collective_breakdown=dict(counts.collective_bytes),
        model_flops_total=model_flops_total,
        memory_per_dev_bytes=memory_per_dev_bytes,
        machine=machine or DEFAULT_MACHINE,
    )
