"""Per-kernel efficiency attribution against a MachineSpec roofline.

Peise & Bientinesi's performance-modeling approach (and the ELAPS toolkit)
explains whole-algorithm time as the sum of measured kernel contributions;
we add a roofline floor per kernel so the *excess* — measured minus
roofline-predicted — is a machine-independent "how much slower than the
hardware allows" quantity:

    t_roofline(k) = max(flops_k / peak, bytes_k / bw) + dispatch_overhead
    efficiency(k) = t_measured(k) / t_roofline(k)     (1.0 = at the roof)
    excess(k)     = t_measured(k) - t_roofline(k)
    residual(alg) = t_total(alg) - sum_k t_measured(k)

``efficiency`` deliberately matches the DiscriminantSweep synthetic
machine's injected per-algorithm efficiency factor: on the cost-model
backend with :func:`repro_torch.roofline.synthetic_machine`, the recovered
per-kernel efficiencies equal the factor ``synthetic_costs`` drew for the
algorithm (up to measurement noise) — the ground truth the explainer tests
recover. The ``residual`` captures everything the kernel decomposition
cannot see (dispatch, allocator, framework overhead between kernels).

A copy of the reference's ``repro.explain.attribution``: the same
rooflines, efficiencies and rows, float for float.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.roofline.terms import MachineSpec

from .decompose import KernelSpec, kernel_name


def kernel_roofline(kernel: KernelSpec, machine: MachineSpec) -> Tuple[float, str]:
    """(predicted seconds, bounding term) of one isolated kernel."""
    t_c = machine.t_compute(kernel.flops)
    t_m = machine.t_memory(kernel.bytes)
    bound = "memory" if t_m > t_c else "compute"
    return max(t_c, t_m) + machine.dispatch_overhead_s, bound


@dataclass(frozen=True)
class KernelAttribution:
    """One measured kernel segment reconciled against its roofline floor."""

    name: str               # session measurement name (alg::NN.op)
    kernel: KernelSpec
    t_measured: float       # median isolated segment time (seconds)
    t_roofline: float
    bound: str              # "compute" | "memory"
    t_dispatch: float = 0.0  # dispatch part of t_roofline (calibrated)

    @property
    def efficiency(self) -> float:
        """Measured over roofline — the sweep's eff-factor semantics
        (> 1: slower than the machine allows; < 1 cannot happen on real
        hardware, but the synthetic machine's lognormal factors do dip
        below 1 and the explainer must represent that faithfully)."""
        if self.t_roofline <= 0:
            return float("inf") if self.t_measured > 0 else 1.0
        return self.t_measured / self.t_roofline

    @property
    def excess(self) -> float:
        return self.t_measured - self.t_roofline

    def row(self) -> Dict[str, Any]:
        return {
            "kernel": self.kernel.label,
            "op": self.kernel.op,
            "shape": list(self.kernel.shape),
            "flops": self.kernel.flops,
            "t_measured": self.t_measured,
            "t_roofline": self.t_roofline,
            "t_dispatch": self.t_dispatch,
            "efficiency": self.efficiency,
            "excess": self.excess,
            "bound": self.bound,
        }


@dataclass(frozen=True)
class AlgorithmAttribution:
    """A whole algorithm reconciled: kernel-sum + residual = total."""

    algorithm: str
    t_total: float          # median whole-algorithm time (seconds)
    kernels: Tuple[KernelAttribution, ...]

    @property
    def t_kernel_sum(self) -> float:
        return sum(k.t_measured for k in self.kernels)

    @property
    def t_roofline_sum(self) -> float:
        return sum(k.t_roofline for k in self.kernels)

    @property
    def excess_total(self) -> float:
        return sum(k.excess for k in self.kernels)

    @property
    def residual(self) -> float:
        """Whole-algorithm time the isolated kernels do not account for
        (dispatch / framework overhead when positive; fusion or cache reuse
        between adjacent kernels when negative)."""
        return self.t_total - self.t_kernel_sum

    @property
    def t_dispatch_sum(self) -> float:
        """Calibrated dispatch part of the roofline sum — what the machine
        charges just for launching this algorithm's kernels."""
        return sum(k.t_dispatch for k in self.kernels)

    def t_bound_sum(self, bound: str) -> float:
        """Roofline time (minus dispatch) carried by kernels sitting on one
        roof (``"compute"`` or ``"memory"``) — the calibrated
        memory-vs-dispatch split of the hardware floor."""
        return sum(
            k.t_roofline - k.t_dispatch for k in self.kernels
            if k.bound == bound
        )

    def worst_kernel(self) -> KernelAttribution:
        """The segment farthest above its roofline floor (ties: first in
        execution order, deterministically)."""
        best = max(range(len(self.kernels)),
                   key=lambda i: (self.kernels[i].excess, -i))
        return self.kernels[best]

    def cache_pair(self) -> Optional[Tuple[KernelAttribution, KernelAttribution]]:
        """The adjacent kernel pair most plausibly sharing cache: the pair
        whose handed-over intermediate (the first kernel's result) is
        largest, because that is the memory traffic a fused/cache-resident
        execution saves. None for single-kernel algorithms. Ties break to
        the earliest pair, deterministically."""
        if len(self.kernels) < 2:
            return None
        best = max(
            range(len(self.kernels) - 1),
            key=lambda i: (self.kernels[i].kernel.out_bytes, -i),
        )
        return self.kernels[best], self.kernels[best + 1]

    def row(self) -> Dict[str, Any]:
        return {
            "algorithm": self.algorithm,
            "t_total": self.t_total,
            "t_kernel_sum": self.t_kernel_sum,
            "t_roofline_sum": self.t_roofline_sum,
            "residual": self.residual,
            "kernels": [k.row() for k in self.kernels],
        }


def attribute_algorithm(
    algorithm: str,
    t_total: float,
    kernels: Sequence[KernelSpec],
    segment_times: Mapping[str, float],
    machine: MachineSpec,
) -> AlgorithmAttribution:
    """Reconcile one algorithm: ``segment_times`` maps the session's kernel
    measurement names (see :func:`~repro_torch.explain.decompose.kernel_name`) to
    median isolated times."""
    attrs: List[KernelAttribution] = []
    for i, k in enumerate(kernels):
        name = kernel_name(algorithm, i, k)
        t_pred, bound = kernel_roofline(k, machine)
        attrs.append(
            KernelAttribution(
                name=name,
                kernel=k,
                t_measured=float(segment_times[name]),
                t_roofline=t_pred,
                bound=bound,
                t_dispatch=machine.dispatch_overhead_s,
            )
        )
    return AlgorithmAttribution(
        algorithm=algorithm, t_total=float(t_total), kernels=tuple(attrs)
    )
