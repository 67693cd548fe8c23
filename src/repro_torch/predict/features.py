"""Feature vectors for the learned cost model — no device, by construction.

One (instance, algorithm) pair becomes one numeric vector built only from
what the census already knows analytically: the kernel decomposition
(:func:`repro_torch.explain.decompose.kernels_from_record` — exact FLOPs and
byte traffic per :class:`~repro_torch.explain.decompose.KernelSpec`) and the
machine's roofline terms (:class:`repro_torch.roofline.terms.MachineSpec` —
compute time, memory time, per-kernel dispatch). No measurement happens
here; the extraction is a pure function of (record pointers, machine),
which is what lets an active census emit byte-identical predicted records
across kills and resumes.

Training targets come from :func:`training_rows`: on the deterministic
``cost_model``/``simulated`` backends every census record's measured
outcome is reconstructible bit-exactly from its rebuild pointers via
:func:`repro_torch.core.sweep.synthetic_instance_model`, so the target is the
true log10 seconds per algorithm. Wall-clock records carry no stored
per-algorithm times (the census deliberately keeps wall time out of the
JSONL) and are skipped — counted, never silent.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping, Sequence, Tuple

from repro_torch.explain.decompose import KernelSpec, kernels_from_record
from repro_torch.roofline.terms import MACHINES, MachineSpec, get_machine, synthetic_machine

#: bump when the vector layout changes — serialized models embed it and
#: refuse to load against a different extraction (see repro_torch.predict.model)
FEATURE_VERSION = 1

#: one name per vector slot, in order (the serialized feature schema)
FEATURE_NAMES: Tuple[str, ...] = (
    "log10_flops",            # total analytic FLOPs of the kernel sequence
    "log10_bytes",            # total memory traffic of the kernel sequence
    "log10_intensity",        # arithmetic intensity flops/bytes
    "kernel_count",           # kernels launched (the dispatch multiplier)
    "log10_max_kernel_flops", # heaviest single kernel
    "log10_t_compute",        # machine roofline compute time
    "log10_t_memory",         # machine roofline memory time
    "log10_t_roofline",       # max(compute, memory) + dispatch * kernels
)

#: log10 floor for quantities that can be exactly zero (e.g. memory time
#: on a pure-compute synthetic machine) — constant columns are harmless
#: under ridge, but log10(0) is not
_LOG_FLOOR = 1e-30


def _log10(x: float) -> float:
    return math.log10(max(float(x), _LOG_FLOOR))


def census_machine(spec: Any, machine: str = "") -> Tuple[str, MachineSpec]:
    """(label, MachineSpec) a census's predictions are costed against —
    the serving oracle's resolution rule: an explicit registry name wins,
    deterministic backends get the census's own pure-compute synthetic
    machine, wall clock falls back to the pinned host core."""
    name = machine
    if not name:
        if spec.backend in ("cost_model", "simulated"):
            name = f"sweep:{spec.name}"
        else:
            name = "cpu-1core"
    if name in MACHINES:
        return name, get_machine(name)
    return name, synthetic_machine(name, spec.flop_rate)


def kernel_features(
    kernels: Sequence[KernelSpec],
    machine: MachineSpec,
    dispatch_s: float = 0.0,
) -> List[float]:
    """The feature vector for ONE algorithm's kernel sequence on ONE
    machine, slots named by :data:`FEATURE_NAMES`. Values are exactly the
    decompose/roofline quantities (tests hold this to equality): FLOPs
    and bytes are sums of :attr:`KernelSpec.flops` / :attr:`KernelSpec.bytes`,
    times come from :meth:`MachineSpec.t_compute` / :meth:`t_memory`, and
    the dispatch term charges ``machine.dispatch_overhead_s + dispatch_s``
    once per kernel (the census's own dispatch model)."""
    flops = sum(k.flops for k in kernels)
    nbytes = sum(k.bytes for k in kernels)
    t_compute = machine.t_compute(flops)
    t_memory = machine.t_memory(nbytes)
    dispatch = (machine.dispatch_overhead_s + float(dispatch_s)) * len(kernels)
    return [
        _log10(flops),
        _log10(nbytes),
        _log10(flops / nbytes if nbytes else 0.0),
        float(len(kernels)),
        _log10(max((k.flops for k in kernels), default=0.0)),
        _log10(t_compute),
        _log10(t_memory),
        _log10(max(t_compute, t_memory) + dispatch),
    ]


def instance_features(
    kernels_by_alg: Mapping[str, Sequence[KernelSpec]],
    machine: MachineSpec,
    dispatch_s: float = 0.0,
) -> Dict[str, List[float]]:
    """Per-algorithm feature vectors for one instance's decomposition."""
    return {
        alg: kernel_features(ks, machine, dispatch_s)
        for alg, ks in sorted(kernels_by_alg.items())
    }


def record_features(
    record: Mapping[str, Any],
    machine: MachineSpec,
    dispatch_s: float = 0.0,
) -> Dict[str, List[float]]:
    """Per-algorithm feature vectors for one census record, resolved
    through the record's rebuild pointers (``kernels`` -> ``params`` ->
    ``dims``/``size`` fallback, exactly the explainer's rule)."""
    return instance_features(kernels_from_record(record), machine, dispatch_s)


def training_rows(
    spec: Any,
    records: Sequence[Mapping[str, Any]],
    machine: str = "",
) -> Tuple[List[List[float]], List[float], List[Tuple[str, str]], int]:
    """``(X, y, keys, n_skipped)`` from a merged census: one row per
    (record, algorithm), target ``y`` = true log10 seconds reconstructed
    from the record's rebuild pointers via the synthetic machine
    (deterministic backends only). ``keys`` is the parallel
    ``(uid, algorithm)`` list — the train-set digest hashes it.
    Wall-clock records (no stored per-algorithm times) are skipped and
    counted in ``n_skipped``; callers must surface the count."""
    from repro_torch.core.sweep import synthetic_instance_model

    _, mspec = census_machine(spec, machine)
    X: List[List[float]] = []
    y: List[float] = []
    keys: List[Tuple[str, str]] = []
    n_skipped = 0
    for rec in records:
        if rec.get("backend", spec.backend) not in ("cost_model", "simulated"):
            n_skipped += 1
            continue
        kernels = kernels_from_record(rec)
        flops = {k: float(v) for k, v in rec["flops"].items()}
        kernel_counts = {alg: len(ks) for alg, ks in kernels.items()}
        model = synthetic_instance_model(
            spec, int(rec["index"]), flops, kernel_counts,
            base_seed=rec.get("base_seed"),
        )
        vecs = instance_features(kernels, mspec, spec.dispatch_s)
        for alg in sorted(model.costs):
            if alg not in vecs:
                continue
            X.append(vecs[alg])
            y.append(_log10(model.costs[alg]))
            keys.append((str(rec["uid"]), alg))
    return X, y, keys, n_skipped
