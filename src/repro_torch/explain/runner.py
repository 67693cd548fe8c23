"""ExplainSpec + sharded, resumable explanation campaigns.

An explanation campaign consumes a finished (or finishing) DiscriminantSweep
census and produces one explanation record per anomaly. It reuses the whole
measurement stack: each anomaly becomes a
:class:`~repro_torch.core.session.MeasurementSession` whose measured names are the
winner and loser algorithms *plus every kernel segment of both*, driven in
chunks through :class:`~repro_torch.core.engine.ExperimentEngine` campaigns with
the same persistence contract as the sweep — engine state saved every
``save_every`` steps, records appended to per-shard JSONL
(:class:`~repro_torch.core.sweep.ShardStore`), and for the deterministic census
backends a SIGKILLed explain run resumes **byte-identical** to an
uninterrupted one.

Backends follow the census: a ``cost_model``/``simulated`` census is
explained on the same synthetic machine (segment costs reconstructed from
the record's ``kernels``/``flops``/``base_seed`` pointers — zero census
re-runs, no device); a ``wall_clock`` census re-measures each kernel
in isolation with fresh workloads on an explicit device
(``run_explain_shard(..., device=)``, default ``"cuda"``), as the census
does. Metadata never touches a device.

A copy of the reference's ``repro.explain.runner``: every byte that
reaches an explanation record or ``espec.json`` is the reference's, so the
deterministic explain stores of both packages are identical.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.faults import FaultPlan, active_plan
from repro_torch.core.measure import CostModelTimer, NoiseProfile, SimulatedTimer, Timer, WallClockTimer
from repro_torch.core.session import MeasurementSession
from repro_torch.core.sweep import (
    LINE_CRC_MISMATCH,
    LINE_UNDECODABLE,
    InstanceSpec,
    ShardStore,
    StoreDamaged,
    SweepSpec,
    instance_entry,
    merge_shards,
    parse_record_line,
    run_chunked_campaign,
    shard_counts,
    synthetic_instance_model,
)
from repro_torch.core.types import DEFAULT_QUANTILE_RANGES, REPORT_QUANTILE_RANGE
from repro_torch.device import DeviceLike
from repro_torch.roofline.terms import MachineSpec, get_machine, synthetic_machine

from .attribution import AlgorithmAttribution, attribute_algorithm
from .calibrate import load_calibrated_machine
from .classify import (
    DEFAULT_FLIP_MIN_PROB,
    DEFAULT_FLIP_Z,
    classify_anomaly,
    pick_winner_loser,
)
from .distributions import median_gap_zscore, session_bimodality
from .decompose import (
    KernelSpec,
    build_kernel_workload,
    kernel_name,
    kernels_from_compact,
    kernels_from_record,
    kernels_to_compact,
)

SPEC_FILE = "espec.json"


@dataclass
class ExplainSpec:
    """One explanation campaign, declaratively. ``census`` points at the
    sweep's ``--out`` directory; everything else is campaign knobs. The
    work list (which anomalies, in which shard) is a pure function of this
    spec plus the census records, so any worker anywhere agrees on it."""

    name: str = "explain"
    census: str = ""
    n_shards: int = 4
    #: segment measurement campaign (Procedure 4 over kernels)
    m_per_iteration: int = 3
    eps: float = 0.03
    max_measurements: int = 12
    chunk_size: int = 8
    save_every: int = 25
    #: MachineSpec registry name; empty = derive from the census backend
    #: (synthetic machine for cost_model/simulated, cpu-1core for wall_clock)
    machine: str = ""
    #: path to a ``calibrate`` output file; overrides ``machine`` with the
    #: fitted dispatch/efficiency-curve spec
    machine_file: str = ""
    min_evidence: float = 0.5
    #: re-ranking confidence probe: when the winner/loser median gap is
    #: non-positive or below ``flip_z`` standard errors, re-measure both
    #: under the census protocol ``flip_probes`` times and report the flip
    #: probability (the ``not_reproducible`` evidence).
    flip_probes: int = 16
    flip_z: float = DEFAULT_FLIP_Z
    flip_min_prob: float = DEFAULT_FLIP_MIN_PROB
    #: quantile ladder for the segment sessions. ``"report"`` (default)
    #: runs one Procedure-2 sort per step — the report range only, which is
    #: all the explainer consumes (segment *medians* + convergence); this
    #: draws the exact same samples in the exact same order as the full
    #: ladder (the hypothesis reorder comes from the report-range sort
    #: either way), it just stops paying for the six extra ladder sorts
    #: that only feed the census's rank-stability diagnostics. ``"paper"``
    #: keeps the full 7-range ladder of the census.
    ladder: str = "report"
    base_seed: int = 0
    fsync: bool = False

    def __post_init__(self) -> None:
        if self.n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        if not 0.0 <= self.min_evidence <= 1.0:
            raise ValueError("min_evidence must be in [0, 1]")
        if self.flip_probes < 1:
            raise ValueError("flip_probes must be >= 1")
        if self.ladder not in ("report", "paper"):
            raise ValueError('ladder must be "report" or "paper"')

    def quantile_ranges(self) -> Tuple[Tuple[float, float], ...]:
        """The session quantile ladder this campaign measures with."""
        if self.ladder == "paper":
            return tuple(DEFAULT_QUANTILE_RANGES)
        return (REPORT_QUANTILE_RANGE,)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["version"] = 1
        return d

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ExplainSpec":
        kwargs = {
            f.name: d[f.name] for f in dataclasses.fields(cls) if f.name in d
        }
        return cls(**kwargs)

    def save(self, path: str) -> str:
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(self.to_dict(), fh, indent=1, sort_keys=True)
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, path: str) -> "ExplainSpec":
        with open(path) as fh:
            return cls.from_dict(json.load(fh))


# ------------------------------------------------------------ the work list ---


def load_census(espec: ExplainSpec) -> Tuple[SweepSpec, List[Dict[str, Any]]]:
    """(sweep spec, merged census records) for the campaign's census."""
    spec_file = os.path.join(espec.census, "spec.json")
    sweep_spec = SweepSpec.load(spec_file)
    return sweep_spec, merge_shards(sweep_spec, espec.census)


#: census lines are canonical compact JSON (``sort_keys``, no spaces), so
#: every anomaly line contains the first marker verbatim; the second
#: tolerates hand-edited / pretty-printed stores.
_ANOMALY_MARKERS = (b'"is_anomaly":true', b'"is_anomaly": true')


def anomaly_records(sweep_spec: SweepSpec, root: str) -> List[Dict[str, Any]]:
    """Anomalous census records, deduped by uid, in global grid order —
    the result of ``[r for r in merge_shards(...) if r["is_anomaly"]]``
    without json-parsing the overwhelmingly non-anomalous majority: lines
    missing the ``is_anomaly: true`` substring are skipped unparsed, so
    the scan cost tracks the anomaly count, not the census size."""
    seen: Dict[str, Dict[str, Any]] = {}
    for shard in range(sweep_spec.n_shards):
        path = ShardStore(root, shard).records_path
        try:
            fh = open(path, "rb")
        except OSError:
            continue
        with fh:
            lines = fh.read().splitlines(keepends=True)
        for i, line in enumerate(lines):
            if not line.endswith(b"\n"):
                break  # torn tail: an append in flight or a kill
            if not any(m in line for m in _ANOMALY_MARKERS):
                continue
            rec, status = parse_record_line(line)
            if status in (LINE_UNDECODABLE, LINE_CRC_MISMATCH):
                if i == len(lines) - 1:
                    break  # a torn tail that happens to end in \n
                raise StoreDamaged(
                    f"{path}: line {i + 1} is {status} mid-file — the "
                    "census this campaign feeds on is damaged; run "
                    f"`python -m repro_torch fsck --out {root}` first"
                )
            if rec.get("is_anomaly"):
                seen.setdefault(str(rec["uid"]), rec)
    return sorted(seen.values(), key=lambda r: r["index"])


def explain_targets(espec: ExplainSpec) -> Tuple[SweepSpec, List[Dict[str, Any]]]:
    """(sweep spec, anomaly records in global grid order) — the campaign's
    deterministic work list. Non-anomalous records need no explanation."""
    spec_file = os.path.join(espec.census, "spec.json")
    sweep_spec = SweepSpec.load(spec_file)
    return sweep_spec, anomaly_records(sweep_spec, espec.census)


def shard_targets(espec: ExplainSpec, targets: Sequence[Mapping[str, Any]],
                  shard: int) -> List[Mapping[str, Any]]:
    """Round-robin by work-list position (like the sweep: adjacent,
    similar-cost anomalies land on different shards)."""
    if not 0 <= shard < espec.n_shards:
        raise ValueError(f"shard {shard} out of range [0, {espec.n_shards})")
    return [r for i, r in enumerate(targets) if i % espec.n_shards == shard]


def resolve_machine(espec: ExplainSpec, sweep_spec: SweepSpec) -> MachineSpec:
    """The roofline floor's hardware: a calibrated machine file first, then
    an explicit registry pick, else derived from the census backend (the
    synthetic machine IS the cost-model census's hardware — predictions of
    flops/flop_rate make the recovered per-kernel efficiencies equal the
    injected factors)."""
    if espec.machine_file:
        return load_calibrated_machine(espec.machine_file)
    if espec.machine:
        return get_machine(espec.machine)
    if sweep_spec.backend in ("cost_model", "simulated"):
        return synthetic_machine(f"sweep:{sweep_spec.name}", sweep_spec.flop_rate)
    return get_machine("cpu-1core")


def record_to_instance(sweep_spec: SweepSpec, record: Mapping[str, Any]) -> InstanceSpec:
    """Rebuild the census row from its pointers (the records' ``params``);
    pre-pointer censuses fall back to a grid re-expansion."""
    if record.get("params"):
        return InstanceSpec(
            index=int(record["index"]), uid=str(record["uid"]),
            family=str(record["family"]), params=dict(record["params"]),
        )
    by_uid = {i.uid: i for i in sweep_spec.expand()}
    return by_uid[str(record["uid"])]


def _record_flops(sweep_spec: SweepSpec, record: Mapping[str, Any]) -> Dict[str, float]:
    """Analytic FLOPs per algorithm: the record's pointer when present
    (bit-exact with what the census measured), else rebuilt analytically."""
    if record.get("flops"):
        return {k: float(v) for k, v in record["flops"].items()}
    flops, _, _ = instance_entry(record_to_instance(sweep_spec, record))
    return {k: float(v) for k, v in flops.items()}


# -------------------------------------------------------- session building ---


def _entropy(espec: ExplainSpec, record: Mapping[str, Any], stream: int) -> List[int]:
    """Explain-side RNG entropy, disjoint from the sweep's streams (the
    sweep uses streams 1-3; explain starts at 11)."""
    return [int(espec.base_seed), int(record["index"]), int(stream)]


def _measurement_names(
    winner: str, loser: str,
    kernels: Mapping[str, Sequence[KernelSpec]],
) -> List[str]:
    """Session measurement order: whole algorithms first, then each
    algorithm's kernel segments in execution order."""
    names = [winner, loser]
    for alg in (winner, loser):
        names += [kernel_name(alg, i, k) for i, k in enumerate(kernels[alg])]
    return names


def _record_instance_model(
    sweep_spec: SweepSpec,
    record: Mapping[str, Any],
    all_kernels: Optional[Mapping[str, Sequence[KernelSpec]]] = None,
):
    """The synthetic machine's per-instance ground truth, rebuilt from the
    record's ``base_seed``/``index``/``flops``/``kernels`` pointers (same
    RNG streams the census consumed — see
    :func:`repro_torch.core.sweep.synthetic_instance_model`). ``all_kernels`` is
    the record's full per-algorithm decomposition when the caller already
    parsed it."""
    flops = _record_flops(sweep_spec, record)
    if all_kernels is None:
        all_kernels = kernels_from_record(record)
    kernel_counts = {alg: len(ks) for alg, ks in all_kernels.items()}
    return synthetic_instance_model(
        sweep_spec,
        int(record["index"]),
        flops,
        kernel_counts,
        base_seed=int(record.get("base_seed", sweep_spec.base_seed)),
    )


def _synthetic_segment_costs(
    sweep_spec: SweepSpec,
    record: Mapping[str, Any],
    involved: Sequence[str],
    kernels: Mapping[str, Sequence[KernelSpec]],
    all_kernels: Optional[Mapping[str, Sequence[KernelSpec]]] = None,
) -> Tuple[Dict[str, float], bool]:
    """(true costs per measured name, bimodal flag) on the synthetic
    machine. Whole-algorithm costs come straight from the reconstructed
    instance model (injected efficiency x cache-reuse saving + per-kernel
    dispatch — exactly what the census measured); each isolated segment
    costs its kernel's FLOP share at the algorithm's efficiency plus ONE
    dispatch. Cache reuse is deliberately *absent* from the segments (an
    isolated kernel has nobody to share cache with), which is how the
    injected reuse surfaces as a negative attribution residual."""
    model = _record_instance_model(sweep_spec, record, all_kernels)
    costs: Dict[str, float] = {}
    for alg in involved:
        costs[alg] = model.costs[alg]
        for i, k in enumerate(kernels[alg]):
            c = k.flops / sweep_spec.flop_rate * model.efficiencies[alg]
            if sweep_spec.dispatch_s > 0.0:
                c += sweep_spec.dispatch_s
            costs[kernel_name(alg, i, k)] = c
    return costs, model.bimodal


def _build_timer(
    espec: ExplainSpec,
    sweep_spec: SweepSpec,
    record: Mapping[str, Any],
    involved: Sequence[str],
    kernels: Mapping[str, Sequence[KernelSpec]],
    all_kernels: Optional[Mapping[str, Sequence[KernelSpec]]] = None,
    device: DeviceLike = "cuda",
) -> Timer:
    if sweep_spec.backend == "wall_clock":
        return WallClockTimer(
            _wall_clock_workloads(sweep_spec, record, involved, kernels, device)
        )
    costs, bimodal = _synthetic_segment_costs(
        sweep_spec, record, involved, kernels, all_kernels
    )
    noise_seed = int(
        np.random.default_rng(_entropy(espec, record, 11)).integers(0, 2**63 - 1)
    )
    if sweep_spec.backend == "cost_model":
        return CostModelTimer(
            costs, rel_sigma=sweep_spec.noise_sigma, seed=noise_seed
        )
    profiles = {
        name: NoiseProfile(
            base=cost,
            rel_sigma=sweep_spec.noise_sigma,
            bimodal_shift=sweep_spec.bimodal_shift if bimodal else 0.0,
            bimodal_prob=sweep_spec.bimodal_prob if bimodal else 0.0,
        )
        for name, cost in costs.items()
    }
    return SimulatedTimer(profiles, seed=noise_seed)


def _whole_algorithm_workloads(
    inst: InstanceSpec, involved: Sequence[str], device: DeviceLike = "cuda"
) -> Dict[str, Callable[[], Any]]:
    """Warmed workloads on ``device`` for ONLY the involved algorithms,
    resolved through the family registry (families with large enumerations
    — chains — override ``explain_workloads`` to build the involved pair
    selectively instead of building everything)."""
    from repro_torch.core.family import get_family

    return get_family(inst.family).explain_workloads(inst, involved, device)


def _wall_clock_workloads(
    sweep_spec: SweepSpec,
    record: Mapping[str, Any],
    involved: Sequence[str],
    kernels: Mapping[str, Sequence[KernelSpec]],
    device: DeviceLike = "cuda",
) -> Dict[str, Callable[[], Any]]:
    """Whole-algorithm workloads come from the instance builders (same
    inputs as the census measured); kernel segments get fresh isolated
    workloads, all on ``device``."""
    inst = record_to_instance(sweep_spec, record)
    out = _whole_algorithm_workloads(inst, involved, device)
    seed = int(record["index"])
    for alg in involved:
        for i, k in enumerate(kernels[alg]):
            out[kernel_name(alg, i, k)] = build_kernel_workload(k, seed=seed,
                                                                device=device)
    return out


def build_explain_session(
    espec: ExplainSpec,
    sweep_spec: SweepSpec,
    record: Mapping[str, Any],
    device: DeviceLike = "cuda",
) -> MeasurementSession:
    """One anomaly's explanation as a resumable measurement session: the
    winner/loser pair and all their kernel segments, measured together
    under Procedure 4 so segment medians stabilize before attribution. A
    wall-clock census's workloads run on ``device``."""
    winner, loser = pick_winner_loser(record)
    all_kernels = kernels_from_record(record)
    kernels = {winner: all_kernels[winner], loser: all_kernels[loser]}
    names = _measurement_names(winner, loser, kernels)
    timer = _build_timer(espec, sweep_spec, record, (winner, loser), kernels,
                         all_kernels, device)
    machine = resolve_machine(espec, sweep_spec)
    shuffle_seed = int(
        np.random.default_rng(_entropy(espec, record, 13)).integers(0, 2**31 - 1)
    )
    return MeasurementSession(
        str(record["uid"]),
        names,
        timer,
        m_per_iteration=espec.m_per_iteration,
        eps=espec.eps,
        max_measurements=espec.max_measurements,
        quantile_ranges=espec.quantile_ranges(),
        shuffle_seed=shuffle_seed,
        meta={
            "uid": str(record["uid"]),
            "index": int(record["index"]),
            "family": str(record["family"]),
            "size": record.get("size"),
            "reason": str(record.get("reason", "")),
            "winner": winner,
            "loser": loser,
            "kernels": kernels_to_compact(kernels),
            "machine": machine.to_dict(),
            "backend": sweep_spec.backend,
            #: the census's batch size — the re-ranking probe replays the
            #: census protocol, not the explain campaign's
            "census_m": sweep_spec.m_per_iteration,
        },
    )


# ------------------------------------------------------------- the records ---


def _median_times(session: MeasurementSession) -> Dict[str, float]:
    return {
        name: float(np.median(session.store.row(name)))
        for name in session.store.names()
    }


def reranking_probe(
    session: MeasurementSession,
    winner: str,
    loser: str,
    m: int,
    n_probes: int,
) -> float:
    """Flip probability of the census winner/loser order under the census
    protocol: ``n_probes`` fresh batches of ``m`` measurements per
    algorithm, each batch re-ranked by median. Returns the fraction of
    probes where the loser measures no slower than the winner — the
    confidence that the census ranking was a noise artifact.

    The probe continues the session's own timer stream (deterministic for
    the cost_model/simulated backends), and only runs after the session
    has finished measuring, so kill/resume byte-identity is preserved: a
    resumed chunk replays to the same final timer state and draws the same
    probe samples."""
    timer = session.timer
    m = max(1, int(m))
    flips = 0
    for _ in range(max(1, int(n_probes))):
        w = float(np.median(timer.measure_many(winner, m)))
        l = float(np.median(timer.measure_many(loser, m)))
        if l <= w:
            flips += 1
    return flips / max(1, int(n_probes))


def record_from_explain_session(
    session: MeasurementSession, espec: ExplainSpec
) -> Dict[str, Any]:
    """One explanation JSONL record. Deterministic-fields-only, like the
    census records: medians of deterministic draws, analytic rooflines,
    distribution statistics of deterministic samples — a resumed explain
    run merges byte-identical."""
    meta = session.meta
    machine = MachineSpec.from_dict(meta["machine"])
    kernels = kernels_from_compact(meta["kernels"])
    medians = _median_times(session)
    winner, loser = meta["winner"], meta["loser"]
    attrs: Dict[str, AlgorithmAttribution] = {
        alg: attribute_algorithm(
            alg, medians[alg], kernels[alg], medians, machine
        )
        for alg in (winner, loser)
    }
    bimodality = session_bimodality(
        {name: session.store.row(name) for name in session.store.names()}
    )
    gap, _, z = median_gap_zscore(
        session.store.row(winner), session.store.row(loser)
    )
    flip_p: Optional[float] = None
    if not bimodality.is_bimodal and (gap <= 0 or z < espec.flip_z):
        flip_p = reranking_probe(
            session, winner, loser,
            # the census's batch size (falling back to the explain
            # campaign's for pre-census_m sessions): the probe measures
            # whether the CENSUS protocol reproduces its own ranking
            m=int(meta.get("census_m", espec.m_per_iteration)),
            n_probes=espec.flip_probes,
        )
    expl = classify_anomaly(
        meta, attrs[winner], attrs[loser],
        min_evidence=espec.min_evidence,
        bimodality=bimodality,
        flip_probability=flip_p,
        gap_zscore=z,
        flip_z=espec.flip_z,
        flip_min_prob=espec.flip_min_prob,
    )
    out = {
        "uid": meta["uid"],
        "index": int(meta["index"]),
        "family": meta["family"],
        "size": meta["size"],
        "machine": machine.name,
        "backend": meta.get("backend", ""),
        "measurements_per_alg": session.measurements_per_alg,
        "iterations": session.iterations,
        "converged": session.converged,
        "gap_zscore": z if np.isfinite(z) else None,
        "flip_probability": flip_p,
        "bimodality": bimodality.to_dict(),
        "attribution": {
            "winner": attrs[winner].row(),
            "loser": attrs[loser].row(),
        },
    }
    out.update(expl.to_dict())
    return out


# --------------------------------------------------------------- the runner ---


def _wall_clock_explain_timers(
    espec: ExplainSpec,
    sweep_spec: SweepSpec,
    records_by_uid: Mapping[str, Mapping[str, Any]],
    uids: Sequence[str],
    device: DeviceLike = "cuda",
) -> Dict[str, Timer]:
    """Rebuild wall-clock segment backends for a resumed chunk on
    ``device`` (callables do not serialize; everything derives from the
    census records)."""
    timers: Dict[str, Timer] = {}
    for uid in uids:
        record = records_by_uid[uid]
        winner, loser = pick_winner_loser(record)
        all_kernels = kernels_from_record(record)
        kernels = {winner: all_kernels[winner], loser: all_kernels[loser]}
        timers[uid] = WallClockTimer(
            _wall_clock_workloads(sweep_spec, record, (winner, loser), kernels,
                                  device)
        )
    return timers


def run_explain_shard(
    espec: ExplainSpec,
    root: str,
    shard: int,
    *,
    max_steps: Optional[int] = None,
    progress: Optional[Callable[[str], None]] = None,
    census: Optional[Tuple[SweepSpec, List[Dict[str, Any]]]] = None,
    heartbeat: Optional[Callable[..., None]] = None,
    faults: Optional[FaultPlan] = None,
    device: DeviceLike = "cuda",
) -> ShardStore:
    """Run (or resume) one shard of the explanation campaign to completion.
    A wall-clock census's workloads are built and timed on ``device``.

    Identical persistence contract to :func:`repro_torch.core.sweep.run_shard`:
    anomalies are processed in chunks of ``espec.chunk_size``, each chunk
    one interleaved engine campaign persisted every ``espec.save_every``
    steps; completed chunks append explanation records to the shard JSONL
    and drop the engine state. Any kill point resumes losing at most
    ``save_every`` steps of work and zero determinism (cost_model /
    simulated censuses resume bit-identical).

    ``census`` is an optional preloaded :func:`explain_targets` result —
    workers driving several shards pass it so the census JSONLs are parsed
    once per process, not once per shard. ``heartbeat`` is the work-queue
    lease hook (see :func:`repro_torch.core.sweep.run_chunked_campaign`).

    Wall-clock stage totals land in the shard's sidecar timings file under
    explain-stage names: ``decompose_s`` (session build — kernel
    decomposition + workload setup), ``measure_s`` (engine steps),
    ``classify_s`` (attribution / classification in record_fn) and
    ``append_s`` (store I/O) — the attribution substrate for explain
    throughput regressions.
    """
    if faults is None:
        faults = active_plan()
    sweep_spec, targets = census if census is not None else explain_targets(espec)
    mine = shard_targets(espec, targets, shard)
    records_by_uid = {str(r["uid"]): r for r in mine}
    store = ShardStore(root, shard, fsync=espec.fsync, faults=faults).open()
    rebuild = None
    if sweep_spec.backend == "wall_clock":
        rebuild = lambda names: _wall_clock_explain_timers(
            espec, sweep_spec, records_by_uid, names, device
        )
    timings: Dict[str, float] = {}
    run_chunked_campaign(
        store,
        list(records_by_uid),
        lambda uid: build_explain_session(espec, sweep_spec, records_by_uid[uid],
                                          device),
        lambda session: record_from_explain_session(session, espec),
        chunk_size=espec.chunk_size,
        save_every=espec.save_every,
        rebuild_timers=rebuild,
        max_steps=max_steps,
        progress=progress,
        label=f"explain shard {shard}",
        heartbeat=heartbeat,
        timings=timings,
        faults=faults,
    )
    if timings:
        store.add_timings({
            "decompose_s": timings.get("build_s", 0.0),
            "measure_s": timings.get("step_s", 0.0),
            "classify_s": timings.get("record_s", 0.0),
            "append_s": timings.get("append_s", 0.0),
            "steps": timings.get("steps", 0.0),
            "records": timings.get("records", 0.0),
        })
    return store


# ------------------------------------------------------------ merge/triage ---


def merge_explained(espec: ExplainSpec, root: str,
                    *, strict: bool = True) -> List[Dict[str, Any]]:
    """All shard explanation records, deduped by uid, in census grid order.

    ``strict`` (the default) refuses to merge past mid-file damage, like
    :func:`repro_torch.core.sweep.merge_shards` — run fsck, then merge."""
    seen: Dict[str, Dict[str, Any]] = {}
    damaged: Dict[int, int] = {}
    for shard in range(espec.n_shards):
        store = ShardStore(root, shard).open(readonly=True)
        if store.damaged:
            damaged[shard] = len(store.damaged)
        for r in store.records:
            seen.setdefault(r["uid"], r)
    if damaged and strict:
        detail = ", ".join(f"shard {s}: {n} line(s)"
                           for s, n in sorted(damaged.items()))
        raise StoreDamaged(
            f"{root} holds {sum(damaged.values())} damaged record line(s) "
            f"({detail}) — refusing to merge past silent data loss; run "
            f"`python -m repro_torch fsck --out {root}` first"
        )
    return sorted(seen.values(), key=lambda r: r["index"])


def write_merged_explained(
    espec: ExplainSpec, root: str, path: Optional[str] = None
) -> str:
    path = path or os.path.join(root, "merged.jsonl")
    records = merge_explained(espec, root)
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        for r in records:
            fh.write(json.dumps(r, sort_keys=True, separators=(",", ":")) + "\n")
    os.replace(tmp, path)
    return path


def explain_summary(records: Sequence[Mapping[str, Any]]) -> Dict[str, Any]:
    """Cause-rate aggregates: overall, by cause, by family x cause, and the
    offending-kernel-op tally — the numbers behind the cause tables."""
    n = len(records)

    def cause_agg(rows: Sequence[Mapping[str, Any]]) -> Dict[str, Any]:
        by: Dict[str, Dict[str, Any]] = {}
        for r in rows:
            c = by.setdefault(r["cause"], {"n": 0, "evidence_sum": 0.0})
            c["n"] += 1
            c["evidence_sum"] += float(r["evidence"])
        return {
            cause: {
                "n": c["n"],
                "share": c["n"] / len(rows) if rows else 0.0,
                "mean_evidence": c["evidence_sum"] / c["n"],
            }
            for cause, c in sorted(by.items())
        }

    by_family: Dict[str, Any] = {}
    for fam in sorted({r["family"] for r in records}):
        by_family[fam] = cause_agg([r for r in records if r["family"] == fam])
    offending: Dict[str, int] = {}
    for r in records:
        k = r.get("offending_kernel")
        if k:
            op = k.split("[", 1)[0]
            offending[op] = offending.get(op, 0) + 1
    return {
        "total": n,
        "mean_evidence": (
            sum(float(r["evidence"]) for r in records) / n if n else 0.0
        ),
        "by_cause": cause_agg(list(records)),
        "by_family_cause": by_family,
        "offending_ops": offending,
    }


def explain_progress(
    espec: ExplainSpec,
    root: str,
    targets: Optional[Sequence[Mapping[str, Any]]] = None,
) -> Dict[str, Any]:
    """Explained / total anomalies per shard (the status line). ``targets``
    is an optional preloaded anomaly list — drivers that already parsed
    the census skip a second parse. Done counts are served from the slim
    shard manifests (:func:`repro_torch.core.sweep.shard_counts`) — a status
    poll no longer re-parses every explanation JSONL."""
    if targets is None:
        _, targets = explain_targets(espec)
    per_shard = []
    total_done = 0
    total_damaged = 0
    for shard in range(espec.n_shards):
        n_total = len(shard_targets(espec, targets, shard))
        store = ShardStore(root, shard)
        counts = shard_counts(store)
        per_shard.append({
            "shard": shard, "done": counts["done"], "total": n_total,
            "in_flight_chunk": os.path.exists(store.engine_path),
            "damaged": counts.get("damaged", 0),
        })
        total_done += counts["done"]
        total_damaged += counts.get("damaged", 0)
    return {
        "name": espec.name,
        "anomalies": len(targets),
        "completed": total_done,
        "damaged": total_damaged,
        "shards": per_shard,
    }
