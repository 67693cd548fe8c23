"""DiscriminantSweep — a sharded, resumable census of the FLOPs test.

The paper's headline experiment is not one ranking but a *census* (Sec.
IV-V, Figs. 5-7): sweep many instances of many expression families, run the
FLOPs-discriminant test on each, and report the anomaly rate by instance
size and family. This module promotes that experiment to a first-class
subsystem on top of the :class:`~repro_torch.core.engine.ExperimentEngine`:

* :class:`SweepSpec` — a JSON-serializable grid over expression families
  (paper chains via :mod:`repro_torch.expressions.instances` *and* the
  beyond-chain families of :mod:`repro_torch.expressions.generalized`), expanded
  deterministically into :class:`InstanceSpec` rows and partitioned
  round-robin into ``n_shards`` independent shards.
* :class:`ShardStore` — one append-only JSONL results file per shard plus a
  manifest. Records are appended in whole fsync'd batches; on open, a torn
  trailing line (SIGKILL mid-append) is truncated away, so the JSONL is the
  authoritative completed-set and a killed sweep resumes exactly where it
  stopped.
* :func:`run_shard` — drives a shard's instances in chunks; each chunk is
  one interleaved engine campaign whose state (measurement stores, timer
  RNG, quantile-ladder history) is persisted every ``save_every`` steps via
  the bit-identical session save/load, so resumed results are *identical*
  to an uninterrupted run for the deterministic backends.
* :func:`merge_shards` / :func:`census_summary` — the merge/triage layer:
  dedup by instance, order by grid index, and aggregate anomaly rates by
  family and instance size.

Measurement backends (``SweepSpec.backend``):

``cost_model``
    Deterministic synthetic machine: each algorithm's predicted time is its
    analytic FLOP count over ``flop_rate``, times a per-algorithm machine
    efficiency factor (lognormal, ``eff_sigma``) drawn from an
    instance-seeded RNG — modelling the cache/instruction-order effects
    that make equal-FLOPs algorithms genuinely differ — measured through a
    :class:`~repro_torch.core.measure.CostModelTimer` with lognormal measurement
    noise (``noise_sigma``). Fully serializable: kill/resume is
    bit-identical.
``simulated``
    Same synthetic costs through a :class:`~repro_torch.core.measure.SimulatedTimer`
    (optionally bimodal, reproducing the paper's turbo-boost regime). Also
    bit-identical on resume.
``wall_clock``
    Real PyTorch executions of the instance's algorithms on an explicit
    device (``run_shard(..., device=)``, default ``"cuda"``). Resumable (no
    completed instance is re-measured) but new measurements are real time,
    so resumed runs are statistically — not bitwise — equivalent.

A copy of the reference's ``repro.core.sweep``: every byte that reaches a
record or ``spec.json`` (key order, float formatting, the CRC, the uids,
the numpy seeding) is the reference's, so the deterministic backends give
byte-identical stores in both packages. The spec carries no device: the
device is the caller's (the ``--device`` flag of the CLI), and only the
wall-clock backend touches it. Expression generators are imported lazily
inside the builders, and only the wall-clock backend executes any.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import time
import zlib
from dataclasses import dataclass, field
from typing import (
    Any, Callable, ContextManager, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple,
)

import numpy as np

from .discriminant import flops_discriminant_test
from .engine import ExperimentEngine
from .family import InstanceSpec, family_names, get_family
from .faults import FaultPlan, InjectedFault, active_plan
from ..device import DeviceLike
from .measure import CostModelTimer, NoiseProfile, SimulatedTimer, Timer, WallClockTimer
from .retry import STORE_IO_POLICY, with_retries
from .scores import filter_candidates, initial_hypothesis_by_time
from .session import MeasurementSession

__all__ = [  # InstanceSpec re-exported: it moved to repro_torch.core.family
    "BACKENDS", "InstanceSpec", "SweepSpec", "ShardStore", "StoreDamaged",
    "instance_entry", "build_timer", "build_sweep_session",
    "record_from_session", "run_chunked_campaign", "run_shard",
    "merge_shards", "write_merged", "census_summary", "sweep_progress",
]

#: Backends a sweep can measure with. The first two serialize their RNG
#: state, which is what makes kill/resume bit-identical.
BACKENDS = ("cost_model", "simulated", "wall_clock")


@dataclass
class SweepSpec:
    """The whole census, declaratively: family grids + campaign knobs.

    ``families`` maps a family name to its grid parameters:

    * ``chain``: ``{"count": int, "n_matrices": [int, ...], "lo": int,
      "hi": int}`` — ``count`` random chain instances cycling through the
      ``n_matrices`` list, dims uniform in ``[lo, hi]``.
    * generalized families: ``{"sizes": [int, ...], "per_size": int}`` —
      ``per_size`` seeded instances at each size.

    The expansion (and everything downstream: instance seeds, synthetic
    machine, shard assignment) is a pure function of this spec, so any
    worker anywhere produces the same census rows for the same spec.
    """

    name: str = "census"
    families: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    n_shards: int = 8
    backend: str = "cost_model"
    # synthetic machine (cost_model / simulated backends)
    flop_rate: float = 5e10
    eff_sigma: float = 0.05
    noise_sigma: float = 0.02
    bimodal_shift: float = 0.0
    bimodal_prob: float = 0.0
    #: fraction of instances whose measurement distributions go bimodal
    #: (turbo/frequency regime ground truth for the explainer's
    #: mode-mixture test). 1.0 = every instance (the historical behaviour
    #: when bimodal_prob > 0); the per-instance gate draws from entropy
    #: stream 4, so which instances are bimodal is reconstructible from
    #: (base_seed, index) alone.
    bimodal_frac: float = 1.0
    #: inter-kernel cache-reuse injection: with probability
    #: ``cache_reuse_frac`` (per algorithm, entropy stream 5) an
    #: algorithm's *whole-run* time is cut by ``cache_reuse_saving`` —
    #: adjacent kernels sharing cache — while its isolated kernel segments
    #: keep their full cost, so the explainer sees a negative residual.
    cache_reuse_frac: float = 0.0
    cache_reuse_saving: float = 0.0
    #: fixed per-kernel-launch overhead (seconds) the synthetic machine
    #: charges between kernels of a whole-algorithm run AND once per
    #: isolated segment — at tiny sizes this dominates and algorithms with
    #: more kernels lose (the paper's dispatch-bound regime).
    dispatch_s: float = 0.0
    # campaign (Procedure 4 / engine)
    m_per_iteration: int = 3
    eps: float = 0.03
    max_measurements: int = 24
    rt_threshold: float = 1.5
    flops_rel_tol: float = 0.0
    policy: str = "least_converged_first"
    chunk_size: int = 8
    save_every: int = 25
    base_seed: int = 0
    #: fsync record batches. SIGKILL-survival never needs this (the page
    #: cache outlives the process); enable it when the census must survive
    #: power loss / host crash too. Off by default: fsync serializes all
    #: workers behind the journal on many filesystems.
    fsync: bool = False
    #: active-census gate: path to a trained :mod:`repro_torch.predict` model
    #: (JSON). When set, instances whose predicted ranking confidence
    #: clears ``predict_threshold`` are emitted as
    #: ``provenance="predicted"`` records WITHOUT measurement; the rest
    #: measure normally. Living in the spec (not a CLI flag) means every
    #: worker and queue host applies the same gate, and predicted records
    #: stay a pure function of (spec, model file) — byte-identical across
    #: kills and resumes like everything else in the store.
    predictor_model: str = ""
    #: minimum predicted ranking confidence (1 - worst rank-flip
    #: probability) required to skip an instance's measurement.
    predict_threshold: float = 0.95

    def __post_init__(self) -> None:
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; one of {BACKENDS}")
        if self.n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        if not 0.0 <= self.bimodal_frac <= 1.0:
            raise ValueError("bimodal_frac must be in [0, 1]")
        if not 0.0 <= self.cache_reuse_frac <= 1.0:
            raise ValueError("cache_reuse_frac must be in [0, 1]")
        if not 0.0 <= self.cache_reuse_saving < 1.0:
            raise ValueError("cache_reuse_saving must be in [0, 1)")
        if self.dispatch_s < 0.0:
            raise ValueError("dispatch_s must be >= 0")
        if not 0.0 <= self.predict_threshold <= 1.0:
            raise ValueError("predict_threshold must be in [0, 1]")
        unknown = set(self.families) - set(family_names())
        if unknown:
            raise ValueError(
                f"unknown families {sorted(unknown)}; one of {family_names()}"
            )

    # -------------------------------------------------------- expansion ---

    def expand(self) -> List[InstanceSpec]:
        """The full census grid, in deterministic global order: each
        registered family expands its own grid dict; the sweep concatenates
        (sorted by family name), checks uid uniqueness, and assigns global
        indices."""
        out: List[InstanceSpec] = []
        for family in sorted(self.families):
            out.extend(get_family(family).expand_grid(self.families[family]))
        uids = [i.uid for i in out]
        if len(set(uids)) != len(uids):
            dupes = sorted({u for u in uids if uids.count(u) > 1})
            raise ValueError(
                f"grid expands to duplicate instance uids {dupes[:5]} — "
                "deduplicate the family sizes/counts (the shard store keys "
                "records by uid, so duplicates could never all complete)"
            )
        return [
            dataclasses.replace(inst, index=i) for i, inst in enumerate(out)
        ]

    def shard_of(self, inst: InstanceSpec) -> int:
        """Round-robin by grid index: adjacent (similar-cost) instances land
        on different shards, so shards stay balanced."""
        return inst.index % self.n_shards

    def shard_instances(self, shard: int) -> List[InstanceSpec]:
        if not 0 <= shard < self.n_shards:
            raise ValueError(f"shard {shard} out of range [0, {self.n_shards})")
        return [i for i in self.expand() if self.shard_of(i) == shard]

    # ------------------------------------------------------ persistence ---

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["version"] = 1
        return d

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "SweepSpec":
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
    def load(cls, path: str) -> "SweepSpec":
        with open(path) as fh:
            return cls.from_dict(json.load(fh))


# ------------------------------------------------------ instance builders ---


def _instance_entropy(spec: SweepSpec, inst: InstanceSpec, stream: int) -> List[int]:
    """Deterministic, collision-free RNG entropy for one instance: distinct
    ``stream`` values give independent streams (machine efficiency vs
    measurement noise vs shuffle)."""
    return [int(spec.base_seed), int(inst.index), int(stream)]


def synthetic_efficiencies(
    names: Iterable[str],
    rng: np.random.Generator,
    eff_sigma: float,
) -> Dict[str, float]:
    """The synthetic machine's frozen per-algorithm lognormal efficiency
    factors, drawn in sorted-name order (the reproducibility contract: any
    consumer that replays the same RNG over the same names recovers the
    same factors — the AnomalyExplainer uses this to reconstruct the
    injected ground truth without touching the census timers)."""
    return {
        name: math.exp(float(rng.normal(0.0, eff_sigma)))
        for name in sorted(names)
    }


def synthetic_costs(
    flops: Mapping[str, float],
    rng: np.random.Generator,
    flop_rate: float,
    eff_sigma: float,
) -> Dict[str, float]:
    """Predicted seconds per algorithm on the synthetic machine: FLOPs over
    peak rate, times a frozen per-algorithm lognormal efficiency factor.
    The factor models what the paper attributes anomalies to — equal-FLOPs
    algorithms differing in cache behaviour and instruction order — and is
    part of the *machine*, not the measurement noise: it is drawn once per
    instance (in sorted algorithm order, so it is reproducible) and held
    fixed across all measurements."""
    eff = synthetic_efficiencies(flops, rng, eff_sigma)
    return {
        name: float(flops[name]) / flop_rate * eff[name]
        for name in sorted(flops)
    }


def synthetic_cache_reuse(
    names: Iterable[str],
    rng: np.random.Generator,
    reuse_frac: float,
    reuse_saving: float,
) -> Dict[str, float]:
    """Per-algorithm whole-run saving fractions from inter-kernel cache
    reuse, drawn in sorted-name order (same reproducibility contract as
    :func:`synthetic_efficiencies`: replaying the RNG over the same names
    recovers the ground truth). An algorithm with a nonzero saving runs its
    *whole* program ``1 - saving`` times the sum of its kernel costs —
    adjacent kernels hand data over in cache — which the explainer observes
    as a negative attribution residual."""
    if reuse_frac <= 0.0 or reuse_saving <= 0.0:
        return {name: 0.0 for name in sorted(names)}
    return {
        name: reuse_saving if float(rng.random()) < reuse_frac else 0.0
        for name in sorted(names)
    }


@dataclass(frozen=True)
class SyntheticInstanceModel:
    """Everything the synthetic machine decided about ONE instance, rebuilt
    purely from ``(spec knobs, base_seed, index)`` — the census measures
    through it, and the explainer reconstructs it as ground truth."""

    costs: Dict[str, float]            #: whole-algorithm predicted seconds
    efficiencies: Dict[str, float]     #: per-algorithm lognormal factors
    cache_saving: Dict[str, float]     #: per-algorithm whole-run saving
    bimodal: bool                      #: does this instance's timer go bimodal?


def synthetic_instance_model(
    spec: SweepSpec,
    index: int,
    flops: Mapping[str, float],
    kernel_counts: Optional[Mapping[str, int]] = None,
    base_seed: Optional[int] = None,
) -> SyntheticInstanceModel:
    """The synthetic machine's frozen per-instance state. Entropy streams:
    1 = efficiency factors, 4 = bimodal gate, 5 = cache-reuse coins (2/3
    belong to the measurement-noise/shuffle seeds; the explainer uses 11+).
    Streams are only consumed when their knob is active, so censuses with
    default knobs stay byte-identical to pre-knob ones.

    Whole-algorithm cost = ``flops/rate * eff * (1 - cache_saving)`` plus
    ``dispatch_s`` per kernel; isolated segments (the explainer's
    re-measurement) cost ``kernel_flops/rate * eff`` plus ONE dispatch each,
    so dispatch cancels in the residual while cache reuse surfaces as a
    negative one."""
    base = spec.base_seed if base_seed is None else int(base_seed)
    eff = synthetic_efficiencies(
        flops, np.random.default_rng([base, int(index), 1]), spec.eff_sigma
    )
    reuse = synthetic_cache_reuse(
        flops,
        np.random.default_rng([base, int(index), 5]),
        spec.cache_reuse_frac,
        spec.cache_reuse_saving,
    )
    bimodal = spec.bimodal_prob > 0.0 and spec.bimodal_shift != 0.0
    if bimodal and spec.bimodal_frac < 1.0:
        gate = np.random.default_rng([base, int(index), 4])
        bimodal = float(gate.random()) < spec.bimodal_frac
    costs: Dict[str, float] = {}
    for name in sorted(flops):
        c = float(flops[name]) / spec.flop_rate * eff[name]
        if reuse[name] > 0.0:
            c *= 1.0 - reuse[name]
        if spec.dispatch_s > 0.0:
            if kernel_counts is None:
                raise ValueError(
                    "dispatch_s > 0 needs per-algorithm kernel counts"
                )
            c += spec.dispatch_s * int(kernel_counts[name])
        costs[name] = c
    return SyntheticInstanceModel(
        costs=costs, efficiencies=eff, cache_saving=reuse, bimodal=bimodal
    )


def instance_entry(inst: InstanceSpec):
    """(flops table, descriptive meta, workload builder) for one instance —
    resolved through the :mod:`repro_torch.core.family` registry. The
    builder takes the device its workloads run on."""
    return get_family(inst.family).entry(inst)


def build_timer(spec: SweepSpec, inst: InstanceSpec, flops: Mapping[str, float],
                build_workloads: Callable[[DeviceLike], Dict[str, Callable[[], Any]]],
                kernel_counts: Optional[Mapping[str, int]] = None,
                device: DeviceLike = "cuda") -> Timer:
    """The instance's measurement backend, fully derived from the spec;
    the wall-clock backend builds its workloads on ``device``."""
    if spec.backend == "wall_clock":
        return WallClockTimer(build_workloads(device))
    model = synthetic_instance_model(spec, inst.index, flops, kernel_counts)
    noise_seed = np.random.default_rng(
        _instance_entropy(spec, inst, 2)
    ).integers(0, 2**63 - 1)
    if spec.backend == "cost_model":
        return CostModelTimer(
            model.costs, rel_sigma=spec.noise_sigma, seed=int(noise_seed)
        )
    profiles = {
        name: NoiseProfile(
            base=cost,
            rel_sigma=spec.noise_sigma,
            bimodal_shift=spec.bimodal_shift if model.bimodal else 0.0,
            bimodal_prob=spec.bimodal_prob if model.bimodal else 0.0,
        )
        for name, cost in model.costs.items()
    }
    return SimulatedTimer(profiles, seed=int(noise_seed))


def build_sweep_session(spec: SweepSpec, inst: InstanceSpec,
                        device: DeviceLike = "cuda") -> MeasurementSession:
    """Paper Sec. I steps 1-4 for one census instance: single warm run per
    algorithm, RT candidate filtering, initial hypothesis by time, then a
    resumable Procedure-4 session. The FLOP table and filter decisions ride
    in ``session.meta`` so the discriminant verdict survives engine
    save/load without re-deriving the instance."""
    flops, desc, build_workloads = instance_entry(inst)
    kernel_counts = {alg: len(ks) for alg, ks in desc["kernels"].items()}
    timer = build_timer(spec, inst, flops, build_workloads, kernel_counts, device)
    single = {name: timer.measure(name) for name in flops}
    cand = filter_candidates(
        flops, single,
        rt_threshold=spec.rt_threshold, flops_rel_tol=spec.flops_rel_tol,
    )
    h0 = [n for n in initial_hypothesis_by_time(single) if n in cand.names]
    shuffle_seed = int(
        np.random.default_rng(_instance_entropy(spec, inst, 3)).integers(0, 2**31 - 1)
    )
    return MeasurementSession(
        inst.uid,
        h0,
        timer,
        m_per_iteration=spec.m_per_iteration,
        eps=spec.eps,
        max_measurements=spec.max_measurements,
        shuffle_seed=shuffle_seed,
        meta={
            "uid": inst.uid,
            "index": inst.index,
            "family": inst.family,
            "size": desc["size"],
            "dims": desc["dims"],
            "params": dict(inst.params),
            "flops": {k: float(v) for k, v in flops.items()},
            "kernels": desc["kernels"],
            "dropped": list(cand.dropped),
            "backend": spec.backend,
            "base_seed": spec.base_seed,
        },
    )


def record_from_session(session: MeasurementSession, spec: SweepSpec) -> Dict[str, Any]:
    """One census JSONL record (DiscriminantReport + ranking digest).

    Deliberately contains *only* deterministic fields — no wall times, no
    hostnames — so an interrupted-and-resumed sweep merges byte-identical
    to an uninterrupted one (the kill/resume tests diff the files).

    The ``params`` / ``flops`` / ``kernels`` / ``base_seed`` fields are the
    AnomalyExplainer's pointers: together they rebuild the instance — its
    algorithms, kernel segments, and (for the deterministic backends) the
    synthetic machine's injected efficiency factors — without re-expanding
    the grid or re-running any census measurement."""
    meta = session.meta
    ranking = session.result(measure_if_needed=False)
    disc = flops_discriminant_test(
        ranking, {k: float(v) for k, v in meta["flops"].items()},
        flops_rel_tol=spec.flops_rel_tol,
    )
    record = {
        "uid": meta["uid"],
        "index": int(meta["index"]),
        "family": meta["family"],
        "size": meta["size"],
        "dims": meta["dims"],
        "params": dict(meta.get("params", {})),
        "flops": {k: float(v) for k, v in meta["flops"].items()},
        "kernels": meta.get("kernels", {}),
        "base_seed": int(meta.get("base_seed", spec.base_seed)),
        "backend": meta.get("backend", spec.backend),
        "p": len(ranking.sequence),
        "n_dropped": len(meta.get("dropped", ())),
        "measurements_per_alg": ranking.measurements_per_alg,
        "iterations": len(ranking.history),
        "converged": ranking.converged,
        "classes": max(ranking.ranks.values()),
        "is_anomaly": bool(disc.is_anomaly),
        "reason": disc.reason,
        "min_flops_algs": list(disc.min_flops_algs),
        "best_rank_in_sf": disc.best_rank_in_sf,
        "best_rank_overall": disc.best_rank_overall,
        "ranks": disc.ranks,
        "mean_ranks": {k: float(v) for k, v in ranking.mean_ranks.items()},
        "relative_flops": {k: float(v) for k, v in disc.relative_flops.items()},
    }
    if spec.backend == "wall_clock":
        # the WallClockTimer's chosen inner-repeat counts (the
        # minimum-measurable-time guard) — real-time metadata, so only on
        # the backend whose records are never byte-compared across resumes
        repeats = getattr(session.timer, "inner_repeats", None)
        if repeats:
            record["inner_repeats"] = {
                name: int(r) for name, r in sorted(repeats.items())
                if name in meta["flops"]
            }
    return record


# -------------------------------------------------------------- the store ---


class StoreDamaged(RuntimeError):
    """A shard store holds committed-but-unreadable data (mid-file
    corruption, checksum mismatch). Raised instead of silently skipping
    records: a census missing rows it *thinks* it has is worse than a
    failed merge. Run ``fsck`` (``python -m repro_torch fsck --out DIR``)
    to classify, repair, and quarantine the damage, then re-drain."""


def record_crc(record: Mapping[str, Any]) -> str:
    """CRC32 (hex) of the record's canonical serialization, excluding the
    ``_crc`` field itself — idempotent, so re-serializing a stored record
    reproduces the same line bytes."""
    body = {k: v for k, v in record.items() if k != "_crc"}
    data = json.dumps(body, sort_keys=True, separators=(",", ":"))
    return format(zlib.crc32(data.encode("utf-8")) & 0xFFFFFFFF, "08x")


def _record_line(record: Mapping[str, Any]) -> str:
    rec = dict(record)
    rec["_crc"] = record_crc(rec)
    return json.dumps(rec, sort_keys=True, separators=(",", ":")) + "\n"


#: line classification statuses (shared with fsck)
LINE_OK = "ok"                    #: parsed, CRC present and matching
LINE_LEGACY = "legacy"            #: parsed, no ``_crc`` field (pre-CRC shard)
LINE_UNDECODABLE = "undecodable"  #: not valid JSON / not UTF-8
LINE_CRC_MISMATCH = "crc_mismatch"  #: parsed but fails its own checksum


def parse_record_line(line: bytes) -> Tuple[Optional[Dict[str, Any]], str]:
    """Decode one committed JSONL line into ``(record, status)``. Records
    without ``_crc`` are tolerated (legacy shards); a present-but-wrong
    ``_crc`` is damage even when the JSON parses."""
    try:
        rec = json.loads(line.decode("utf-8"))
    except (ValueError, UnicodeDecodeError):
        return None, LINE_UNDECODABLE
    if not isinstance(rec, dict) or "uid" not in rec:
        return None, LINE_UNDECODABLE
    if "_crc" not in rec:
        return rec, LINE_LEGACY
    if rec["_crc"] != record_crc(rec):
        return rec, LINE_CRC_MISMATCH
    return rec, LINE_OK


class ShardStore:
    """Append-only JSONL census records for ONE shard, plus a manifest.

    Crash contract: records are appended in whole fsync'd batches and the
    manifest is rewritten atomically afterwards. The JSONL itself is the
    source of truth on resume — :meth:`open` truncates a torn trailing line
    (kill mid-append) and recomputes the manifest, so the completed set
    never contains a half-written record and never loses a whole one.

    The manifest is *slim*: counts, committed byte length, a rolling CRC32
    of the committed bytes, and per-family tallies — O(1) in shard size,
    so each append rewrites a few hundred bytes instead of re-serializing
    every completed uid, and status polls (:func:`shard_counts`) answer
    from it without parsing the JSONL.

    Integrity contract: every record carries a ``_crc`` field (CRC32 of
    its canonical serialization; absent on legacy shards and tolerated).
    On open, a torn *trailing* line is truncated away as before, but a
    damaged line in the middle of the file — bitrot, a foreign write, a
    filesystem bug — is **damage**, not noise: a writer refuses to touch
    the shard (:class:`StoreDamaged`, fsck repairs it) and a read-only
    consumer counts the damaged lines in :attr:`damaged` so merge can
    fail loudly instead of silently dropping records.
    """

    def __init__(self, root: str, shard: int, fsync: bool = False,
                 faults: Optional[FaultPlan] = None) -> None:
        self.root = root
        self.shard = shard
        self.fsync = fsync
        self.faults = faults
        self.records_path = os.path.join(root, f"shard-{shard:04d}.jsonl")
        self.manifest_path = os.path.join(root, f"shard-{shard:04d}.manifest.json")
        self.engine_path = os.path.join(root, f"shard-{shard:04d}.engine.json")
        self.timings_path = os.path.join(root, f"shard-{shard:04d}.timings.json")
        self.lease_path = os.path.join(root, f"shard-{shard:04d}.lease.json")
        self._records: List[Dict[str, Any]] = []
        self._uids: set = set()
        self._by_family: Dict[str, Dict[str, int]] = {}
        self._records_bytes = 0
        self._records_crc = 0
        #: (line_no, status) of committed-but-unreadable lines (readonly)
        self.damaged: List[Tuple[int, str]] = []
        self._opened = False

    # ---------------------------------------------------------- reading ---

    def open(self, readonly: bool = False) -> "ShardStore":
        """Load (and crash-recover) the shard's records.

        A torn trailing line (SIGKILL mid-append) is always *ignored*; it
        is physically truncated only when ``readonly`` is False. Read-only
        consumers (status / merge / report) may run concurrently with a
        live worker, and what looks like a torn tail to them may be that
        worker's append in flight — only the shard's owning worker, which
        is single per shard, may rewrite the file. A damaged final line
        that the manifest watermark already covers is NOT a torn tail —
        it was a committed record (last-line bitrot) and is treated
        exactly like mid-file damage.

        Mid-file damage (an undecodable or checksum-failing line that is
        NOT the final line) raises :class:`StoreDamaged` for a writer —
        appending past silent damage would hide it behind fresh records —
        and is skipped-but-counted (:attr:`damaged`) for read-only
        consumers, so status can report it and merge can refuse."""
        if not readonly:
            os.makedirs(self.root, exist_ok=True)
        self._records = []
        self._uids = set()
        self._by_family = {}
        self._records_bytes = 0
        self._records_crc = 0
        self.damaged = []
        if os.path.exists(self.records_path):
            with open(self.records_path, "rb") as fh:
                data = fh.read()
            lines = data.splitlines(keepends=True)
            # a damaged FINAL line is a torn (uncommitted, droppable) tail
            # only when it lies past the manifest's byte watermark; one the
            # manifest already committed is last-line bitrot — real damage.
            # Safe under a concurrent writer: its in-flight append is by
            # definition past the watermark (manifest commits afterwards).
            manifest = self.read_manifest()
            try:
                watermark = int((manifest or {}).get("records_bytes", 0))
            except (TypeError, ValueError):
                watermark = 0
            pos = 0
            good_end = 0
            contiguous = True  # no damage seen yet: prefix is truncat-able
            for i, line in enumerate(lines):
                pos += len(line)
                last = i == len(lines) - 1
                committed = pos <= watermark
                if not line.endswith(b"\n"):
                    if committed:
                        if not readonly:
                            raise StoreDamaged(
                                f"{self.records_path}: line {i + 1} lost "
                                "its terminator inside the committed "
                                "region (last-line bitrot) — run fsck "
                                "before writing to this shard"
                            )
                        self.damaged.append((i + 1, LINE_UNDECODABLE))
                        contiguous = False
                    break  # torn tail: the batch never committed
                rec, status = parse_record_line(line)
                if status in (LINE_UNDECODABLE, LINE_CRC_MISMATCH):
                    if last and not committed:
                        break  # a torn tail that happens to end in \n
                    if not readonly:
                        raise StoreDamaged(
                            f"{self.records_path}: line {i + 1} is "
                            f"{status} mid-file — run fsck before writing "
                            "to this shard"
                        )
                    self.damaged.append((i + 1, status))
                    contiguous = False
                    continue
                self._records.append(rec)
                self._uids.add(rec["uid"])
                self._tally(rec)
                self._records_crc = zlib.crc32(line, self._records_crc)
                if contiguous:
                    good_end += len(line)
            self._records_bytes = good_end
            if good_end < len(data) and not readonly and not self.damaged:
                with open(self.records_path, "r+b") as fh:
                    fh.truncate(good_end)
        self._opened = True
        return self

    @property
    def records(self) -> List[Dict[str, Any]]:
        self._ensure_open()
        return list(self._records)

    def completed_uids(self) -> List[str]:
        self._ensure_open()
        return [r["uid"] for r in self._records]

    def _ensure_open(self) -> None:
        if not self._opened:
            raise RuntimeError("ShardStore.open() must be called first")

    def _tally(self, rec: Mapping[str, Any]) -> None:
        fam = self._by_family.setdefault(
            str(rec.get("family", "?")), {"done": 0, "anomalies": 0}
        )
        fam["done"] += 1
        if rec.get("is_anomaly"):
            fam["anomalies"] += 1
        # skipped-instance accounting is part of the manifest contract:
        # an active census must never hide how much it did not measure.
        # The key appears only when predicted records exist, so manifests
        # of ordinary censuses keep their historical shape.
        if rec.get("provenance") == "predicted":
            fam["predicted"] = fam.get("predicted", 0) + 1

    # ---------------------------------------------------------- writing ---

    def append_records(self, records: Sequence[Mapping[str, Any]]) -> int:
        """Append a batch (skipping already-present uids) as ONE serialized
        write, fsync if configured, refresh the slim manifest. Returns the
        number actually appended.

        Transient ``OSError`` is retried with bounded backoff; before each
        (re)try the file is truncated back to the committed watermark, so
        a half-written first attempt can never leave garbage in front of
        the retried batch."""
        self._ensure_open()
        fresh = [dict(r) for r in records if r["uid"] not in self._uids]
        if fresh:
            data = "".join(_record_line(r) for r in fresh).encode("utf-8")
            with_retries(
                lambda: self._commit_batch(data),
                policy=STORE_IO_POLICY,
                seed=f"append:{self.records_path}",
                describe=f"append to {self.records_path}",
            )
            self._records.extend(fresh)
            for r in fresh:
                self._uids.add(r["uid"])
                self._tally(r)
            self._records_bytes += len(data)
            self._records_crc = zlib.crc32(data, self._records_crc)
        self.write_manifest()
        return len(fresh)

    def _commit_batch(self, data: bytes) -> None:
        """One append attempt: truncate away any previous failed attempt,
        write the whole batch, flush (fsync if configured). Fault-injection
        sites ``store.append`` (torn_write / corrupt_byte / io_error) and
        ``store.fsync`` (drop_fsync) live here."""
        specs = self.faults.poke("store.append") if self.faults else []
        with open(self.records_path, "ab") as fh:
            if fh.tell() > self._records_bytes:
                fh.truncate(self._records_bytes)
            for spec in specs:
                if spec.op == "torn_write" and self.faults.claim(spec):
                    cut = max(1, min(len(data) - 1,
                                     int(len(data) * (spec.arg or 0.5))))
                    fh.write(data[:cut])
                    fh.flush()
                    raise InjectedFault(
                        f"torn append after {cut}/{len(data)} bytes "
                        f"({spec.id})"
                    )
            fh.write(data)
            fh.flush()
            if self.fsync:
                dropped = self.faults.poke("store.fsync") if self.faults else []
                if not any(s.op == "drop_fsync" and self.faults.claim(s)
                           for s in dropped):
                    os.fsync(fh.fileno())
        # bitrot simulation: flip one byte of an EARLIER, committed record
        # (only after something is committed — stays armed until then)
        for spec in specs:
            if (spec.op == "corrupt_byte" and self._records_bytes > 0
                    and self.faults.claim(spec)):
                offset = self.faults.rng(spec).randrange(self._records_bytes)
                with open(self.records_path, "r+b") as fh:
                    fh.seek(offset)
                    if fh.read(1) == b"\n":
                        offset = max(0, offset - 1)
                    fh.seek(offset)
                    fh.write(b"\x00")

    def write_manifest(self, done: Optional[bool] = None) -> None:
        self._ensure_open()
        manifest = {
            "shard": self.shard,
            "n_completed": len(self._records),
            "records_bytes": self._records_bytes,
            "records_crc32": format(self._records_crc & 0xFFFFFFFF, "08x"),
            "by_family": self._by_family,
        }
        if done is not None:
            manifest["done"] = bool(done)

        def commit() -> None:
            tmp = self.manifest_path + ".tmp"
            with open(tmp, "w") as fh:
                json.dump(manifest, fh, indent=1, sort_keys=True)
                fh.flush()
                if self.fsync:
                    os.fsync(fh.fileno())
            os.replace(tmp, self.manifest_path)

        with_retries(
            commit,
            policy=STORE_IO_POLICY,
            seed=f"manifest:{self.manifest_path}",
            describe=f"manifest rewrite {self.manifest_path}",
        )

    def read_manifest(self) -> Optional[Dict[str, Any]]:
        """The on-disk manifest (no open() needed), or None."""
        try:
            with open(self.manifest_path) as fh:
                return json.load(fh)
        except (OSError, ValueError):
            return None

    # ----------------------------------------------------- engine state ---

    def has_engine_state(self) -> bool:
        return os.path.exists(self.engine_path)

    def clear_engine_state(self) -> None:
        if os.path.exists(self.engine_path):
            os.remove(self.engine_path)

    # ---------------------------------------------------------- timings ---

    def add_timings(self, delta: Mapping[str, float]) -> None:
        """Accumulate wall-clock stage timings into the shard's sidecar
        timings file (load + add + atomic replace). Advisory only — wall
        times live here, NOT in the records, so the JSONL stays
        byte-identical across kills, resumes, and host takeovers."""
        totals: Dict[str, float] = {}
        try:
            with open(self.timings_path) as fh:
                totals = {k: float(v) for k, v in json.load(fh).items()}
        except (OSError, ValueError):
            totals = {}
        for k, v in delta.items():
            totals[k] = totals.get(k, 0.0) + float(v)
        tmp = self.timings_path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(totals, fh, indent=1, sort_keys=True)
        os.replace(tmp, self.timings_path)


def shard_counts(store: ShardStore) -> Dict[str, Any]:
    """Done/anomaly tallies for one shard WITHOUT parsing its whole JSONL.

    Served from the slim manifest, then a tail-scan of only the bytes a
    live worker appended past the manifest's ``records_bytes`` watermark
    (the manifest commits after the JSONL, so the watermark always sits on
    a committed line boundary; a torn tail line is skipped). Falls back to
    the authoritative full parse for legacy manifests (pre-watermark
    format) or when the file shrank under the watermark (foreign rewrite).
    """
    manifest = store.read_manifest()
    legacy = (
        manifest is None
        or "records_bytes" not in manifest
        or "by_family" not in manifest
    )
    if not legacy:
        try:
            size = os.path.getsize(store.records_path)
        except OSError:
            size = 0
        base = int(manifest["records_bytes"])
        if size < base:
            legacy = True  # file shrank: manifest is stale, rescan
    if legacy:
        n_done = 0
        n_damaged = 0
        by_family: Dict[str, Dict[str, int]] = {}
        done_flag = bool(manifest.get("done")) if manifest else False
        if os.path.exists(store.records_path):
            scan = ShardStore(store.root, store.shard).open(readonly=True)
            n_done = len(scan._records)
            n_damaged = len(scan.damaged)
            by_family = scan._by_family
        return {"done": n_done, "by_family": by_family,
                "done_flag": done_flag, "damaged": n_damaged}
    n_done = int(manifest["n_completed"])
    n_damaged = 0
    by_family = {
        f: {"done": int(c.get("done", 0)),
            "anomalies": int(c.get("anomalies", 0)),
            **({"predicted": int(c["predicted"])} if "predicted" in c else {})}
        for f, c in manifest["by_family"].items()
    }
    if size > base:
        with open(store.records_path, "rb") as fh:
            fh.seek(base)
            tail = fh.read()
        lines = tail.splitlines(keepends=True)
        for i, line in enumerate(lines):
            if not line.endswith(b"\n"):
                break
            rec, status = parse_record_line(line)
            if status in (LINE_UNDECODABLE, LINE_CRC_MISMATCH):
                if i == len(lines) - 1:
                    break  # an append in flight; not yet damage
                n_damaged += 1
                continue
            n_done += 1
            fam = by_family.setdefault(
                str(rec.get("family", "?")), {"done": 0, "anomalies": 0}
            )
            fam["done"] += 1
            if rec.get("is_anomaly"):
                fam["anomalies"] += 1
            if rec.get("provenance") == "predicted":
                fam["predicted"] = fam.get("predicted", 0) + 1
    return {
        "done": n_done,
        "by_family": by_family,
        "done_flag": bool(manifest.get("done", False)),
        "damaged": n_damaged,
    }


# -------------------------------------------------------------- the runner ---


def _wall_clock_timers(
    spec: SweepSpec, instances: Mapping[str, InstanceSpec], uids: Iterable[str],
    device: DeviceLike = "cuda",
) -> Dict[str, Timer]:
    """Rebuild wall-clock backends for a resumed engine chunk (callables do
    not serialize; everything derives from the spec and the device). The
    chunk's host work is started first (:func:`_prefetch`)."""
    uids = list(uids)
    _prefetch(instances, uids)
    timers: Dict[str, Timer] = {}
    for uid in uids:
        inst = instances[uid]
        flops, _, build_workloads = instance_entry(inst)
        timers[uid] = WallClockTimer(build_workloads(device))
    return timers


def _prefetch(instances: Mapping[str, InstanceSpec], uids: Sequence[str]) -> None:
    """Each family's :meth:`~repro_torch.core.family.AlgorithmFamily.prefetch`
    for its instances among ``uids``, in build order."""
    by_family: Dict[str, List[InstanceSpec]] = {}
    for uid in uids:
        by_family.setdefault(instances[uid].family, []).append(instances[uid])
    for name, insts in by_family.items():
        get_family(name).prefetch(insts)


def run_chunked_campaign(
    store: ShardStore,
    todo_uids: Sequence[str],
    build_session: Callable[[str], MeasurementSession],
    record_fn: Callable[[MeasurementSession], Dict[str, Any]],
    *,
    chunk_size: int,
    save_every: int,
    policy: str = "least_converged_first",
    rebuild_timers: Optional[Callable[[Sequence[str]], Dict[str, Timer]]] = None,
    max_steps: Optional[int] = None,
    progress: Optional[Callable[[str], None]] = None,
    label: str = "shard",
    heartbeat: Optional[Callable[..., None]] = None,
    timings: Optional[Dict[str, float]] = None,
    faults: Optional[FaultPlan] = None,
    predictor: Optional[Callable[[str], Optional[Dict[str, Any]]]] = None,
    start_chunk: Optional[Callable[[Sequence[str]], None]] = None,
) -> bool:
    """The shared chunk/resume/save/append loop behind every sharded
    campaign (census shards AND anomaly explanations — one copy of the
    kill/resume state machine, not one per subsystem).

    ``todo_uids`` (minus the store's completed set) is processed in chunks
    of ``chunk_size``; each chunk is one interleaved
    :class:`~repro_torch.core.engine.ExperimentEngine` campaign built by
    ``build_session(uid)``. Engine state persists every ``save_every``
    steps and at every chunk boundary; a completed chunk appends
    ``record_fn(session)`` rows to the store's JSONL and drops the engine
    state. Any kill point therefore resumes losing at most ``save_every``
    engine steps of *work* and zero steps of *determinism* (serialized
    timer RNG state replays the lost steps bit-identically for the
    cost_model / simulated backends). ``rebuild_timers`` re-attaches
    non-serializable (wall-clock) backends on resume. Returns True when
    every uid completed, False when paused on the ``max_steps`` budget.

    ``heartbeat`` (the work-queue hook) is called once per session build
    and engine step, and as ``heartbeat(True)`` immediately before every
    record append — :meth:`repro_torch.core.lease.Lease.heartbeat` fits the
    shape. An exception it raises (``LeaseLost``) aborts the shard BEFORE
    the commit, so a taken-over shard never gets records from two owners.

    ``timings``, if given, accumulates wall-clock stage seconds in place:
    ``build_s`` (session construction — decomposition, workload setup),
    ``step_s`` (engine measurement + mean-rank analysis), ``record_s``
    (record_fn — discriminant / classification), ``append_s`` (store I/O),
    plus ``steps`` / ``records`` counts. Pure observability — nothing here
    feeds back into measurements or records.

    ``faults`` is the chaos hook: the ``campaign.step`` injection site is
    poked once per engine step (sigkill / stall ops — see
    :mod:`repro_torch.core.faults`).

    ``predictor`` is the active-census gate: called once per todo uid
    BEFORE any chunk is built, it returns either a complete
    ``provenance="predicted"`` record (the instance is recorded without
    measurement) or ``None`` (measure it normally). Predicted records
    commit through the ordinary append path — CRC'd, deduped,
    manifest-tallied — and the gate runs before chunking on every
    (re)entry, so a killed active census resumes byte-identically: the
    remaining todo re-predicts to the same records, and engine chunks
    only ever contain gate-rejected uids. The skipped count is announced
    via ``progress`` and lands in the manifest's per-family ``predicted``
    tallies — never silent.

    ``start_chunk``, if given, is called with a new chunk's uids before its
    first session is built (the census's draw-ahead, :func:`run_shard`).
    Every session of a chunk is built before its first engine step.
    """
    say = progress or (lambda msg: None)
    beat = heartbeat or (lambda *a: None)
    t = timings if timings is not None else {}
    completed = set(store.completed_uids())
    total = len(todo_uids)
    todo = [u for u in todo_uids if u not in completed]
    steps_left = max_steps

    if predictor is not None and todo:
        t0 = time.perf_counter()
        predicted: List[Dict[str, Any]] = []
        remaining: List[str] = []
        for uid in todo:
            beat()
            rec = predictor(uid)
            if rec is None:
                remaining.append(uid)
            else:
                predicted.append(rec)
        t["predict_s"] = t.get("predict_s", 0.0) + (time.perf_counter() - t0)
        if predicted:
            beat(True)  # prove ownership right before the commit
            t0 = time.perf_counter()
            store.append_records(predicted)
            t["append_s"] = t.get("append_s", 0.0) + (time.perf_counter() - t0)
            t["predicted"] = t.get("predicted", 0.0) + len(predicted)
            completed.update(r["uid"] for r in predicted)
            say(f"{label}: {len(predicted)}/{total} instances predicted "
                f"without measurement ({len(remaining)} to measure)")
        todo = remaining

    while True:
        engine: Optional[ExperimentEngine] = None
        if store.has_engine_state():
            try:
                with open(store.engine_path) as fh:
                    state = json.load(fh)
                timers = None
                if rebuild_timers is not None:
                    names = [s["name"] for s in state["sessions"]]
                    timers = rebuild_timers(names)
                engine = ExperimentEngine.load(store.engine_path, timers=timers)
            except (ValueError, KeyError, TypeError):
                # corrupt in-flight state (bitrot; engine.save is atomic so
                # a kill can't cause this): rebuilding the chunk from the
                # todo list replays it bit-identically for the
                # deterministic backends — drop the state, warn, rebuild
                say(f"{label}: corrupt engine state discarded (chunk will "
                    "be re-run deterministically)")
                store.clear_engine_state()
                continue
            chunk_uids = engine.session_names
            if all(uid in completed for uid in chunk_uids):
                # killed between record append and state cleanup
                store.clear_engine_state()
                continue
            say(f"{label}: resuming chunk of {len(chunk_uids)}")
        else:
            chunk = todo[:chunk_size]
            if not chunk:
                break
            engine = ExperimentEngine(policy=policy)
            t0 = time.perf_counter()
            if start_chunk is not None:
                start_chunk(chunk)
            for uid in chunk:
                beat()
                engine.add_session(build_session(uid))
            t["build_s"] = t.get("build_s", 0.0) + (time.perf_counter() - t0)
            engine.save(store.engine_path)
            chunk_uids = engine.session_names
            say(f"{label}: new chunk of {len(chunk)} "
                f"({len(completed)}/{total} done)")

        since_save = 0
        while not engine.done:
            if steps_left is not None and steps_left <= 0:
                engine.save(store.engine_path)
                say(f"{label}: paused (step budget)")
                return False
            if faults is not None:
                faults.poke("campaign.step")
            beat()
            t0 = time.perf_counter()
            stepped = engine.step()
            t["step_s"] = t.get("step_s", 0.0) + (time.perf_counter() - t0)
            if stepped is None:
                break
            t["steps"] = t.get("steps", 0.0) + 1
            since_save += 1
            if steps_left is not None:
                steps_left -= 1
            if since_save >= save_every:
                engine.save(store.engine_path)
                since_save = 0

        t0 = time.perf_counter()
        records = [record_fn(engine.session(uid)) for uid in chunk_uids]
        t["record_s"] = t.get("record_s", 0.0) + (time.perf_counter() - t0)
        t["records"] = t.get("records", 0.0) + len(records)
        beat(True)  # prove ownership right before the commit
        t0 = time.perf_counter()
        store.append_records(records)
        t["append_s"] = t.get("append_s", 0.0) + (time.perf_counter() - t0)
        store.clear_engine_state()
        completed.update(chunk_uids)
        todo = [u for u in todo if u not in completed]

    store.write_manifest(done=True)
    say(f"{label}: done ({len(completed)}/{total})")
    return True


def run_shard(
    spec: SweepSpec,
    root: str,
    shard: int,
    *,
    max_steps: Optional[int] = None,
    progress: Optional[Callable[[str], None]] = None,
    heartbeat: Optional[Callable[..., None]] = None,
    faults: Optional[FaultPlan] = None,
    device: DeviceLike = "cuda",
) -> ShardStore:
    """Run (or resume) one shard of the census to completion — the census
    instantiation of :func:`run_chunked_campaign` (see there for the
    persistence/resume contract). ``max_steps`` bounds the engine steps
    this call takes (the shard is left resumable mid-chunk) — used by
    tests and deadline-driven callers. ``heartbeat`` is the work-queue
    lease hook (see :func:`run_chunked_campaign`). ``faults`` defaults to
    the environment's chaos plan (:func:`repro_torch.core.faults.active_plan`).
    ``device`` is where the wall-clock backend builds and times its
    workloads (the deterministic backends touch no device). A spec with
    ``predictor_model`` set (an active census) installs the predict gate:
    the instances it skips are predicted on the host, the rest measured on
    ``device``.

    On a CUDA device the wall-clock backend draws each chunk's chain
    matrices ahead on host threads while the instances before them are
    built (:func:`repro_torch.expressions.algorithms.drawing_ahead`): the
    same bytes, every draw taken before the chunk's first engine step, and
    no draw thread left when this returns.
    """
    if faults is None:
        faults = active_plan()
    store = ShardStore(root, shard, fsync=spec.fsync, faults=faults).open()
    instances = {i.uid: i for i in spec.shard_instances(shard)}
    rebuild = start_chunk = None
    drawing: ContextManager = contextlib.nullcontext()
    if spec.backend == "wall_clock":
        from repro_torch.expressions.algorithms import drawing_ahead

        rebuild = lambda uids: _wall_clock_timers(spec, instances, uids, device)
        start_chunk = lambda uids: _prefetch(instances, uids)
        drawing = drawing_ahead(device)
    predictor = None
    if spec.predictor_model:
        # lazy: repro_torch.predict imports back into this module
        from repro_torch.predict.active import census_gate

        predictor = census_gate(spec, instances)
    timings: Dict[str, float] = {}
    with drawing:
        run_chunked_campaign(
            store,
            list(instances),
            lambda uid: build_sweep_session(spec, instances[uid], device),
            lambda session: record_from_session(session, spec),
            chunk_size=spec.chunk_size,
            save_every=spec.save_every,
            policy=spec.policy,
            rebuild_timers=rebuild,
            max_steps=max_steps,
            progress=progress,
            label=f"shard {shard}",
            heartbeat=heartbeat,
            timings=timings,
            faults=faults,
            predictor=predictor,
            start_chunk=start_chunk,
        )
    if timings:
        store.add_timings(timings)
    return store


# ------------------------------------------------------------ merge/triage ---


def scan_damage(n_shards: int, root: str) -> Dict[int, List[Tuple[int, str]]]:
    """Committed-but-unreadable lines per shard: ``{shard: [(line_no,
    status), ...]}`` for shards with damage. The authoritative full check
    behind merge's refusal and the status damage counts."""
    found: Dict[int, List[Tuple[int, str]]] = {}
    for shard in range(n_shards):
        store = ShardStore(root, shard).open(readonly=True)
        if store.damaged:
            found[shard] = list(store.damaged)
    return found


def merge_shards(spec: SweepSpec, root: str, *, strict: bool = True) -> List[Dict[str, Any]]:
    """All shard records, deduped by uid, in global grid order.

    ``strict`` (the default) refuses to merge a store containing mid-file
    damage: silently skipping undecodable lines would publish a census
    that is missing rows it was told it has. Run fsck, then merge."""
    seen: Dict[str, Dict[str, Any]] = {}
    damaged: Dict[int, int] = {}
    for shard in range(spec.n_shards):
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


def write_merged(spec: SweepSpec, root: str, path: Optional[str] = None) -> str:
    """Write the merged census as one JSONL (atomic), return the path."""
    path = path or os.path.join(root, "merged.jsonl")
    records = merge_shards(spec, root)
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        for r in records:
            fh.write(_record_line(r))
    os.replace(tmp, path)
    return path


def size_bucket(size: int) -> str:
    """Power-of-two size bucket label, e.g. ``[128, 256)`` — delegates to the
    port's one shape-bucketing rule (`repro_torch.configs.shapes.shape_bucket`)
    at one bucket per octave, so report tables and the oracle cache agree."""
    from repro_torch.configs.shapes import shape_bucket

    return shape_bucket(size)


def census_summary(records: Sequence[Mapping[str, Any]]) -> Dict[str, Any]:
    """Anomaly-rate aggregates: overall, by family, by size bucket, and by
    family x size — the numbers behind the paper's Figs. 5-7."""

    def agg(rows: Sequence[Mapping[str, Any]]) -> Dict[str, Any]:
        n = len(rows)
        anom = [r for r in rows if r["is_anomaly"]]
        reasons: Dict[str, int] = {}
        for r in anom:
            reasons[r["reason"]] = reasons.get(r["reason"], 0) + 1
        return {
            "n": n,
            "anomalies": len(anom),
            "rate": (len(anom) / n) if n else 0.0,
            "reasons": reasons,
            "converged": sum(1 for r in rows if r["converged"]),
            "predicted": sum(
                1 for r in rows if r.get("provenance") == "predicted"
            ),
        }

    by_family: Dict[str, Any] = {}
    for fam in sorted({r["family"] for r in records}):
        by_family[fam] = agg([r for r in records if r["family"] == fam])
    by_size: Dict[str, Any] = {}
    for bucket in sorted(
        {size_bucket(r["size"]) for r in records},
        key=lambda b: int(b[1:].split(",")[0]),
    ):
        by_size[bucket] = agg(
            [r for r in records if size_bucket(r["size"]) == bucket]
        )
    by_family_size: Dict[str, Any] = {}
    for fam, fam_agg in by_family.items():
        rows = [r for r in records if r["family"] == fam]
        by_family_size[fam] = {
            bucket: agg([r for r in rows if size_bucket(r["size"]) == bucket])
            for bucket in sorted(
                {size_bucket(r["size"]) for r in rows},
                key=lambda b: int(b[1:].split(",")[0]),
            )
        }
    return {
        "total": agg(list(records)),
        "by_family": by_family,
        "by_size": by_size,
        "by_family_size": by_family_size,
    }


def sweep_progress(spec: SweepSpec, root: str) -> Dict[str, Any]:
    """Completed / total per shard, plus running anomaly tallies per family
    (the ``plan``/``run``/``status`` lines). A long census surfaces its
    anomaly landscape here, before any ``merge`` — the explain subsystem's
    "is there anything to explain yet" probe.

    Counts come from the slim shard manifests (plus a tail-scan of records
    appended since each manifest committed — :func:`shard_counts`), so a
    status poll costs O(shards), not O(records): it no longer re-parses
    every shard JSONL, and the grid is expanded once, not once per shard.
    """
    instances = spec.expand()
    totals = [0] * spec.n_shards
    for inst in instances:
        totals[spec.shard_of(inst)] += 1
    per_shard = []
    total_done = 0
    anomalies = 0
    total_damaged = 0
    total_predicted = 0
    per_family: Dict[str, Dict[str, int]] = {}
    for shard in range(spec.n_shards):
        store = ShardStore(root, shard)
        counts = shard_counts(store)
        shard_anom = 0
        shard_pred = 0
        for fam_name, fam_counts in counts["by_family"].items():
            fam = per_family.setdefault(
                fam_name, {"done": 0, "anomalies": 0, "predicted": 0}
            )
            fam["done"] += fam_counts["done"]
            fam["anomalies"] += fam_counts["anomalies"]
            fam["predicted"] += fam_counts.get("predicted", 0)
            shard_anom += fam_counts["anomalies"]
            shard_pred += fam_counts.get("predicted", 0)
        in_flight = os.path.exists(store.engine_path)
        per_shard.append({
            "shard": shard, "done": counts["done"], "total": totals[shard],
            "anomalies": shard_anom, "predicted": shard_pred,
            "in_flight_chunk": in_flight,
            "damaged": counts.get("damaged", 0),
        })
        total_done += counts["done"]
        anomalies += shard_anom
        total_predicted += shard_pred
        total_damaged += counts.get("damaged", 0)
    return {
        "name": spec.name,
        "instances": len(instances),
        "completed": total_done,
        "anomalies": anomalies,
        "damaged": total_damaged,
        "predicted": total_predicted,
        "by_family": per_family,
        "shards": per_shard,
    }
