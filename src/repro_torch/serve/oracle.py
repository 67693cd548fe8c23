"""Ranking-as-a-service: the anomaly-aware algorithm dispatch oracle.

The Linear Algebra Mapping Problem survey shows production systems
(Julia, Armadillo, Linnea) dispatch algorithms on FLOPs alone; this
repo's census knows *when* that heuristic lies and its explainer knows
*why*. The :class:`RankingOracle` closes the loop into a query endpoint:

    oracle = RankingOracle.open("cache_root")
    verdict = oracle.query("gram", {"size": 96, "seed": 0})

answering "which algorithm, how confident, is this instance an anomaly"
for ``(family, params, machine)`` — singly or batched — from a two-tier
cache (:mod:`repro_torch.serve.cache`) warmed out of merged census + explain
stores. Three confidence levels, strongest first:

``measured``
    The census measured THIS instance: the verdict's ranking is
    byte-identical to the census record's, per-rank confidence 1.0, and
    the anomaly verdict carries the explainer's cause when available.
``bucketed``
    The instance's ``(family, shape-bucket, machine)`` entry exists but
    this exact instance was never measured: the verdict aggregates the
    bucket's records — per-algorithm modal rank, vote-share confidence.
``learned_model``
    A cache miss answered by the TRAINED cost model
    (:mod:`repro_torch.predict`, attached via ``OracleCacheSpec.model``):
    predicted times through the census's own candidate filter and
    discriminant rule, with the model's calibrated rank-flip confidence.
    Misses are still enqueued for background measurement.
``model_only``
    A true cache miss with no trained model attached (or a machine the
    model was not trained for): an analytic cost-model fallback (machine
    roofline + per-kernel dispatch) answers immediately, and the miss is
    durably enqueued for background measurement. The hot path NEVER
    blocks on a measurement.

The background side is :class:`OracleQueue` — the cache root registers
its own store kind (``ocache.json``, see :mod:`repro_torch.core.stores`), so
any ordinary ``python -m repro_torch queue work --out CACHE`` host
leases cache shards, measures enqueued misses under the census's own
spec (byte-identical records, deterministic backends), and folds them
into the cache; the next identical query answers ``measured``. A
wall-clock census's misses are measured on the queue's ``device``
(default ``cuda``: the hand kernels on the card; ``cpu``: their plain
versions).

The query path touches no device: family metadata and flops tables come
from the registry without building workloads, so answering queries never
initialises CUDA. Only a queue worker draining wall-clock misses builds
workloads. A copy of the reference's ``repro.serve.oracle``: verdicts and
refreshed cache entries are the reference's byte for byte.
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.configs.shapes import shape_bucket
from repro_torch.core.family import InstanceSpec
from repro_torch.core.sweep import (
    SweepSpec,
    _record_line,
    build_sweep_session,
    instance_entry,
    record_from_session,
)
from repro_torch.roofline.terms import MACHINES, MachineSpec, get_machine, synthetic_machine

from .cache import (
    CONFIDENCE_BUCKETED,
    CONFIDENCE_LEARNED,
    CONFIDENCE_MEASURED,
    CONFIDENCE_MODEL_ONLY,
    SPEC_FILE,
    OracleCache,
    OracleCacheSpec,
    cache_key,
)

#: relative tolerance for collapsing analytic fallback times into one
#: rank class (the model has no measurement noise to separate them)
MODEL_REL_TOL = 0.02


def default_machine_name(spec: OracleCacheSpec, sweep: SweepSpec) -> str:
    """The machine label cache keys embed — the explainer's resolution
    rule: explicit registry pick, else the census's synthetic machine for
    deterministic backends, else the pinned-core host."""
    if spec.machine:
        return spec.machine
    if sweep.backend in ("cost_model", "simulated"):
        return f"sweep:{sweep.name}"
    return "cpu-1core"


def resolve_machine_spec(name: str, sweep: SweepSpec) -> MachineSpec:
    """The MachineSpec behind a machine label: registry entries by name,
    anything else modelled as the census's pure-compute synthetic."""
    if name in MACHINES:
        return get_machine(name)
    return synthetic_machine(name, sweep.flop_rate)


def _params_token(params: Mapping[str, Any]) -> str:
    return json.dumps(dict(params), sort_keys=True, separators=(",", ":"))


# --------------------------------------------------------------- the oracle ---


class RankingOracle:
    """The query endpoint over one cache root. Open once, query many:
    per-process lazy indices (census grid by params, family flops tables)
    make repeated queries pure dict lookups + at most one shard seek."""

    def __init__(self, root: str, cache: OracleCache) -> None:
        self.root = root
        self.cache = cache
        self.spec = cache.spec
        self.census_spec = SweepSpec.load(
            os.path.join(self.spec.census, "spec.json")
        )
        self.machine_name = default_machine_name(self.spec, self.census_spec)
        self._machines: Dict[str, MachineSpec] = {}
        #: (family, params token) -> (InstanceSpec, size)
        self._resolved: Dict[Tuple[str, str], Tuple[InstanceSpec, int]] = {}
        #: (family, params token) -> (flops, kernel counts)
        self._costed: Dict[Tuple[str, str], Tuple[Dict[str, float], Dict[str, int]]] = {}
        self._grid: Optional[Dict[Tuple[str, str], InstanceSpec]] = None
        #: lazily-opened trained predictor (spec.model); None until tried
        self._predictor: Optional[Any] = None
        self._predictor_tried = False

    @classmethod
    def open(cls, root: str) -> "RankingOracle":
        return cls(root, OracleCache.open(root))

    def reload(self) -> None:
        """Re-open the cache (pick up background refreshes)."""
        self.cache = OracleCache.open(self.root)

    # ----------------------------------------------------------- resolution ---

    def _census_grid(self) -> Dict[Tuple[str, str], InstanceSpec]:
        if self._grid is None:
            self._grid = {
                (inst.family, _params_token(inst.params)): inst
                for inst in self.census_spec.expand()
            }
        return self._grid

    def _resolve(self, family: str, params: Mapping[str, Any]) -> Tuple[InstanceSpec, int]:
        """(instance, size) for a query. Census-grid instances keep their
        real uid/index (the ``measured`` fast path and the byte-identity
        guarantee for re-measured misses); ad-hoc queries get a stable
        content-addressed uid outside the grid's index range."""
        token = _params_token(params)
        hit = self._resolved.get((family, token))
        if hit is not None:
            return hit
        inst = self._census_grid().get((family, token))
        if inst is None:
            crc = zlib.crc32(f"{family}:{token}".encode("utf-8")) & 0xFFFFFFFF
            inst = InstanceSpec(
                index=(1 << 32) + crc,
                uid=f"{family}-adhoc-{crc:08x}",
                family=family,
                params=dict(params),
            )
        if "size" in params:
            size = int(params["size"])
        else:
            _, desc, _ = instance_entry(inst)
            size = int(desc["size"])
        self._resolved[(family, token)] = (inst, size)
        return inst, size

    def _cost(self, inst: InstanceSpec) -> Tuple[Dict[str, float], Dict[str, int]]:
        token = (inst.family, _params_token(inst.params))
        hit = self._costed.get(token)
        if hit is None:
            flops, desc, _ = instance_entry(inst)
            hit = (
                {k: float(v) for k, v in flops.items()},
                {alg: len(ks) for alg, ks in desc["kernels"].items()},
            )
            self._costed[token] = hit
        return hit

    def _machine(self, name: str) -> MachineSpec:
        if name not in self._machines:
            self._machines[name] = resolve_machine_spec(name, self.census_spec)
        return self._machines[name]

    # -------------------------------------------------------------- queries ---

    def query(self, family: str, params: Mapping[str, Any], *,
              machine: Optional[str] = None, enqueue: bool = True) -> Dict[str, Any]:
        """One verdict. ``machine`` overrides the cache's default label;
        ``enqueue=False`` suppresses the miss queue (pure lookups)."""
        inst, size = self._resolve(family, params)
        machine_name = machine or self.machine_name
        bucket = shape_bucket(size, self.spec.per_octave)
        key = cache_key(family, bucket, machine_name)
        verdict: Dict[str, Any] = {
            "family": family,
            "params": dict(params),
            "uid": inst.uid,
            "index": inst.index,
            "machine": machine_name,
            "bucket": bucket,
            "key": key,
            "enqueued": False,
        }
        entry = self.cache.get(key)
        if entry is not None and inst.uid in entry.get("sources", {}):
            verdict.update(self._measured_verdict(entry, inst.uid))
        elif entry is not None:
            verdict.update(self._bucketed_verdict(entry))
        else:
            learned = self._learned_verdict(inst, machine_name)
            verdict.update(
                learned if learned is not None
                else self._model_verdict(inst, machine_name)
            )
            if enqueue:
                self.cache.enqueue_miss(
                    uid=inst.uid, index=inst.index, family=family,
                    params=inst.params, machine=machine_name, key=key,
                )
                verdict["enqueued"] = True
        return verdict

    def query_batch(self, queries: Sequence[Mapping[str, Any]], *,
                    machine: Optional[str] = None,
                    enqueue: bool = True) -> List[Dict[str, Any]]:
        """Verdicts for ``[{"family": ..., "params": ...}, ...]`` (each
        query may also carry its own ``machine`` override)."""
        return [
            self.query(
                str(q["family"]), q["params"],
                machine=q.get("machine") or machine, enqueue=enqueue,
            )
            for q in queries
        ]

    # --------------------------------------------------------- the verdicts ---

    @staticmethod
    def _measured_verdict(entry: Mapping[str, Any], uid: str) -> Dict[str, Any]:
        src = entry["sources"][uid]
        ranks = {alg: int(r) for alg, r in src["ranks"].items()}
        mean_ranks = {alg: float(v) for alg, v in src["mean_ranks"].items()}
        order = sorted(ranks, key=lambda a: (mean_ranks.get(a, ranks[a]), a))
        return {
            "confidence": CONFIDENCE_MEASURED,
            "cache_hit": True,
            "is_anomaly": bool(src["is_anomaly"]),
            "reason": src.get("reason", ""),
            "ranking": [
                {"alg": alg, "rank": ranks[alg],
                 "mean_rank": mean_ranks.get(alg, float(ranks[alg])),
                 "confidence": 1.0}
                for alg in order
            ],
            "ranks": ranks,
            "min_flops_algs": list(src.get("min_flops_algs", ())),
            "cause": src.get("cause"),
            "cause_evidence": src.get("cause_evidence"),
            "n_records": 1,
        }

    @staticmethod
    def _bucketed_verdict(entry: Mapping[str, Any]) -> Dict[str, Any]:
        return {
            "confidence": CONFIDENCE_BUCKETED,
            "cache_hit": True,
            "is_anomaly": bool(entry["is_anomaly"]),
            "reason": "",
            "ranking": [dict(r) for r in entry["ranking"]],
            "ranks": dict(entry["ranks"]),
            "min_flops_algs": list(entry["min_flops_algs"]),
            "cause": entry.get("cause"),
            "cause_evidence": entry.get("cause_evidence"),
            "n_records": int(entry["n_records"]),
            "anomaly_rate": float(entry.get("anomaly_rate", 0.0)),
        }

    def _learned(self) -> Optional[Any]:
        """The trained predictor behind ``spec.model``, opened once.
        A drifted/tampered model file raises
        :class:`~repro_torch.predict.model.ModelDrift` on the first miss —
        loudly, instead of silently degrading to the analytic tier."""
        if not self._predictor_tried:
            self._predictor_tried = True
            if self.spec.model:
                from repro_torch.predict.active import ActivePredictor

                self._predictor = ActivePredictor.open(
                    self.spec.model, self.census_spec, threshold=0.0,
                    machine=self.spec.machine,
                )
        return self._predictor

    def _learned_verdict(
        self, inst: InstanceSpec, machine_name: str
    ) -> Optional[Dict[str, Any]]:
        """The trained model's verdict for a miss, or ``None`` when no
        model is attached or the query targets a machine the model was
        not trained against (the analytic tier handles those)."""
        predictor = self._learned()
        if predictor is None or predictor.machine_name != machine_name:
            return None
        pred = predictor.predict(inst)
        order = sorted(pred.ranks, key=lambda a: (pred.ranks[a], a))
        return {
            "confidence": CONFIDENCE_LEARNED,
            "cache_hit": False,
            "is_anomaly": bool(pred.is_anomaly),
            "reason": pred.reason,
            "ranking": [
                {"alg": alg, "rank": pred.ranks[alg],
                 "mean_rank": float(pred.ranks[alg]),
                 "confidence": round(pred.confidence, 6)}
                for alg in order
            ],
            "ranks": dict(pred.ranks),
            "min_flops_algs": list(pred.min_flops_algs),
            "cause": None,
            "cause_evidence": None,
            "n_records": 0,
            "model_confidence": round(pred.confidence, 6),
            "flip_prob": round(pred.flip_prob, 6),
        }

    def _model_verdict(self, inst: InstanceSpec, machine_name: str) -> Dict[str, Any]:
        """The analytic fallback: machine compute time per algorithm plus
        per-kernel dispatch — answered from the family's flops tables, no
        measurement, no device. Rank classes collapse times within
        :data:`MODEL_REL_TOL`; the anomaly rule is the census's (a
        min-FLOPs algorithm outside the best class)."""
        flops, kernel_counts = self._cost(inst)
        machine = self._machine(machine_name)
        dispatch = machine.dispatch_overhead_s + self.census_spec.dispatch_s
        times = {
            alg: machine.t_compute(flops[alg])
            + dispatch * kernel_counts.get(alg, 0)
            for alg in flops
        }
        order = sorted(times, key=lambda a: (times[a], a))
        ranks: Dict[str, int] = {}
        rank, base = 0, None
        for alg in order:
            if base is None or times[alg] > base * (1.0 + MODEL_REL_TOL):
                rank += 1
                base = times[alg]
            ranks[alg] = rank
        fmin = min(flops.values())
        tol = self.census_spec.flops_rel_tol
        min_flops_algs = sorted(
            alg for alg in flops if flops[alg] <= fmin * (1.0 + tol)
        )
        best_in_sf = min(ranks[alg] for alg in min_flops_algs)
        return {
            "confidence": CONFIDENCE_MODEL_ONLY,
            "cache_hit": False,
            "is_anomaly": best_in_sf > min(ranks.values()),
            "reason": "",
            "ranking": [
                {"alg": alg, "rank": ranks[alg],
                 "mean_rank": float(ranks[alg]), "confidence": None}
                for alg in order
            ],
            "ranks": ranks,
            "min_flops_algs": min_flops_algs,
            "cause": None,
            "cause_evidence": None,
            "n_records": 0,
        }


def hit_rate(verdicts: Sequence[Mapping[str, Any]]) -> float:
    """Fraction of verdicts served from the cache itself — strictly
    ``measured``/``bucketed``; a learned-model answer is still a cache
    miss (it will be measured in the background)."""
    if not verdicts:
        return 0.0
    hits = sum(
        1 for v in verdicts
        if v["confidence"] in (CONFIDENCE_MEASURED, CONFIDENCE_BUCKETED)
    )
    return hits / len(verdicts)


# ---------------------------------------------------------------- the queue ---


class OracleQueue:
    """A cache root as a drainable work queue (the third registered store
    kind). ``run_shard`` measures the shard's pending misses under the
    CENSUS's own spec — so for deterministic backends the refreshed entry
    sources are byte-identical to what the census itself would have
    recorded — and folds each into its cache entry. Duck-type and lease
    discipline match :class:`repro_torch.launch.queue.SweepQueue`, so any
    ``queue work`` host (and fsck) handles cache roots unchanged. A
    wall-clock census's misses are measured on ``device``."""

    kind = "oracle"

    def __init__(self, out: str, device: str = "cuda") -> None:
        self.out = out
        self.device = device
        self.spec = OracleCacheSpec.load(os.path.join(out, SPEC_FILE))
        self.n_shards = self.spec.n_shards
        self.cache = OracleCache.open(out)
        self.census_spec = SweepSpec.load(
            os.path.join(self.spec.census, "spec.json")
        )
        self.machine_name = default_machine_name(self.spec, self.census_spec)
        self.backend = self.census_spec.backend

    def shard_totals(self) -> List[int]:
        totals, _ = self.cache.miss_totals()
        return totals

    def run_shard(self, shard: int, *, heartbeat=None, max_steps=None,
                  progress=None) -> None:
        tell = progress or (lambda msg: None)
        steps = 0
        for miss in self.cache.pending(shard):
            inst = InstanceSpec(
                index=int(miss["index"]), uid=str(miss["uid"]),
                family=str(miss["family"]), params=dict(miss["params"]),
            )
            session = build_sweep_session(self.census_spec, inst, self.device)
            while not session.done:
                session.step()
                steps += 1
                if heartbeat is not None:
                    heartbeat()
                if max_steps is not None and steps >= max_steps:
                    # pause mid-miss: nothing committed, the deterministic
                    # session re-measures identically on the next pass
                    tell(f"oracle shard {shard}: paused before {miss['uid']}")
                    return
            if heartbeat is not None:
                heartbeat(True)
            record = record_from_session(session, self.census_spec)
            entry = self.cache.refresh_from_record(
                record, str(miss.get("machine") or self.machine_name)
            )
            tell(
                f"oracle shard {shard}: measured {miss['uid']} -> "
                f"{entry['key']} seq {entry['seq']}"
            )
        self.cache.mark_done(shard)

    def merge(self) -> str:
        """One JSONL of each key's latest entry (atomic)."""
        path = os.path.join(self.out, "merged.jsonl")
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            for key in self.cache.keys():
                entry = self.cache.get(key)
                if entry is not None:
                    fh.write(_record_line(entry))
        os.replace(tmp, path)
        return path

    def progress(self) -> Dict[str, int]:
        totals, pendings = self.cache.miss_totals()
        return {
            "completed": sum(totals) - sum(pendings),
            "total": sum(totals),
        }
