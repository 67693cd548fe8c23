"""Active-census gating: predict an instance's ranking, estimate how
likely the prediction is to flip, and skip measurement when it will not.

The acceptance logic mirrors the census end to end: predicted times go
through the same RT candidate filter, the same rank-class collapse idea
(times within :data:`PREDICT_REL_TOL` share a class), and the same
FLOPs-discriminant anomaly rule — so a ``predicted``-provenance record is
schema-compatible with a measured one and flows through merge, report,
explain targeting, and oracle warming unchanged.

Flip probability: the trained model's residual sigma is the log10-scale
spread the features cannot explain (the synthetic machine's per-algorithm
efficiency factors; on real machines, cache/instruction-order effects).
For each adjacent pair in the predicted time order the chance the TRUE
pair ordering disagrees with the predicted rank relation is a Gaussian
tail of the predicted gap against ``sigma * sqrt(2)``; the instance's
``flip_prob`` is the worst pair, and ``confidence = 1 - flip_prob``.
Equal-FLOPs algorithms whose predicted times coincide therefore get HIGH
flip probability (the census may well split them) and stay measured —
exactly the instances the paper's anomalies live in — while instances
separated by large FLOP gaps are skipped.

Everything is a pure function of ``(SweepSpec, model JSON, instance)``:
an active census emits byte-identical predicted records across SIGKILL
and resume, same as measured ones.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core.scores import filter_candidates, min_flops_set, relative_flops
from repro_torch.explain.decompose import kernels_from_compact

from .features import census_machine, instance_features
from .model import ModelDrift, RidgeModel

#: relative tolerance for collapsing predicted times into one rank class
#: (the model has no measurement noise to separate them) — matches the
#: serving oracle's analytic fallback
PREDICT_REL_TOL = 0.02

#: provenance marker on census records emitted without measurement
PROVENANCE_PREDICTED = "predicted"


def _phi(x: float) -> float:
    """Standard normal CDF."""
    return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))


def rank_classes(times: Mapping[str, float], rel_tol: float = PREDICT_REL_TOL) -> Dict[str, int]:
    """Collapse times into 1-based rank classes: walking the sorted order,
    a new class opens when a time exceeds the class base by ``rel_tol``."""
    order = sorted(times, key=lambda a: (times[a], a))
    ranks: Dict[str, int] = {}
    rank, base = 0, None
    for alg in order:
        if base is None or times[alg] > base * (1.0 + rel_tol):
            rank += 1
            base = times[alg]
        ranks[alg] = rank
    return ranks


def pair_risks(
    times: Mapping[str, float],
    ranks: Mapping[str, int],
    sigma: float,
    rel_tol: float = PREDICT_REL_TOL,
) -> List[float]:
    """Per-adjacent-pair probability that the TRUE ranking relation
    disagrees with the predicted one. For a pair predicted in distinct
    classes the risk is that the true gap collapses or flips; for a pair
    predicted in the SAME class the risk is that the true times split —
    the anomaly-bearing case the census exists to catch."""
    order = sorted(times, key=lambda a: (times[a], a))
    thr = math.log10(1.0 + rel_tol)
    s = max(sigma, 1e-12) * math.sqrt(2.0)
    risks: List[float] = []
    for a, b in zip(order, order[1:]):
        gap = math.log10(times[b]) - math.log10(times[a])
        if ranks[a] == ranks[b]:
            # predicted tied: wrong if the true gap escapes [-thr, thr]
            inside = _phi((thr - gap) / s) - _phi((-thr - gap) / s)
            risks.append(max(0.0, min(1.0, 1.0 - inside)))
        else:
            # predicted split: wrong if the true gap falls back within thr
            risks.append(max(0.0, min(1.0, _phi((thr - gap) / s))))
    return risks


@dataclass(frozen=True)
class PredictedRanking:
    """One instance's model-predicted verdict (pre-gate)."""

    uid: str
    times: Dict[str, float]          #: predicted seconds per kept algorithm
    ranks: Dict[str, int]            #: 1-based rank classes over kept algs
    dropped: Tuple[str, ...]         #: RT-filtered (on predicted times)
    flip_prob: float                 #: worst adjacent-pair risk
    confidence: float                #: 1 - flip_prob
    is_anomaly: bool
    reason: str
    min_flops_algs: Tuple[str, ...]
    best_rank_in_sf: int
    best_rank_overall: int


class ActivePredictor:
    """A trained model bound to one census spec: per-instance predictions,
    the confidence gate, and ``predicted``-provenance records.

    Refuses (loudly, :class:`~repro_torch.predict.model.ModelDrift`) to gate a
    census whose machine label differs from the one the model was trained
    against — cross-machine predictions are what the replay item is for,
    not the active gate."""

    def __init__(
        self,
        model: RidgeModel,
        spec: Any,
        threshold: Optional[float] = None,
        machine: str = "",
    ) -> None:
        name, mspec = census_machine(spec, machine)
        if model.machine != name:
            raise ModelDrift(
                f"model was trained against machine {model.machine!r} but "
                f"this census resolves to {name!r} — retrain (or pass the "
                "matching --machine)"
            )
        self.model = model
        self.spec = spec
        self.machine_name = name
        self.machine = mspec
        if threshold is None:
            threshold = float(getattr(spec, "predict_threshold", 0.95))
        if not 0.0 <= threshold <= 1.0:
            raise ValueError("threshold must be in [0, 1]")
        self.threshold = threshold

    @classmethod
    def open(
        cls,
        path: str,
        spec: Any,
        threshold: Optional[float] = None,
        machine: str = "",
    ) -> "ActivePredictor":
        return cls(RidgeModel.load(path), spec, threshold, machine)

    # ------------------------------------------------------- prediction ---

    def _entry(self, inst: Any) -> Tuple[Dict[str, float], Dict[str, Any]]:
        from repro_torch.core.sweep import instance_entry

        flops, desc, _ = instance_entry(inst)
        return {k: float(v) for k, v in flops.items()}, desc

    def predict(self, inst: Any) -> PredictedRanking:
        """The model's verdict for one instance — same pipeline shape as a
        measured session: predict times, RT-filter candidates, collapse
        rank classes, run the FLOPs-discriminant rule."""
        flops, desc = self._entry(inst)
        vecs = instance_features(
            kernels_from_compact(desc["kernels"]), self.machine,
            self.spec.dispatch_s,
        )
        all_times = self.model.predict_times(vecs)
        cand = filter_candidates(
            flops, all_times,
            rt_threshold=self.spec.rt_threshold,
            flops_rel_tol=self.spec.flops_rel_tol,
        )
        times = {a: all_times[a] for a in cand.names}
        ranks = rank_classes(times)
        risks = pair_risks(times, ranks, self.model.residual_sigma)
        flip = max(risks, default=0.0)
        sf = tuple(
            n for n in min_flops_set(flops, rel_tol=self.spec.flops_rel_tol)
            if n in ranks
        )
        best_overall = min(ranks.values())
        best_in_sf = min(ranks[n] for n in sf) if sf else best_overall
        sf_ranks = {ranks[n] for n in sf}
        if best_in_sf > best_overall:
            is_anomaly, reason = True, "faster_outside_min_flops"
        elif len(sf_ranks) > 1:
            is_anomaly, reason = True, "min_flops_split"
        else:
            is_anomaly, reason = False, "none"
        return PredictedRanking(
            uid=inst.uid,
            times=times,
            ranks=ranks,
            dropped=tuple(cand.dropped),
            flip_prob=flip,
            confidence=1.0 - flip,
            is_anomaly=is_anomaly,
            reason=reason,
            min_flops_algs=sf,
            best_rank_in_sf=best_in_sf,
            best_rank_overall=best_overall,
        )

    def record(self, inst: Any, pred: Optional[PredictedRanking] = None) -> Dict[str, Any]:
        """A census-schema record for a predicted instance. Same fields as
        :func:`repro_torch.core.sweep.record_from_session` plus ``provenance``
        and the prediction metadata — merge/report/explain/oracle consume
        it unchanged, and it is a pure function of (spec, model,
        instance), so resumed active censuses stay byte-identical."""
        if pred is None:
            pred = self.predict(inst)
        flops, desc = self._entry(inst)
        return {
            "uid": inst.uid,
            "index": int(inst.index),
            "family": inst.family,
            "size": desc["size"],
            "dims": desc["dims"],
            "params": dict(inst.params),
            "flops": flops,
            "kernels": desc["kernels"],
            "base_seed": int(self.spec.base_seed),
            "backend": self.spec.backend,
            "p": len(pred.ranks),
            "n_dropped": len(pred.dropped),
            "measurements_per_alg": 0,
            "iterations": 0,
            "converged": True,
            "classes": max(pred.ranks.values()),
            "is_anomaly": bool(pred.is_anomaly),
            "reason": pred.reason,
            "min_flops_algs": list(pred.min_flops_algs),
            "best_rank_in_sf": pred.best_rank_in_sf,
            "best_rank_overall": pred.best_rank_overall,
            "ranks": dict(pred.ranks),
            "mean_ranks": {a: float(r) for a, r in pred.ranks.items()},
            "relative_flops": relative_flops(flops),
            "provenance": PROVENANCE_PREDICTED,
            "predicted": {
                "confidence": round(pred.confidence, 6),
                "flip_prob": round(pred.flip_prob, 6),
                "model_digest": self.model.train_digest[:12],
            },
        }

    def gate(self, inst: Any) -> Optional[Dict[str, Any]]:
        """The campaign gate: a predicted record when the prediction's
        confidence clears the threshold, else ``None`` (measure it)."""
        pred = self.predict(inst)
        if pred.confidence >= self.threshold:
            return self.record(inst, pred)
        return None


def census_gate(spec: Any, instances: Mapping[str, Any]) -> Callable[[str], Optional[Dict[str, Any]]]:
    """The uid-keyed gate :func:`repro_torch.core.sweep.run_shard` installs when
    ``spec.predictor_model`` is set."""
    predictor = ActivePredictor.open(
        spec.predictor_model, spec, threshold=spec.predict_threshold
    )
    return lambda uid: predictor.gate(instances[uid])


def prediction_errors(
    spec: Any,
    records: Sequence[Mapping[str, Any]],
    model: RidgeModel,
    machine: str = "",
) -> List[Dict[str, Any]]:
    """Per-record evaluation rows against a measured census (the
    pred-error report's input): absolute log10-time error per algorithm
    against the reconstructed deterministic ground truth, plus whether
    the predicted winner/anomaly verdict agrees with the census record.
    Wall-clock records score the verdict agreement only (no stored
    times)."""
    from repro_torch.core.family import InstanceSpec
    from repro_torch.core.sweep import synthetic_instance_model

    predictor = ActivePredictor(model, spec, threshold=0.0, machine=machine)
    rows: List[Dict[str, Any]] = []
    for rec in records:
        inst = InstanceSpec(
            index=int(rec["index"]), uid=str(rec["uid"]),
            family=str(rec["family"]), params=dict(rec["params"]),
        )
        pred = predictor.predict(inst)
        flops = {k: float(v) for k, v in rec["flops"].items()}
        err: Optional[float] = None
        if rec.get("backend", spec.backend) in ("cost_model", "simulated"):
            kernel_counts = {
                alg: len(ks) for alg, ks in rec.get("kernels", {}).items()
            }
            truth = synthetic_instance_model(
                spec, int(rec["index"]), flops, kernel_counts or None,
                base_seed=rec.get("base_seed"),
            )
            errs = [
                abs(math.log10(pred.times[a]) - math.log10(truth.costs[a]))
                for a in pred.times if a in truth.costs
            ]
            err = sum(errs) / len(errs) if errs else None
        rec_ranks = {a: int(r) for a, r in rec["ranks"].items()}
        best = min(rec_ranks.values())
        rec_winners = {a for a, r in rec_ranks.items() if r == best}
        pred_best = min(pred.ranks.values())
        pred_winners = {a for a, r in pred.ranks.items() if r == pred_best}
        rows.append({
            "uid": rec["uid"],
            "family": rec["family"],
            "size": rec["size"],
            "machine": predictor.machine_name,
            "abs_dlog10_t": err,
            "winner_match": bool(pred_winners & rec_winners),
            "anomaly_match": bool(pred.is_anomaly) == bool(rec["is_anomaly"]),
            "confidence": pred.confidence,
            "flip_prob": pred.flip_prob,
            "skipped": pred.confidence >= float(
                getattr(spec, "predict_threshold", 0.95)
            ),
            "provenance": rec.get("provenance", "measured"),
        })
    return rows
