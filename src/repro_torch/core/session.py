"""Resumable measurement sessions — Procedure 4 one step at a time.

The paper's ``MeasureAndRank`` is an *iterative campaign*: add ``M``
measurements per algorithm, recompute mean ranks over the quantile ladder,
stop when the rank landscape stabilises. The original implementation ran
that loop to convergence in one blocking call, which makes it impossible to
interleave many expression instances, persist progress, or resume after a
kill. :class:`MeasurementSession` factors the loop body out:

* ``step()`` — exactly one Procedure-4 iteration (measure, shuffle, mean
  ranks, convergence norm, hypothesis update);
* ``done`` — the loop condition (converged, or measurement budget spent);
* ``result()`` — the final :class:`~repro_torch.core.types.RankingResult`,
  including the warm-start path: a store that already holds >= 1
  measurement per algorithm is ranked as-is instead of re-measured past
  the budget;
* ``to_dict()`` / ``from_dict()`` — full JSON state (store, iteration
  history, convergence state, RNG states) for kill/resume campaigns.

:func:`repro_torch.core.convergence.measure_and_rank` is now a thin driver over a
single session; :class:`repro_torch.core.engine.ExperimentEngine` schedules many
sessions as one campaign.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np

from ..spans import span
from .comparison import QuantileTable
from .meanrank import MeanRankResult, mean_ranks
from .measure import (
    MeasurementStore,
    Timer,
    rng_from_state,
    rng_state,
    timer_from_dict,
    timer_to_dict,
)
from .types import (
    DEFAULT_QUANTILE_RANGES,
    REPORT_QUANTILE_RANGE,
    IterationRecord,
    QuantileRange,
    RankedAlgorithm,
    RankingResult,
)


def first_differences(x: Sequence[float]) -> np.ndarray:
    """``convolution(x, [1, -1], step=1)`` — adjacent mean-rank deltas."""
    arr = np.asarray(x, dtype=np.float64)
    if arr.size < 2:
        return np.zeros(0, dtype=np.float64)
    return arr[1:] - arr[:-1]


def convergence_norm(dx: np.ndarray, dy: np.ndarray, p: int) -> float:
    """``||dx - dy||_2 / p`` (paper's stopping criterion)."""
    if dx.shape != dy.shape:
        raise ValueError(f"dx/dy shape mismatch: {dx.shape} vs {dy.shape}")
    if p <= 0:
        raise ValueError("p must be positive")
    return float(np.linalg.norm(dx - dy) / p)


def _record_to_dict(rec: IterationRecord) -> Dict[str, Any]:
    return {
        "measurements_per_alg": rec.measurements_per_alg,
        "order": list(rec.order),
        "ranks": list(rec.ranks),
        "mean_ranks": list(rec.mean_ranks),
        "norm": rec.norm,
    }


def _record_from_dict(d: Mapping[str, Any]) -> IterationRecord:
    return IterationRecord(
        measurements_per_alg=int(d["measurements_per_alg"]),
        order=tuple(d["order"]),
        ranks=tuple(int(r) for r in d["ranks"]),
        mean_ranks=tuple(float(m) for m in d["mean_ranks"]),
        norm=float(d["norm"]),
    )


class MeasurementSession:
    """One expression instance under the paper's measurement campaign.

    Wraps (algorithms, timer, store) and exposes the Procedure-4 loop body
    as ``step()``. All loop state (current hypothesis ``order``, previous
    differences ``dy``, convergence norm, iteration history) lives on the
    session and serializes to JSON, so a campaign can be killed after any
    iteration and resumed bit-identically (timer RNG state included for
    simulated/cost-model backends).

    Analysis runs vectorized by default: the session holds one
    :class:`~repro_torch.core.comparison.QuantileTable` over its columnar store
    (all ladder bounds + the reporting range, batched into a single
    ``np.percentile`` pass per iteration, invalidated by store version), so
    a whole Procedure-4 step does O(p·R) percentile work instead of
    O(p²·R). ``vectorized=False`` keeps the paper-literal pairwise
    evaluation; both paths produce identical results and identical
    serialized state (golden-equality tested).

    ``meta`` is a JSON-serializable scratch dict for campaign owners (the
    autotuner stores FLOP tables and single-run times there).
    """

    def __init__(
        self,
        name: str,
        initial_order: Sequence[str],
        timer: Timer,
        *,
        m_per_iteration: int = 3,
        eps: float = 0.03,
        max_measurements: int = 30,
        quantile_ranges: Sequence[QuantileRange] = DEFAULT_QUANTILE_RANGES,
        report_range: QuantileRange = REPORT_QUANTILE_RANGE,
        tie_break: str = "class",
        store: Optional[MeasurementStore] = None,
        shuffle_seed: Optional[int] = 0,
        meta: Optional[Dict[str, Any]] = None,
        vectorized: bool = True,
    ) -> None:
        order = list(initial_order)
        if not order:
            raise ValueError("need at least one algorithm")
        self.name = name
        self.initial_order = list(order)
        self.m_per_iteration = m_per_iteration
        self.eps = eps
        self.max_measurements = max_measurements
        self.quantile_ranges = tuple(
            (float(lo), float(hi)) for lo, hi in quantile_ranges
        )
        self.report_range = (float(report_range[0]), float(report_range[1]))
        self.tie_break = tie_break
        self.meta: Dict[str, Any] = dict(meta or {})

        self._timer = timer
        self._order: List[str] = order
        self._p = len(order)
        self._store = store if store is not None else MeasurementStore()
        self._shuffle_seed = shuffle_seed
        self._shuffle_rng = (
            np.random.default_rng(shuffle_seed) if shuffle_seed is not None else None
        )
        self._dy = np.ones(max(self._p - 1, 0), dtype=np.float64)
        self._norm = float("inf")
        self._converged = False
        self._history: List[IterationRecord] = []
        self._fallback: Optional[IterationRecord] = None
        # Analysis fast path: one QuantileTable held across the session's
        # whole lifetime, recomputed lazily when the store version moves.
        # Deliberately NOT serialized — the vectorized and legacy paths
        # produce identical state, so persisted JSON stays byte-equal.
        self._vectorized = vectorized
        self._qtable: Optional[QuantileTable] = None

    # ------------------------------------------------------------ state ---

    @property
    def store(self) -> MeasurementStore:
        return self._store

    @property
    def timer(self) -> Timer:
        return self._timer

    @property
    def order(self) -> List[str]:
        """Current hypothesis ``h`` (updated after every iteration)."""
        return list(self._order)

    @property
    def history(self) -> List[IterationRecord]:
        return list(self._history)

    @property
    def iterations(self) -> int:
        return len(self._history)

    @property
    def converged(self) -> bool:
        return self._converged

    @property
    def norm(self) -> float:
        """Latest convergence norm (``inf`` before the first iteration)."""
        return self._norm

    @property
    def measurements_per_alg(self) -> int:
        return self._store.min_count()

    @property
    def done(self) -> bool:
        """Loop condition of Procedure 4: converged or budget spent."""
        return self._converged or self.measurements_per_alg >= self.max_measurements

    def attach_timer(self, timer: Timer) -> None:
        """Re-attach a measurement backend (after :meth:`from_dict` of a
        session whose timer was not serializable, e.g. wall-clock)."""
        self._timer = timer

    @property
    def vectorized(self) -> bool:
        """True when analysis runs through the batched quantile table."""
        return self._vectorized

    # --------------------------------------------------------- analysis ---

    def _table(self) -> QuantileTable:
        """The session's quantile table: every bound of the ladder plus the
        reporting range, cached across steps, invalidated by store version."""
        if self._qtable is None:
            self._qtable = QuantileTable.from_ranges(
                self._store, (*self.quantile_ranges, self.report_range)
            )
        return self._qtable

    def _mean_ranks(self) -> MeanRankResult:
        """One Procedure-3 pass over the current store.

        The vectorized path (default) flows the batched quantile table
        through every Procedure-2 sort of the ladder; ``vectorized=False``
        reproduces the historical pairwise evaluation (unmemoized, one
        ``np.percentile`` pair per comparison) bit-for-bit — the golden
        tests hold the two paths equal.
        """
        if self._vectorized:
            return mean_ranks(
                self._order,
                None,
                quantile_ranges=self.quantile_ranges,
                report_range=self.report_range,
                tie_break=self.tie_break,
                table=self._table(),
            )
        return mean_ranks(
            self._order,
            self._store.as_mapping(),
            quantile_ranges=self.quantile_ranges,
            report_range=self.report_range,
            tie_break=self.tie_break,
            memoize=False,
        )

    # ------------------------------------------------------------- loop ---

    def step(self) -> Optional[IterationRecord]:
        """One Procedure-4 iteration; returns its record, or None if done.

        The measurement phase is transactional: the batch is buffered and
        the timer's RNG snapshot restored if it is interrupted, so a save
        taken after the exception persists a whole-iteration boundary and
        resume stays bit-identical to an uninterrupted run.

        The iteration is the span ``rt.rank.step``; its host work after the
        batch, the span ``rt.rank.update``.
        """
        if self.done:
            return None
        with span("rt.rank.step"):
            snap = self._timer.snapshot()
            try:
                batch = [
                    (name, self._timer.measure_many(name, self.m_per_iteration))
                    for name in self._order
                ]
            except BaseException:
                self._timer.restore(snap)
                raise
            with span("rt.rank.update"):
                for name, values in batch:
                    self._store.add(name, values)
                n = self._store.min_count()
                if self._shuffle_rng is not None:
                    self._store.shuffle(self._shuffle_rng)

                mr = self._mean_ranks()
                x = np.asarray(mr.ordered_mean_ranks(), dtype=np.float64)
                dx = first_differences(x)
                self._norm = convergence_norm(dx, self._dy, self._p)
                self._dy = dx
                self._order = list(mr.order)  # h <- ordering from the report range

                rec = IterationRecord(
                    measurements_per_alg=n,
                    order=tuple(mr.order),
                    ranks=tuple(mr.ranks),
                    mean_ranks=tuple(mr.mean_ranks[name] for name in mr.order),
                    norm=self._norm,
                )
                self._history.append(rec)
                if self._norm < self.eps:
                    self._converged = True
        return rec

    def run_to_convergence(self) -> RankingResult:
        """Blocking drive — the original ``measure_and_rank`` semantics."""
        while not self.done:
            self.step()
        return self.result()

    # ----------------------------------------------------------- result ---

    def _rank_existing_or_measure_once(self) -> IterationRecord:
        """Zero-iteration fallback. A warm-started store that already holds
        >= 1 measurement per algorithm is ranked as-is (no measurement past
        the budget); only algorithms with NO data get one batch."""
        missing = [n for n in self._order if len(self._store.get(n)) == 0]
        for name in missing:
            self._store.add(
                name, self._timer.measure_many(name, max(1, self.m_per_iteration))
            )
        with span("rt.rank.update"):
            mr = self._mean_ranks()
            rec = IterationRecord(
                measurements_per_alg=self._store.min_count(),
                order=tuple(mr.order),
                ranks=tuple(mr.ranks),
                mean_ranks=tuple(mr.mean_ranks[name] for name in mr.order),
                norm=self._norm,
            )
            self._fallback = rec
        return rec

    def can_rank(self) -> bool:
        """True if a ranking exists without taking any new measurement."""
        return (
            bool(self._history)
            or self._fallback is not None
            or all(len(self._store.get(n)) > 0 for n in self._order)
        )

    def result(self, measure_if_needed: bool = True) -> RankingResult:
        """Ranking from the latest completed iteration (or the warm-start /
        measure-once fallback when no iteration ever ran).

        With ``measure_if_needed=False`` the call is guaranteed side-effect
        free: it raises instead of measuring when a never-stepped session
        has algorithms without data (schedulers use this so that reading
        intermediate results never perturbs a resumable campaign).
        """
        if self._history:
            rec = self._history[-1]
        elif self._fallback is not None:
            rec = self._fallback
        else:
            if not measure_if_needed and not self.can_rank():
                raise RuntimeError(
                    f"session {self.name!r} has no measurements to rank yet"
                )
            rec = self._rank_existing_or_measure_once()
        sequence = [
            RankedAlgorithm(name=name, rank=rank, mean_rank=m)
            for name, rank, m in zip(rec.order, rec.ranks, rec.mean_ranks)
        ]
        return RankingResult(
            sequence=sequence,
            mean_ranks=dict(zip(rec.order, rec.mean_ranks)),
            measurements_per_alg=self._store.min_count(),
            converged=self._converged,
            history=list(self._history),
        )

    # -------------------------------------------------------- persistence ---

    def to_dict(self, include_timer: bool = True) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "version": 1,
            "name": self.name,
            "initial_order": list(self.initial_order),
            "order": list(self._order),
            "m_per_iteration": self.m_per_iteration,
            "eps": self.eps,
            "max_measurements": self.max_measurements,
            "quantile_ranges": [list(q) for q in self.quantile_ranges],
            "report_range": list(self.report_range),
            "tie_break": self.tie_break,
            "store": self._store.to_dict(),
            "dy": [float(v) for v in self._dy],
            "norm": None if math.isinf(self._norm) else self._norm,
            "converged": self._converged,
            "history": [_record_to_dict(r) for r in self._history],
            "shuffle_seed": self._shuffle_seed,
            "shuffle_rng_state": (
                rng_state(self._shuffle_rng) if self._shuffle_rng is not None else None
            ),
            "meta": self.meta,
        }
        if include_timer:
            d["timer"] = timer_to_dict(self._timer)
        return d

    @classmethod
    def from_dict(
        cls,
        d: Mapping[str, Any],
        timer: Optional[Timer] = None,
        workloads: Optional[Mapping[str, Any]] = None,
        vectorized: bool = True,
    ) -> "MeasurementSession":
        """Rebuild a session. ``timer`` overrides the serialized backend;
        wall-clock backends need ``workloads`` (or a later
        :meth:`attach_timer`) before the next ``step()``. ``vectorized`` is
        an analysis-path choice of the *process*, not campaign state — it is
        never serialized, and either setting resumes any saved session
        bit-identically."""
        if timer is None:
            timer = timer_from_dict(d.get("timer") or {"kind": "opaque"}, workloads)
        session = cls(
            d["name"],
            d["initial_order"],
            timer,
            vectorized=vectorized,
            m_per_iteration=int(d["m_per_iteration"]),
            eps=float(d["eps"]),
            max_measurements=int(d["max_measurements"]),
            quantile_ranges=[tuple(q) for q in d["quantile_ranges"]],
            report_range=tuple(d["report_range"]),
            tie_break=d["tie_break"],
            store=MeasurementStore.from_dict(d["store"]),
            shuffle_seed=d.get("shuffle_seed"),
            meta=d.get("meta"),
        )
        session._order = list(d["order"])
        session._dy = np.asarray(d["dy"], dtype=np.float64)
        session._norm = float("inf") if d["norm"] is None else float(d["norm"])
        session._converged = bool(d["converged"])
        session._history = [_record_from_dict(r) for r in d["history"]]
        state = d.get("shuffle_rng_state")
        if state is not None:
            session._shuffle_rng = rng_from_state(state)
        return session
