"""Measurement backends for the ranking methodology.

The paper measures wall-clock execution times of Julia/MKL programs; the
methodology itself is agnostic to *where* the numbers come from. We keep the
measurement layer pluggable:

* :class:`WallClockTimer` — times a callable with ``time.perf_counter``
  (on the GPU the callable ends in ``torch.cuda.synchronize()``; the
  workload builders run each callable once before timing "to exclude
  library overheads", paper Sec. I step 1 — here cuBLAS handle creation
  and the kernel library's first load).
* :class:`SimulatedTimer` — draws from controlled distributions. Used by the
  benchmarks to reproduce the paper's turbo-boost study: a *bimodal* profile
  models a processor alternating between frequency levels (paper Fig. 6).
* :class:`CostModelTimer` — deterministic time from a roofline/HLO cost model
  plus configurable noise; extends the methodology to compile-time variant
  selection where no hardware exists (dry-run scale).

All timers return seconds.
"""

from __future__ import annotations

import dataclasses
import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np

from ..spans import span


def rng_state(rng: np.random.Generator) -> Dict[str, Any]:
    """JSON-serializable state of a numpy Generator (exact-resume support)."""
    return rng.bit_generator.state


def rng_from_state(state: Mapping[str, Any]) -> np.random.Generator:
    rng = np.random.default_rng(0)
    rng.bit_generator.state = dict(state)
    return rng


class MeasurementStore:
    """Accumulates measurements per algorithm (the growing ``t_i`` sets).

    Columnar: each algorithm's measurements live in a growing ``float64``
    numpy buffer (amortized-doubling append), so the analysis layer
    (:class:`repro_torch.core.comparison.QuantileTable`) can hand whole rows to one
    batched ``np.percentile`` call instead of re-materialising Python lists
    per pairwise comparison. A monotonically increasing :attr:`version`
    counter bumps on every mutation; quantile caches key on it.

    The public value types are unchanged — :meth:`get` / :meth:`as_mapping` /
    :meth:`to_dict` still speak ``List[float]`` (the same IEEE doubles, so
    serialized campaign state is byte-identical to the pre-columnar store).
    """

    def __init__(self) -> None:
        self._buf: Dict[str, np.ndarray] = {}
        self._len: Dict[str, int] = {}
        self._version = 0

    @property
    def version(self) -> int:
        """Mutation counter — bumps on add/shuffle; cache-invalidation key."""
        return self._version

    def add(self, name: str, values: Sequence[float]) -> None:
        vals = np.asarray([float(v) for v in values], dtype=np.float64)
        if name not in self._buf:
            self._buf[name] = np.empty(max(8, vals.size), dtype=np.float64)
            self._len[name] = 0
        n, buf = self._len[name], self._buf[name]
        if n + vals.size > buf.size:
            grown = np.empty(max(buf.size * 2, n + vals.size), dtype=np.float64)
            grown[:n] = buf[:n]
            self._buf[name] = buf = grown
        buf[n : n + vals.size] = vals
        self._len[name] = n + vals.size
        self._version += 1

    def row(self, name: str) -> np.ndarray:
        """Read-only view of an algorithm's measurements (no copy).

        Read-only is enforced: writes must go through :meth:`add` /
        :meth:`shuffle` so the version counter keeps quantile caches honest.
        """
        view = self._buf[name][: self._len[name]]
        view.setflags(write=False)
        return view

    def count(self, name: str) -> int:
        return self._len.get(name, 0)

    def names(self) -> List[str]:
        return list(self._buf)

    def get(self, name: str) -> List[float]:
        if name not in self._buf:
            return []
        return self.row(name).tolist()

    def counts(self) -> Dict[str, int]:
        return dict(self._len)

    def min_count(self) -> int:
        if not self._len:
            return 0
        return min(self._len.values())

    def shuffle(self, rng: np.random.Generator) -> None:
        """Shuffle each algorithm's measurements in place.

        The paper shuffles measurements before every mean-rank computation so
        that frequency-mode clusters mix fairly across algorithms
        (Sec. IV, "Effect of Turbo boost"). Quantiles are order-independent,
        but downstream consumers that subsample rely on this.

        Vectorized: one ``rng.permutation`` per row applied by fancy
        indexing — the RNG call sequence (and therefore every resumed
        campaign) is identical to the historical per-element reorder.
        """
        for name, buf in self._buf.items():
            row = buf[: self._len[name]]
            perm = rng.permutation(len(row))
            row[:] = row[perm]
        self._version += 1

    def as_mapping(self) -> Mapping[str, List[float]]:
        """Legacy list-of-floats view (built on demand; the fast path reads
        :meth:`rows` / :meth:`row` instead)."""
        return {name: self.row(name).tolist() for name in self._buf}

    def __contains__(self, name: str) -> bool:
        return name in self._buf

    def to_dict(self) -> Dict[str, Any]:
        """JSON-serializable snapshot (engine persistence, reanalysis)."""
        return {"measurements": {k: self.row(k).tolist() for k in self._buf}}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "MeasurementStore":
        store = cls()
        for name, values in d["measurements"].items():
            store.add(name, values)
        return store


class Timer:
    """Protocol: measure(name) -> one execution time in seconds."""

    def measure(self, name: str) -> float:  # pragma: no cover - interface
        raise NotImplementedError

    def measure_many(self, name: str, m: int) -> List[float]:
        return [self.measure(name) for _ in range(m)]

    def warmup(self, name: str, reps: int = 1) -> None:
        for _ in range(reps):
            self.measure(name)

    def snapshot(self) -> Any:
        """Opaque rollback token for transactional measurement batches
        (None for stateless backends). Stateful backends (RNG-driven)
        override so an interrupted batch can be undone, keeping persisted
        campaign state consistent for bit-identical resume."""
        return None

    def restore(self, snap: Any) -> None:
        return None


class WallClockTimer(Timer):
    """Times real callables.

    Parameters
    ----------
    workloads:
        name -> zero-arg callable executing the algorithm once. A callable
        that launches CUDA work must end in ``torch.cuda.synchronize()`` —
        the :mod:`repro_torch.expressions.algorithms` and
        :mod:`repro_torch.autotune.variants` builders do this. The first
        measurement of each workload verifies the contract (see below);
        ``check_blocking=False`` opts out.

    A workload that returns while its kernels are still queued on the
    device would silently time the launches instead of the algorithm and
    corrupt the whole campaign. Torch tensors carry no
    ``block_until_ready``, so the timer checks the contract itself: the
    first time each workload is measured in a process that has initialised
    CUDA, it times a ``torch.cuda.synchronize()`` *after* stopping the
    clock. When that post-call synchronise costs as much as the timed call
    itself, the workload is not blocking and the timer refuses to measure
    it (loudly, with the offending name). A process that never initialised
    CUDA has launched nothing on the device, and CPU tensor operations
    return finished.

    Minimum-measurable-time guard: a workload whose single call completes
    in less than ``min_time_s`` (default :data:`MIN_MEASURABLE_S`) would
    measure mostly clock granularity and Python dispatch, not the
    algorithm — exactly the regime of small-shape kernel segments. Each
    workload is calibrated on its first measurement: if one call is under
    the floor, subsequent samples time an inner loop of ``r`` calls and
    report the mean per-call time, with ``r`` chosen so the timed region
    clears the floor (capped at :data:`MAX_INNER_REPEATS`). The chosen
    counts are surfaced via :attr:`inner_repeats` so records can carry
    them. ``min_time_s=0`` disables the guard (every ``r`` is 1).
    """

    #: Post-call synchronise must exceed BOTH the timed call and this floor
    #: (seconds) before a sample counts as suspicious — an idle device's
    #: ``torch.cuda.synchronize()`` returns in microseconds, so honest
    #: workloads sit orders of magnitude below the floor.
    NONBLOCKING_FLOOR_S = 1e-4
    #: A workload is rejected only after this many *consecutive* suspicious
    #: samples: a single scheduler/GC stall inside an honest workload's
    #: post-call block must not abort a whole campaign, while a genuinely
    #: async workload is suspicious every time.
    NONBLOCKING_ATTEMPTS = 3
    #: Default minimum timed-region length (seconds): ~1000x the perf
    #: counter's resolution and comfortably above a single Python-call
    #: dispatch, so sub-floor workloads get inner-repeated.
    MIN_MEASURABLE_S = 1e-4
    #: Inner-repeat ceiling — bounds the cost of measuring a pathologically
    #: fast (or mis-calibrated) workload.
    MAX_INNER_REPEATS = 1024

    def __init__(
        self,
        workloads: Mapping[str, Callable[[], object]],
        check_blocking: bool = True,
        min_time_s: Optional[float] = None,
    ):
        self._workloads = dict(workloads)
        self._check_blocking = check_blocking
        self._blocking_checked: set = set()
        self._min_time_s = (
            self.MIN_MEASURABLE_S if min_time_s is None else float(min_time_s)
        )
        self._inner_repeats: Dict[str, int] = {}

    @property
    def inner_repeats(self) -> Dict[str, int]:
        """Calibrated inner-repeat count per workload measured so far (1 =
        the workload clears the floor in a single call)."""
        return dict(self._inner_repeats)

    def _checked_first_measure(self, name: str, fn: Callable[[], object]) -> float:
        import torch

        for attempt in range(self.NONBLOCKING_ATTEMPTS):
            t0 = time.perf_counter()
            fn()
            t_call = time.perf_counter() - t0
            if not torch.cuda.is_initialized():
                return t_call
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t_block = time.perf_counter() - t1
            if t_block <= t_call or t_block <= self.NONBLOCKING_FLOOR_S:
                return t_call  # synchronised internally; device was idle
        raise RuntimeError(
            f"workload {name!r} is not blocking: across "
            f"{self.NONBLOCKING_ATTEMPTS} samples the call returned "
            f"(last: {t_call*1e6:.0f}us) before its device work finished "
            f"(post-call torch.cuda.synchronize() took {t_block*1e6:.0f}us) "
            "— end the workload with torch.cuda.synchronize() before "
            "WallClockTimer measures it"
        )

    def measure(self, name: str) -> float:
        return self.measure_many(name, 1)[0]

    def _calibrate(self, name: str, fn: Callable[[], object]) -> int:
        """First-touch calibration: one timed call (doubling as the
        blocking-contract check) decides the inner-repeat count. The
        calibration sample is discarded — a sub-floor single-call sample
        must not be mixed in with the mean-of-``r`` samples it mandates."""
        if self._check_blocking and name not in self._blocking_checked:
            self._blocking_checked.add(name)
            t = self._checked_first_measure(name, fn)
        else:
            t0 = time.perf_counter()
            fn()
            t = time.perf_counter() - t0
        r = 1
        if self._min_time_s > 0.0 and t < self._min_time_s:
            r = min(self.MAX_INNER_REPEATS,
                    max(1, math.ceil(self._min_time_s / max(t, 1e-9))))
        self._inner_repeats[name] = int(r)
        return int(r)

    def measure_many(self, name: str, m: int) -> List[float]:
        """Batched sampling: one workload lookup (and one calibration /
        blocking-contract check, ever) per workload — the per-sample loop
        is just clock/call/clock, or clock/r-calls/clock divided by ``r``
        for workloads under the minimum-measurable floor. The whole batch,
        calibration included, is the span ``rt.measure``; no sample's clock
        holds any part of it."""
        fn = self._workloads[name]
        out: List[float] = []
        if m <= 0:
            return out
        with span("rt.measure"):
            r = self._inner_repeats.get(name)
            if r is None:
                r = self._calibrate(name, fn)
            perf = time.perf_counter
            if r == 1:
                while len(out) < m:
                    t0 = perf()
                    fn()
                    out.append(perf() - t0)
                return out
            while len(out) < m:
                t0 = perf()
                for _ in range(r):
                    fn()
                out.append((perf() - t0) / r)
        return out


@dataclass
class NoiseProfile:
    """Distribution spec for :class:`SimulatedTimer`.

    ``base`` is the true cost. ``rel_sigma`` scales lognormal noise.
    ``bimodal_shift``/``bimodal_prob`` model a slow frequency mode: with
    probability ``bimodal_prob`` the sample is multiplied by
    ``1 + bimodal_shift`` (paper Fig. 6: two clusters at the distribution
    ends).
    """

    base: float
    rel_sigma: float = 0.02
    bimodal_shift: float = 0.0
    bimodal_prob: float = 0.0
    outlier_prob: float = 0.0
    outlier_scale: float = 3.0


class SimulatedTimer(Timer):
    """Samples are drawn in vectorized batches: :meth:`measure_many` makes
    one RNG call per distribution component (``m`` lognormal factors, then
    ``m`` bimodal coin flips, then ``m`` outlier coin flips) instead of
    interleaving three scalar draws per sample. For a given RNG state a
    batch of ``m`` is one transaction — ``snapshot()``/``restore()`` around
    it keeps interrupted campaigns bit-identical on resume. A pure-lognormal
    profile consumes exactly the stream the historical scalar loop did;
    bimodal/outlier profiles consume the same *number* of draws in batched
    order."""

    def __init__(
        self,
        profiles: Mapping[str, NoiseProfile],
        seed: int = 0,
    ) -> None:
        self._profiles = dict(profiles)
        self._rng = np.random.default_rng(seed)

    def measure(self, name: str) -> float:
        return self.measure_many(name, 1)[0]

    def measure_many(self, name: str, m: int) -> List[float]:
        p = self._profiles[name]
        t = p.base * np.exp(self._rng.normal(0.0, p.rel_sigma, m))
        if p.bimodal_prob > 0.0:
            mask = self._rng.random(m) < p.bimodal_prob
            t = np.where(mask, t * (1.0 + p.bimodal_shift), t)
        if p.outlier_prob > 0.0:
            mask = self._rng.random(m) < p.outlier_prob
            t = np.where(mask, t * p.outlier_scale, t)
        return t.tolist()

    def snapshot(self) -> Any:
        return rng_state(self._rng)

    def restore(self, snap: Any) -> None:
        self._rng = rng_from_state(snap)


class CostModelTimer(Timer):
    """Deterministic cost-model times with optional measurement noise.

    ``costs`` maps algorithm name -> predicted seconds (e.g. a roofline
    estimate from the compiled dry-run). With ``rel_sigma == 0`` comparisons
    degenerate to exact ordering, which is the correct semantics for a
    deterministic model: the three-way comparison then declares equivalence
    only for exactly equal predictions.
    """

    def __init__(
        self,
        costs: Mapping[str, float],
        rel_sigma: float = 0.0,
        seed: int = 0,
    ) -> None:
        self._costs = dict(costs)
        self._rel_sigma = rel_sigma
        self._rng = np.random.default_rng(seed)

    def measure(self, name: str) -> float:
        return self.measure_many(name, 1)[0]

    def measure_many(self, name: str, m: int) -> List[float]:
        """One batched RNG draw for the whole sample block (the noiseless
        model touches no RNG at all, exactly like the scalar path)."""
        t = float(self._costs[name])
        if self._rel_sigma > 0.0:
            return (t * np.exp(self._rng.normal(0.0, self._rel_sigma, m))).tolist()
        return [t] * m

    def snapshot(self) -> Any:
        return rng_state(self._rng)

    def restore(self, snap: Any) -> None:
        self._rng = rng_from_state(snap)


class DetachedTimer(Timer):
    """Placeholder for sessions restored without a measurement backend
    (e.g. a wall-clock campaign loaded on another host). Ranking existing
    data works; any attempt to *measure* fails loudly."""

    def __init__(self, names: Sequence[str] = ()) -> None:
        self.names = tuple(names)

    def measure(self, name: str) -> float:
        raise RuntimeError(
            "session has no measurement backend attached; rebuild the "
            "workloads and pass timers=/workloads= to ExperimentEngine.load "
            "(or call session.attach_timer)"
        )


def timer_to_dict(timer: Timer) -> Dict[str, Any]:
    """Serialize a timer. Simulated and cost-model backends round-trip
    exactly (RNG state included), which is what makes kill/resume campaigns
    bit-identical to uninterrupted runs. Wall-clock backends record their
    workload names only — the callables must be re-attached on load."""
    if isinstance(timer, SimulatedTimer):
        return {
            "kind": "simulated",
            "profiles": {
                name: dataclasses.asdict(p) for name, p in timer._profiles.items()
            },
            "rng_state": rng_state(timer._rng),
        }
    if isinstance(timer, CostModelTimer):
        return {
            "kind": "cost_model",
            "costs": dict(timer._costs),
            "rel_sigma": timer._rel_sigma,
            "rng_state": rng_state(timer._rng),
        }
    if isinstance(timer, WallClockTimer):
        return {"kind": "wall_clock", "workloads": sorted(timer._workloads)}
    return {"kind": "opaque", "type": type(timer).__name__}


def timer_from_dict(
    d: Mapping[str, Any], workloads: Optional[Mapping[str, Callable[[], object]]] = None
) -> Timer:
    """Inverse of :func:`timer_to_dict`. ``workloads`` re-attaches callables
    for wall-clock backends; without it a :class:`DetachedTimer` is returned
    so ranking-as-is still works."""
    kind = d.get("kind", "opaque")
    if kind == "simulated":
        timer = SimulatedTimer(
            {name: NoiseProfile(**p) for name, p in d["profiles"].items()}
        )
        timer._rng = rng_from_state(d["rng_state"])
        return timer
    if kind == "cost_model":
        timer = CostModelTimer(d["costs"], rel_sigma=float(d["rel_sigma"]))
        timer._rng = rng_from_state(d["rng_state"])
        return timer
    if kind == "wall_clock":
        names = d.get("workloads", ())
        if workloads is not None:
            missing = [n for n in names if n not in workloads]
            if missing:
                raise ValueError(f"workloads missing for {missing}")
            return WallClockTimer(workloads)
        return DetachedTimer(names)
    if workloads is not None:
        return WallClockTimer(workloads)
    return DetachedTimer()
