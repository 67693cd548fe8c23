"""Three-way algorithm comparison (paper Procedure 1, ``CompareAlgs``).

Two sets of time measurements are compared through a quantile range
``(q_lower, q_upper)``:

* ``alg_i`` is *better* than ``alg_j``   iff  ``Q_hi(t_i) < Q_lo(t_j)``
* ``alg_i`` is *worse*  than ``alg_j``   iff  ``Q_hi(t_j) < Q_lo(t_i)``
* otherwise the two are *equivalent* — their measurement distributions
  overlap inside the chosen quantile window.

The comparison is distribution-free: no normality or unimodality assumption
is made, which is what lets the same machinery handle multi-modal
(turbo-boost) measurement profiles (paper Sec. IV).

Two evaluation paths share these semantics:

* :func:`compare_measurements` — the paper-literal pairwise form; computes
  both quantile windows from raw measurement vectors on every call.
* :class:`QuantileTable` — the vectorized form; computes **all**
  (algorithm × quantile-bound) percentiles of a columnar
  :class:`~repro_torch.core.measure.MeasurementStore` in one batched
  ``np.percentile`` call per row-length group, caches them keyed on the
  store's version counter, and answers each three-way comparison from two
  float reads. ``np.percentile`` applies the identical interpolation
  arithmetic per (row, q) whether called scalar or batched, so the table is
  bit-identical to the pairwise path (enforced by the golden-equality
  tests).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .types import Outcome, QuantileRange

if TYPE_CHECKING:  # pragma: no cover - typing only
    from .measure import MeasurementStore


def quantile_window(t: Sequence[float], q_lower: float, q_upper: float) -> tuple:
    """Return ``(Q_lo, Q_hi)`` of measurement vector ``t``.

    Uses linear interpolation between order statistics (NumPy default), which
    is well-defined down to N == 1 (both quantiles collapse to the value).
    """
    arr = np.asarray(t, dtype=np.float64)
    if arr.size == 0:
        raise ValueError("cannot compare an algorithm with zero measurements")
    lo = float(np.percentile(arr, q_lower))
    hi = float(np.percentile(arr, q_upper))
    return lo, hi


def compare_measurements(
    t_i: Sequence[float],
    t_j: Sequence[float],
    q_lower: float,
    q_upper: float,
) -> Outcome:
    """Procedure 1: three-way comparison of two measurement sets."""
    _validate_range(q_lower, q_upper)
    i_lo, i_hi = quantile_window(t_i, q_lower, q_upper)
    j_lo, j_hi = quantile_window(t_j, q_lower, q_upper)
    if i_hi < j_lo:
        return Outcome.BETTER
    if j_hi < i_lo:
        return Outcome.WORSE
    return Outcome.EQUIVALENT


def compare_range(
    t_i: Sequence[float],
    t_j: Sequence[float],
    qrange: QuantileRange,
) -> Outcome:
    """Convenience wrapper taking the ``(q_lower, q_upper)`` tuple."""
    return compare_measurements(t_i, t_j, qrange[0], qrange[1])


def _validate_range(q_lower: float, q_upper: float) -> None:
    if not (0.0 < q_lower < q_upper < 100.0):
        raise ValueError(
            f"quantile range must satisfy 0 < q_lower < q_upper < 100, "
            f"got ({q_lower}, {q_upper})"
        )


class QuantileTable:
    """All quantile windows of a measurement store, batched and cached.

    One Procedure-3 pass over ``p`` algorithms and ``R`` quantile ranges asks
    for O(p²·R) windows when evaluated pairwise inside the bubble sort; every
    one of them is a read from this (p × bounds) table, which costs a single
    batched ``np.percentile`` per group of equal-length rows. The table
    refreshes lazily and is invalidated by the store's monotonically
    increasing ``version``, so it can be held across a whole Procedure-4
    step (or an entire engine campaign) and recomputes exactly once per
    store mutation epoch.

    Rows with zero measurements are excluded; asking for their window raises
    ``ValueError`` like :func:`quantile_window` does.
    """

    def __init__(self, store: "MeasurementStore", bounds: Sequence[float]) -> None:
        uniq = sorted({float(b) for b in bounds})
        for b in uniq:
            if not (0.0 < b < 100.0):
                raise ValueError(f"quantile bound must be in (0, 100), got {b}")
        self._store = store
        self._bounds = tuple(uniq)
        self._col = {b: i for i, b in enumerate(self._bounds)}
        self._version: Optional[int] = None
        self._table: Dict[str, np.ndarray] = {}

    @classmethod
    def from_ranges(
        cls, store: "MeasurementStore", ranges: Sequence[QuantileRange]
    ) -> "QuantileTable":
        """Table covering every bound of a quantile ladder (plus, typically,
        the reporting range)."""
        return cls(store, [b for r in ranges for b in r])

    @property
    def bounds(self) -> Tuple[float, ...]:
        return self._bounds

    def refresh(self) -> None:
        """Recompute if (and only if) the store changed since the last read."""
        version = self._store.version
        if version == self._version:
            return
        groups: Dict[int, List[str]] = {}
        for name in self._store.names():
            n = self._store.count(name)
            if n > 0:
                groups.setdefault(n, []).append(name)
        qs = np.asarray(self._bounds, dtype=np.float64)
        table: Dict[str, np.ndarray] = {}
        for names in groups.values():
            mat = np.stack([self._store.row(nm) for nm in names])
            pct = np.percentile(mat, qs, axis=1)  # (n_bounds, n_rows)
            for i, nm in enumerate(names):
                table[nm] = pct[:, i]
        self._table = table
        self._version = version

    def window(self, name: str, q_lower: float, q_upper: float) -> tuple:
        """``(Q_lo, Q_hi)`` — bit-identical to :func:`quantile_window` on the
        same row, but two float reads from the batched table."""
        self.refresh()
        try:
            row = self._table[name]
        except KeyError:
            raise ValueError(
                f"cannot compare algorithm {name!r} with zero measurements"
            ) from None
        try:
            return float(row[self._col[q_lower]]), float(row[self._col[q_upper]])
        except KeyError as e:
            raise KeyError(
                f"quantile bound {e.args[0]} not in table bounds {self._bounds}"
            ) from None

    def compare(
        self, name_i: str, name_j: str, q_lower: float, q_upper: float
    ) -> Outcome:
        """Procedure 1 through the table (same semantics as
        :func:`compare_measurements`)."""
        _validate_range(q_lower, q_upper)
        i_lo, i_hi = self.window(name_i, q_lower, q_upper)
        j_lo, j_hi = self.window(name_j, q_lower, q_upper)
        if i_hi < j_lo:
            return Outcome.BETTER
        if j_hi < i_lo:
            return Outcome.WORSE
        return Outcome.EQUIVALENT

    def compare_range(
        self, name_i: str, name_j: str, qrange: QuantileRange
    ) -> Outcome:
        return self.compare(name_i, name_j, qrange[0], qrange[1])
