"""Mean rank across a quantile ladder (paper Procedure 3, ``MeanRanks``).

A single quantile range either over-merges (wide ranges such as ``(5, 95)``
cover the distribution tails, so everything overlaps) or over-splits (narrow
ranges such as ``(35, 65)`` curtail the tails and tiny shifts become
"significant"). Procedure 3 therefore re-runs the rank-merging sort
(Procedure 2) on *each* range of a ladder and averages the per-algorithm
ranks; the mean rank quantifies relative shifts that the single
``(q25, q75)`` report cannot resolve (paper Table III).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from .comparison import QuantileTable
from .ranking import sort_by_measurements, sort_by_table
from .types import (
    DEFAULT_QUANTILE_RANGES,
    REPORT_QUANTILE_RANGE,
    QuantileRange,
)


@dataclass
class MeanRankResult:
    """Ranks at the reporting range + mean ranks across the ladder."""

    order: List[str]                 # sequence from the reporting range, best-first
    ranks: List[int]                 # performance classes at the reporting range
    mean_ranks: Dict[str, float]     # mr' per algorithm
    # Full Table-III style data; always includes report_range (averaged only
    # when it is a ladder member).
    per_range: Dict[QuantileRange, Dict[str, int]]

    def ordered_mean_ranks(self) -> List[float]:
        """Mean ranks sorted ascending — the ``x`` vector of Procedure 4."""
        return sorted(self.mean_ranks.values())

    def sequence(self) -> List[Tuple[str, int, float]]:
        return [
            (n, r, self.mean_ranks[n]) for n, r in zip(self.order, self.ranks)
        ]


def mean_ranks(
    order: Sequence[str],
    measurements: Optional[Mapping[str, Sequence[float]]],
    quantile_ranges: Sequence[QuantileRange] = DEFAULT_QUANTILE_RANGES,
    report_range: QuantileRange = REPORT_QUANTILE_RANGE,
    tie_break: str = "class",
    *,
    table: Optional[QuantileTable] = None,
    memoize: bool = True,
) -> MeanRankResult:
    """Procedure 3.

    Runs Procedure 2 once per quantile range (always from the same initial
    hypothesis ``order``, as in the paper), accumulates per-algorithm ranks,
    and reports the sequence at ``report_range`` together with the mean rank
    of every algorithm. When ``report_range`` is a member of
    ``quantile_ranges`` its Procedure-2 sort is computed once and reused for
    the report; otherwise the report range is evaluated additionally — shown
    in ``per_range`` but not averaged — so callers may e.g. use the
    left-tail ladder for means while still reporting at the IQR.

    Comparison backends (identical results, different cost):

    * ``table`` — a :class:`~repro_torch.core.comparison.QuantileTable`; every
      window of the whole ladder comes from one batched ``np.percentile``
      pass, and each pairwise comparison is two float reads. ``measurements``
      may then be ``None``; the table must cover every bound of
      ``quantile_ranges`` and ``report_range``.
    * ``measurements`` — the paper-literal pairwise path; quantile windows
      are recomputed from raw vectors per comparison (``memoize=False``
      reproduces the historical O(p²·R) percentile cost exactly).
    """
    if table is not None:
        def sorter(qrange: QuantileRange) -> Tuple[List[str], List[int]]:
            return sort_by_table(order, table, qrange, tie_break)
    elif measurements is not None:
        def sorter(qrange: QuantileRange) -> Tuple[List[str], List[int]]:
            return sort_by_measurements(
                order, measurements, qrange, tie_break, memoize
            )
    else:
        raise ValueError("mean_ranks needs either measurements or table")

    per_range: Dict[QuantileRange, Dict[str, int]] = {}
    totals: Dict[str, float] = {name: 0.0 for name in order}

    for qrange in quantile_ranges:
        names, ranks = sorter(qrange)
        rank_table = dict(zip(names, ranks))
        per_range[qrange] = rank_table
        for name in order:
            totals[name] += rank_table[name]

    n_ranges = len(quantile_ranges)
    mr = {name: totals[name] / n_ranges for name in order}

    if report_range in per_range:
        # Reuse the report range's already-computed sort: dicts preserve the
        # best-first insertion order, so the sequence reconstructs exactly.
        rank_table = per_range[report_range]
        rep_names, rep_ranks = list(rank_table), list(rank_table.values())
    else:
        rep_names, rep_ranks = sorter(report_range)
        per_range[report_range] = dict(zip(rep_names, rep_ranks))

    return MeanRankResult(
        order=rep_names,
        ranks=rep_ranks,
        mean_ranks=mr,
        per_range=per_range,
    )
