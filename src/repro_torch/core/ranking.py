"""Rank-merging bubble sort (paper Procedure 2, ``SortAlgs``).

Sorts a sequence of algorithms with the three-way comparator
(:mod:`repro_torch.core.comparison`), assigning *performance classes*: equivalent
algorithms share a rank. Positions hold ranks (the rank array is positional,
non-decreasing left-to-right, starts at 1, adjacent steps <= 1); swaps move
algorithm indices while the update rules repair the positional ranks.

Rank-update rules
-----------------
Let ``r`` be the positional rank array and let the comparison at positions
``(j, j+1)`` return:

* ``alg[j+1]`` faster  ->  swap the algorithm indices. If ``r[j+1] == r[j]``
  the swap *breaks a tie*: a new class boundary appears after position ``j``.
* equivalent           ->  no swap. If ``r[j+1] != r[j]`` the classes merge:
  decrement ``r[j+1:]`` by 1.
* ``alg[j]`` faster    ->  nothing.

Paper discrepancy (documented in DESIGN.md §7 and tested in
``tests/test_ranking.py``): for the tie-break case the paper's *pseudocode*
says "increment ranks r_{j+1}, ..., r_p by 1", but its worked example (Fig. 4)
and twice-stated final answer increment only the *remainder of the broken tie
class* (positions after ``j`` whose rank still equals the old tied value).
Running the literal rule on Fig. 4 yields final ranks ``[1, 1, 2, 3]``; the
figure states ``[1, 1, 2, 2]``. We default to the figure-consistent rule
(``tie_break="class"``) and keep the literal rule available
(``tie_break="literal"``) for comparison studies.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Sequence, Tuple

from .comparison import QuantileTable, compare_measurements
from .types import Outcome, QuantileRange

# Comparator signature: (name_i, name_j) -> Outcome
Comparator = Callable[[str, str], Outcome]


def make_measurement_comparator(
    measurements: Mapping[str, Sequence[float]],
    qrange: QuantileRange,
) -> Comparator:
    """Build a Procedure-1 comparator over a measurement table (recomputes
    both quantile windows from raw vectors per call — the legacy path)."""

    def cmp(name_i: str, name_j: str) -> Outcome:
        return compare_measurements(
            measurements[name_i], measurements[name_j], qrange[0], qrange[1]
        )

    return cmp


def make_table_comparator(
    table: QuantileTable,
    qrange: QuantileRange,
) -> Comparator:
    """Build a Procedure-1 comparator over a pre-batched
    :class:`~repro_torch.core.comparison.QuantileTable` — each comparison is two
    float reads instead of four ``np.percentile`` computations."""
    q_lower, q_upper = float(qrange[0]), float(qrange[1])

    def cmp(name_i: str, name_j: str) -> Outcome:
        return table.compare(name_i, name_j, q_lower, q_upper)

    return cmp


def sort_algorithms(
    order: Sequence[str],
    comparator: Comparator,
    tie_break: str = "class",
    memoize: bool = True,
) -> Tuple[List[str], List[int]]:
    """Procedure 2: bubble sort with the three-way comparison.

    Parameters
    ----------
    order:
        Initial hypothesis ``h_0`` (best-first guess).
    comparator:
        Three-way comparison; called as ``comparator(a, b)`` and interpreted
        from ``a``'s perspective (``BETTER`` means ``a`` is faster).
    tie_break:
        ``"class"`` (default, figure-consistent) or ``"literal"`` (pseudocode
        rule) — see module docstring.
    memoize:
        Cache comparison outcomes per (a, b) pair for the duration of this
        sort. Bubble-sort passes re-compare identical pairs whose underlying
        data cannot have changed mid-sort, so for a deterministic comparator
        (any measurement- or table-backed one) memoization changes nothing
        but the cost. Disable only for stateful comparators.

    Returns
    -------
    (names, ranks):
        ``names`` sorted best-first; ``ranks[k]`` is the performance class of
        ``names[k]`` (1-based, shared ranks allowed).
    """
    if tie_break not in ("class", "literal"):
        raise ValueError(f"unknown tie_break rule: {tie_break!r}")
    names: List[str] = list(order)
    p = len(names)
    ranks: List[int] = list(range(1, p + 1))
    if p <= 1:
        return names, ranks[:p]

    if memoize:
        raw = comparator
        seen: Dict[Tuple[str, str], Outcome] = {}

        def comparator(a: str, b: str) -> Outcome:  # noqa: F811
            key = (a, b)
            out = seen.get(key)
            if out is None:
                out = seen[key] = raw(a, b)
            return out

    for k in range(p):
        for j in range(p - k - 1):
            out = comparator(names[j], names[j + 1])
            if out is Outcome.WORSE:
                # alg at j+1 is faster: swap algorithm indices.
                names[j], names[j + 1] = names[j + 1], names[j]
                if ranks[j + 1] == ranks[j]:
                    # Tie broken: the element bubbled out of its class.
                    old = ranks[j + 1]
                    if tie_break == "literal":
                        for m in range(j + 1, p):
                            ranks[m] += 1
                    else:  # "class": only the remainder of the broken class
                        m = j + 1
                        while m < p and ranks[m] == old:
                            ranks[m] += 1
                            m += 1
            elif out is Outcome.EQUIVALENT:
                if ranks[j + 1] != ranks[j]:
                    # Classes merge; shift every later class down.
                    for m in range(j + 1, p):
                        ranks[m] -= 1
            # BETTER: alg at j already faster; leave ranks as they are.
    _check_rank_invariants(ranks)
    return names, ranks


def sort_by_measurements(
    order: Sequence[str],
    measurements: Mapping[str, Sequence[float]],
    qrange: QuantileRange,
    tie_break: str = "class",
    memoize: bool = True,
) -> Tuple[List[str], List[int]]:
    """Procedure 2 specialised to a measurement table + quantile range."""
    return sort_algorithms(
        order, make_measurement_comparator(measurements, qrange), tie_break, memoize
    )


def sort_by_table(
    order: Sequence[str],
    table: QuantileTable,
    qrange: QuantileRange,
    tie_break: str = "class",
) -> Tuple[List[str], List[int]]:
    """Procedure 2 specialised to a batched quantile table (the fast path)."""
    return sort_algorithms(order, make_table_comparator(table, qrange), tie_break)


def ranks_as_dict(names: Sequence[str], ranks: Sequence[int]) -> Dict[str, int]:
    return dict(zip(names, ranks))


def _check_rank_invariants(ranks: Sequence[int]) -> None:
    """Positional ranks: start at 1, non-decreasing, adjacent step <= 1."""
    if not ranks:
        return
    if ranks[0] != 1:
        raise AssertionError(f"rank invariant violated: first rank {ranks[0]} != 1")
    for a, b in zip(ranks, ranks[1:]):
        if b < a or b - a > 1:
            raise AssertionError(f"rank invariant violated: adjacent pair ({a}, {b})")
