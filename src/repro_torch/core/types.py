"""Core datatypes for the algorithm-ranking methodology.

Implements the vocabulary of Sankaran & Bientinesi, "A Test for FLOPs as a
Discriminant for Linear Algebra Algorithms" (2022): three-way comparison
outcomes, ranked sequences with shared ranks (performance classes), and the
result record of the convergence-driven measurement loop (Procedure 4).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


class Outcome(enum.Enum):
    """Result of the three-way comparison (paper Procedure 1)."""

    BETTER = "better"          # alg_i < alg_j   (i is faster)
    WORSE = "worse"            # alg_i > alg_j   (i is slower)
    EQUIVALENT = "equivalent"  # alg_i ~ alg_j   (distributions overlap)

    def flipped(self) -> "Outcome":
        if self is Outcome.BETTER:
            return Outcome.WORSE
        if self is Outcome.WORSE:
            return Outcome.BETTER
        return Outcome.EQUIVALENT


# A quantile range (q_lower, q_upper), percentages in (0, 100).
QuantileRange = Tuple[float, float]

#: Quantile ladder used throughout the paper (Table III).
DEFAULT_QUANTILE_RANGES: Tuple[QuantileRange, ...] = (
    (5.0, 95.0),
    (10.0, 90.0),
    (15.0, 85.0),
    (20.0, 80.0),
    (25.0, 75.0),
    (30.0, 70.0),
    (35.0, 65.0),
)

#: Left-tail quantile set used for the turbo-boost / fast-frequency-mode
#: analysis (paper Sec. IV, "Effect of Turbo boost").
FAST_MODE_QUANTILE_RANGES: Tuple[QuantileRange, ...] = (
    (5.0, 50.0),
    (15.0, 45.0),
    (20.0, 40.0),
    (25.0, 35.0),
)

#: Default reporting range — (q25, q75), the IQR, standard for outlier
#: detection (paper Sec. III, Procedure 3 discussion).
REPORT_QUANTILE_RANGE: QuantileRange = (25.0, 75.0)


@dataclass(frozen=True)
class RankedAlgorithm:
    """One entry of the sorted sequence ``s`` (paper Sec. III)."""

    name: str
    rank: int                      # performance class; shared ranks allowed
    mean_rank: Optional[float] = None


@dataclass
class RankingResult:
    """Output of Procedure 4 (``MeasureAndRank``).

    Attributes
    ----------
    sequence:
        ``s_[25,75]`` — algorithms ordered best-first with their ranks at the
        reporting quantile range.
    mean_ranks:
        ``mr'`` — mean rank per algorithm across the quantile ladder.
    measurements_per_alg:
        ``N`` when the loop stopped.
    converged:
        True if the stopping criterion ``||dx - dy|| / p < eps`` fired (as
        opposed to hitting the measurement budget ``max``).
    history:
        Per-iteration record of (N, mean-rank vector in sequence order,
        convergence norm) for analysis/benchmarks.
    """

    sequence: List[RankedAlgorithm]
    mean_ranks: Dict[str, float]
    measurements_per_alg: int
    converged: bool
    history: List["IterationRecord"] = field(default_factory=list)

    @property
    def names_in_order(self) -> List[str]:
        return [a.name for a in self.sequence]

    @property
    def ranks(self) -> Dict[str, int]:
        return {a.name: a.rank for a in self.sequence}

    def best_class(self) -> List[str]:
        """Names of all algorithms in performance class 1."""
        return [a.name for a in self.sequence if a.rank == 1]

    def rank_of(self, name: str) -> int:
        for a in self.sequence:
            if a.name == name:
                return a.rank
        raise KeyError(name)


@dataclass(frozen=True)
class IterationRecord:
    measurements_per_alg: int
    order: Tuple[str, ...]
    ranks: Tuple[int, ...]
    mean_ranks: Tuple[float, ...]
    norm: float


@dataclass(frozen=True)
class DiscriminantReport:
    """Result of the FLOPs-as-discriminant test (paper Sec. I & IV).

    ``is_anomaly`` is True iff FLOPs fail to discriminate:
      reason == "faster_outside_min_flops":  an algorithm outside S_F obtained
          a strictly better performance class than the best member of S_F
          (condition 1 in the paper's Sec. I enumeration);
      reason == "min_flops_split":  members of S_F landed in different
          performance classes, so one cannot pick randomly from S_F
          (condition 2).
    """

    is_anomaly: bool
    reason: str                     # "none" | the two anomaly reasons above
    min_flops_algs: Tuple[str, ...]  # S_F
    best_rank_in_sf: int
    best_rank_overall: int
    ranks: Dict[str, int]
    relative_flops: Dict[str, float]
