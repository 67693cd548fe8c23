"""repro_torch.core — the paper's contribution (PyTorch port).

Statistically-sound ranking of mathematically equivalent algorithms into
performance classes (Sankaran & Bientinesi 2022), plus the test for FLOPs as
a discriminant. Backend-agnostic: measurements may come from wall-clock
timing, simulation, or a compiled-artifact cost model.

A copy of the JAX package's ``repro.core`` minus the census (``sweep``),
which a later slice of the port brings over. Only ``measure.WallClockTimer``
differs: it checks the blocking contract with ``torch.cuda.synchronize()``.
"""

from .comparison import (
    QuantileTable,
    compare_measurements,
    compare_range,
    quantile_window,
)
from .convergence import (
    convergence_norm,
    first_differences,
    measure_and_rank,
)
from .discriminant import flops_discriminant_test
from .engine import POLICIES, ExperimentEngine
from .meanrank import MeanRankResult, mean_ranks
from .measure import (
    CostModelTimer,
    DetachedTimer,
    MeasurementStore,
    NoiseProfile,
    SimulatedTimer,
    Timer,
    WallClockTimer,
    timer_from_dict,
    timer_to_dict,
)
from .session import MeasurementSession
from .ranking import (
    make_measurement_comparator,
    make_table_comparator,
    ranks_as_dict,
    sort_algorithms,
    sort_by_measurements,
    sort_by_table,
)
from .scores import (
    CandidateSet,
    filter_candidates,
    initial_hypothesis_by_flops,
    initial_hypothesis_by_time,
    min_flops_set,
    relative_flops,
    relative_times,
)
from .types import (
    DEFAULT_QUANTILE_RANGES,
    FAST_MODE_QUANTILE_RANGES,
    REPORT_QUANTILE_RANGE,
    DiscriminantReport,
    IterationRecord,
    Outcome,
    QuantileRange,
    RankedAlgorithm,
    RankingResult,
)

__all__ = [
    "CandidateSet",
    "CostModelTimer",
    "DEFAULT_QUANTILE_RANGES",
    "DetachedTimer",
    "DiscriminantReport",
    "ExperimentEngine",
    "FAST_MODE_QUANTILE_RANGES",
    "IterationRecord",
    "MeanRankResult",
    "MeasurementSession",
    "MeasurementStore",
    "NoiseProfile",
    "Outcome",
    "POLICIES",
    "QuantileRange",
    "QuantileTable",
    "RankedAlgorithm",
    "RankingResult",
    "REPORT_QUANTILE_RANGE",
    "SimulatedTimer",
    "Timer",
    "WallClockTimer",
    "compare_measurements",
    "compare_range",
    "convergence_norm",
    "filter_candidates",
    "first_differences",
    "flops_discriminant_test",
    "initial_hypothesis_by_flops",
    "initial_hypothesis_by_time",
    "make_measurement_comparator",
    "make_table_comparator",
    "mean_ranks",
    "measure_and_rank",
    "min_flops_set",
    "quantile_window",
    "ranks_as_dict",
    "relative_flops",
    "relative_times",
    "sort_algorithms",
    "sort_by_measurements",
    "sort_by_table",
    "timer_from_dict",
    "timer_to_dict",
]
