"""Relative-FLOPs / Relative-Time scores and candidate filtering.

Paper Eq. (2):  RF_i = (F_i - F_min) / F_min
Paper Eq. (3):  RT_i = (T_i - T_min) / T_min

and the candidate-set construction of Sec. I (steps 1-3) / Sec. IV (last
paragraph): with hundreds of generated variants it is too expensive to
measure everything repeatedly, so the set ``S`` to be ranked is

    S = { algs with minimal FLOPs }  ∪  { algs with RT_i < threshold }

where RT is computed from a *single* warm run of each algorithm.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Sequence, Tuple


def relative_flops(flops: Mapping[str, float]) -> Dict[str, float]:
    """RF_i for every algorithm (Eq. 2)."""
    if not flops:
        return {}
    f_min = min(flops.values())
    if f_min <= 0:
        raise ValueError("FLOP counts must be positive")
    return {k: (v - f_min) / f_min for k, v in flops.items()}


def relative_times(times: Mapping[str, float]) -> Dict[str, float]:
    """RT_i for every algorithm (Eq. 3)."""
    if not times:
        return {}
    t_min = min(times.values())
    if t_min <= 0:
        raise ValueError("execution times must be positive")
    return {k: (v - t_min) / t_min for k, v in times.items()}


def min_flops_set(flops: Mapping[str, float], rel_tol: float = 0.0) -> Tuple[str, ...]:
    """``S_F``: all algorithms whose FLOP count is minimal.

    ``rel_tol`` admits algorithms within a relative tolerance of the minimum
    (the paper speaks of "nearly identical" FLOP counts; exact ties are the
    default).
    """
    f_min = min(flops.values())
    return tuple(
        sorted(k for k, v in flops.items() if v <= f_min * (1.0 + rel_tol))
    )


@dataclass(frozen=True)
class CandidateSet:
    names: Tuple[str, ...]          # the reduced set S, deduplicated, stable order
    min_flops: Tuple[str, ...]      # S_F ⊆ S
    relative_flops: Dict[str, float]
    relative_times: Dict[str, float]
    dropped: Tuple[str, ...]        # algorithms filtered out


def filter_candidates(
    flops: Mapping[str, float],
    single_run_times: Mapping[str, float],
    rt_threshold: float = 1.5,
    flops_rel_tol: float = 0.0,
) -> CandidateSet:
    """Construct the candidate set S (paper Sec. I steps 1-3).

    All min-FLOPs algorithms are always kept; additionally any algorithm with
    single-run ``RT_i < rt_threshold`` is kept (default threshold 1.5, the
    value suggested in Sec. IV).
    """
    if set(flops) != set(single_run_times):
        raise ValueError("flops and single_run_times must cover the same algorithms")
    rf = relative_flops(flops)
    rt = relative_times(single_run_times)
    sf = min_flops_set(flops, rel_tol=flops_rel_tol)

    keep: List[str] = []
    for name in flops:
        if name in sf or rt[name] < rt_threshold:
            keep.append(name)
    keep_sorted = tuple(sorted(keep, key=lambda n: single_run_times[n]))
    dropped = tuple(sorted(set(flops) - set(keep)))
    return CandidateSet(
        names=keep_sorted,
        min_flops=sf,
        relative_flops=rf,
        relative_times=rt,
        dropped=dropped,
    )


def initial_hypothesis_by_time(single_run_times: Mapping[str, float]) -> List[str]:
    """``h_0`` ordered by increasing single-run execution time (Sec. I step 4)."""
    return sorted(single_run_times, key=lambda n: single_run_times[n])


def initial_hypothesis_by_flops(flops: Mapping[str, float]) -> List[str]:
    """``h_0`` ordered by increasing FLOP count (alternative mentioned Sec. V)."""
    return sorted(flops, key=lambda n: flops[n])
