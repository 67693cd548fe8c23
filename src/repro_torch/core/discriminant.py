"""The FLOPs-as-discriminant test (the paper's titular contribution).

Let ``S_F`` be the set of algorithms with the least FLOP count and let the
ranking methodology (Procedure 4) assign every algorithm a performance class.
FLOPs are a **valid discriminant** for the instance iff all members of
``S_F`` obtain the best rank *and* no non-member strictly beats them;
otherwise the instance is an **anomaly** (paper Sec. I):

1. anomaly if some algorithm outside ``S_F`` exhibits noticeably better
   performance than those in ``S_F`` — i.e. ``S_F`` is not a valid
   representative of the fastest algorithms;
2. otherwise anomaly if members of ``S_F`` land in different performance
   classes — one cannot randomly pick from ``S_F``.

Anomalies are the instances worth investigating for root causes (and the
instances where a performance model can beat FLOP-count selection).
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

from .scores import min_flops_set, relative_flops
from .types import DiscriminantReport, RankingResult


def flops_discriminant_test(
    ranking: RankingResult,
    flops: Mapping[str, float],
    flops_rel_tol: float = 0.0,
) -> DiscriminantReport:
    """Classify an instance as FLOPs-discriminable or anomalous.

    Parameters
    ----------
    ranking:
        Output of Procedure 4 over the candidate set. Every algorithm in
        ``flops`` need not appear (candidate filtering may have dropped slow
        high-FLOPs variants — dropped algorithms cannot beat ``S_F`` by
        construction, their single-run RT exceeded the threshold).
    flops:
        Analytic FLOP count per algorithm (full set).
    """
    ranks = ranking.ranks
    sf_all = min_flops_set(flops, rel_tol=flops_rel_tol)
    sf = tuple(n for n in sf_all if n in ranks)
    if not sf:
        raise ValueError(
            "no minimum-FLOPs algorithm present in the ranking; the candidate "
            "set must always include S_F"
        )

    best_rank_overall = min(ranks.values())
    best_rank_in_sf = min(ranks[n] for n in sf)
    sf_ranks = {ranks[n] for n in sf}

    if best_rank_in_sf > best_rank_overall:
        # Condition 1: someone outside S_F is in a strictly better class.
        reason = "faster_outside_min_flops"
        is_anomaly = True
    elif len(sf_ranks) > 1:
        # Condition 2: S_F itself splits across performance classes.
        reason = "min_flops_split"
        is_anomaly = True
    else:
        reason = "none"
        is_anomaly = False

    return DiscriminantReport(
        is_anomaly=is_anomaly,
        reason=reason,
        min_flops_algs=sf,
        best_rank_in_sf=best_rank_in_sf,
        best_rank_overall=best_rank_overall,
        ranks=dict(ranks),
        relative_flops=relative_flops(flops),
    )
