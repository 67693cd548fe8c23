"""Convergence-driven incremental measurement (paper Procedure 4,
``MeasureAndRank``).

Statistically sound comparison needs many repetitions, but measuring every
variant many times is expensive — the paper's loop adds only ``M`` (2–3)
measurements per algorithm per iteration, recomputes the mean ranks over the
quantile ladder, and stops when the *shape* of the rank landscape stabilises:

    x    = mean ranks, sorted ascending
    dx   = convolution(x, [1, -1])          (first differences)
    stop when  ||dx - dy||_2 / p  <  eps    (dy = previous iteration's dx)

or when ``N`` reaches the user budget ``max``.

The loop body lives in :class:`repro_torch.core.session.MeasurementSession`
(one ``step()`` per iteration, fully serializable); this module keeps the
original blocking driver with its exact public signature. Campaigns over
many instances go through :class:`repro_torch.core.engine.ExperimentEngine`
instead of calling this in a loop.
"""

from __future__ import annotations

from typing import Optional, Sequence

from .measure import MeasurementStore, Timer
from .session import (  # re-exported for backwards compatibility
    MeasurementSession,
    convergence_norm,
    first_differences,
)
from .types import (
    DEFAULT_QUANTILE_RANGES,
    REPORT_QUANTILE_RANGE,
    QuantileRange,
    RankingResult,
)

__all__ = [
    "convergence_norm",
    "first_differences",
    "measure_and_rank",
]


def measure_and_rank(
    initial_order: Sequence[str],
    timer: Timer,
    m_per_iteration: int = 3,
    eps: float = 0.03,
    max_measurements: int = 30,
    quantile_ranges: Sequence[QuantileRange] = DEFAULT_QUANTILE_RANGES,
    report_range: QuantileRange = REPORT_QUANTILE_RANGE,
    tie_break: str = "class",
    store: Optional[MeasurementStore] = None,
    shuffle_seed: Optional[int] = 0,
) -> RankingResult:
    """Procedure 4 — blocking drive of a single measurement session.

    Parameters
    ----------
    initial_order:
        ``h_0`` — e.g. algorithms sorted by single-run execution time
        (paper Sec. I step 4) or by FLOP count.
    timer:
        Measurement backend (wall-clock, simulated, or cost model).
    m_per_iteration, eps, max_measurements:
        ``M``, ``eps``, ``max`` of the paper (defaults = paper Sec. IV).
    store:
        Optional pre-populated measurement store (warm-start); new
        measurements are appended to it. A store that already holds >= 1
        measurement per algorithm at (or past) the budget is ranked as-is —
        no measurements are taken beyond ``max_measurements``.
    shuffle_seed:
        Seed for the pre-iteration shuffle (None disables shuffling).

    Returns
    -------
    RankingResult with the final ``s_[25,75]`` sequence, mean ranks,
    convergence flag and full per-iteration history.
    """
    session = MeasurementSession(
        "measure_and_rank",
        initial_order,
        timer,
        m_per_iteration=m_per_iteration,
        eps=eps,
        max_measurements=max_measurements,
        quantile_ranges=quantile_ranges,
        report_range=report_range,
        tie_break=tie_break,
        store=store,
        shuffle_seed=shuffle_seed,
    )
    return session.run_to_convergence()
