"""Distribution-level tests over segment measurement samples.

Median reconciliation (the attribution pipeline) explains anomalies the
medians can see; ELAPS-style analysis says the *distributions* carry the
rest of the story. Two tools live here:

* :func:`mode_mixture` — a deterministic 2-means mixture test on one
  sample set (the 1-D analogue of Hartigan's dip: find the split that
  minimises within-cluster variance, then score how far apart the two
  cluster means sit relative to the within-cluster spread). A processor
  alternating between frequency levels (paper Fig. 6, "turbo boost")
  produces exactly this signature in every measured name at once.
* :func:`median_gap_zscore` — the significance of a winner/loser median
  gap against the sampling noise of the two medians. A census ranking the
  explainer's medians cannot reproduce at any reasonable z is a candidate
  ``not_reproducible`` anomaly; the re-ranking probe
  (:func:`repro_torch.explain.runner.reranking_probe`) then measures the actual
  flip probability.

Thresholds were calibrated empirically: for 12-sample lognormal (unimodal)
draws the optimal-split separation sits at ~3.2 median, < 8 at the 1e-4
tail, while a ``bimodal_shift=0.5``-style second mode at realistic
measurement noise separates by 30+ — so ``min_separation=8`` cleanly
splits the two regimes, and majority-voting across a session's measured
names (:func:`session_bimodality`) suppresses both residual error
directions.

Pure numpy, deterministic, no device. A copy of the reference's
``repro.explain.distributions``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping, Sequence, Tuple

import numpy as np

#: Optimal-split separation below which a sample set is considered
#: unimodal (see module docstring for the calibration).
MIN_SEPARATION = 8.0
#: Minimum samples in the smaller cluster before a split counts as a mode
#: (a lone straggler is an outlier, not a frequency regime).
MIN_MINORITY = 2


@dataclass(frozen=True)
class ModeMixture:
    """One sample set, split into its best two-mean mixture."""

    n: int
    mu_lo: float           # mean of the faster cluster
    mu_hi: float           # mean of the slower cluster
    within_std: float      # pooled within-cluster standard deviation
    separation: float      # (mu_hi - mu_lo) / within_std
    minority: int          # size of the smaller cluster
    is_bimodal: bool

    def to_dict(self) -> Dict[str, Any]:
        return {
            "n": self.n,
            "mu_lo": self.mu_lo,
            "mu_hi": self.mu_hi,
            "separation": self.separation,
            "minority": self.minority,
            "is_bimodal": self.is_bimodal,
        }


def mode_mixture(
    samples: Sequence[float],
    *,
    min_separation: float = MIN_SEPARATION,
    min_minority: int = MIN_MINORITY,
) -> ModeMixture:
    """Best 2-means split of one measurement sample set.

    Sorts the samples and scans every split point for the minimum total
    within-cluster sum of squares (the exact 1-D 2-means optimum), then
    calls the set bimodal when the cluster means separate by at least
    ``min_separation`` pooled within-cluster standard deviations and the
    smaller cluster holds at least ``min_minority`` samples. Two exactly
    repeated values (zero within-variance, e.g. a noiseless cost model
    with a genuine slow mode) separate infinitely and count as bimodal.
    """
    x = np.sort(np.asarray(list(samples), dtype=np.float64))
    n = int(x.size)
    if n < 2 * max(1, min_minority):
        return ModeMixture(n, float(x.mean()) if n else 0.0,
                           float(x.mean()) if n else 0.0, 0.0, 0.0, 0, False)
    # prefix sums make every candidate split O(1):
    #   ss(lo) + ss(hi) = sum(x^2) - len_lo*mean_lo^2 - len_hi*mean_hi^2
    csum = np.cumsum(x)
    csq = np.cumsum(x * x)
    total_sum, total_sq = csum[-1], csq[-1]
    ks = np.arange(1, n)
    mean_lo = csum[:-1] / ks
    mean_hi = (total_sum - csum[:-1]) / (n - ks)
    within_ss = total_sq - ks * mean_lo**2 - (n - ks) * mean_hi**2
    k = int(np.argmin(within_ss))
    mu_lo, mu_hi = float(mean_lo[k]), float(mean_hi[k])
    within = float(np.sqrt(max(within_ss[k], 0.0) / max(n - 2, 1)))
    # floor the spread at a sliver of the scale so exact repeats (zero
    # within-variance) separate hugely instead of dividing by zero
    scale = max(abs(mu_hi), abs(mu_lo), 1e-300)
    within = max(within, 1e-9 * scale)
    separation = (mu_hi - mu_lo) / within
    minority = int(min(k + 1, n - (k + 1)))
    return ModeMixture(
        n=n,
        mu_lo=mu_lo,
        mu_hi=mu_hi,
        within_std=within,
        separation=float(separation),
        minority=minority,
        is_bimodal=(separation >= min_separation and minority >= min_minority),
    )


@dataclass(frozen=True)
class SessionBimodality:
    """Mode-mixture verdicts over every measured name of one explain
    session, majority-voted: a frequency regime is a property of the
    *machine*, so it shows up in (nearly) all distributions at once —
    which is exactly what separates it from a single slow kernel."""

    n_names: int
    n_bimodal: int
    mean_separation: float   # over the bimodal names (0.0 when none)

    @property
    def share(self) -> float:
        return self.n_bimodal / self.n_names if self.n_names else 0.0

    @property
    def is_bimodal(self) -> bool:
        return self.n_names > 0 and 2 * self.n_bimodal >= self.n_names

    def to_dict(self) -> Dict[str, Any]:
        return {
            "n_names": self.n_names,
            "n_bimodal": self.n_bimodal,
            "share": self.share,
            "mean_separation": self.mean_separation,
            "is_bimodal": self.is_bimodal,
        }


def session_bimodality(
    rows: Mapping[str, Sequence[float]],
    *,
    min_separation: float = MIN_SEPARATION,
    min_minority: int = MIN_MINORITY,
) -> SessionBimodality:
    """Majority vote of :func:`mode_mixture` across a session's measured
    names (whole algorithms and kernel segments alike)."""
    verdicts = [
        mode_mixture(samples, min_separation=min_separation,
                     min_minority=min_minority)
        for samples in rows.values()
    ]
    bimodal = [v for v in verdicts if v.is_bimodal]
    mean_sep = (
        float(np.mean([v.separation for v in bimodal])) if bimodal else 0.0
    )
    return SessionBimodality(
        n_names=len(verdicts), n_bimodal=len(bimodal),
        mean_separation=mean_sep,
    )


def median_gap_zscore(
    winner_samples: Sequence[float], loser_samples: Sequence[float]
) -> Tuple[float, float, float]:
    """``(gap, se, z)`` of the loser-minus-winner median difference.

    ``se`` is the large-sample standard error of the difference of two
    sample medians (1.2533 ~ sqrt(pi/2) per median under approximate
    normality); ``z = gap / se``. A z below ~3 means the explain
    re-measurement cannot statistically reproduce the census ranking —
    the trigger for the re-ranking confidence probe."""
    w = np.asarray(list(winner_samples), dtype=np.float64)
    l = np.asarray(list(loser_samples), dtype=np.float64)
    gap = float(np.median(l) - np.median(w))
    def med_var(x: np.ndarray) -> float:
        if x.size < 2:
            return 0.0
        return (1.2533 * float(np.std(x, ddof=1)) / np.sqrt(x.size)) ** 2
    se = float(np.sqrt(med_var(w) + med_var(l)))
    if se <= 0.0:
        # noiseless backend: any nonzero gap is infinitely significant,
        # an exact tie is infinitely insignificant
        z = float("inf") if gap != 0.0 else 0.0
    else:
        z = gap / se
    return gap, se, z
