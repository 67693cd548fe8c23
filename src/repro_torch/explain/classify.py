"""Cause taxonomy: turn a winner/loser attribution pair into a ranked,
evidence-backed explanation.

An anomaly always has a *winner* (the best-ranked algorithm overall) and a
*loser* (the minimum-FLOPs algorithm that should have won — or, for an
``S_F``-split anomaly, the ``S_F`` member stranded in the worse class).
The time gap between them decomposes exactly:

    gap = (t_loser - t_winner)
        =   d_roofline   (different hardware floors: FLOP/byte counts
                          AND calibrated per-kernel dispatch)
          + d_excess     (kernel-level efficiency differences)
          + d_residual   (between-kernel overhead differences; negative
                          when a whole run beats its own kernel sum)

The cause is the dominant component, refined by *how* it is carried —
which kernel, which pair, which roofline term — and cross-checked against
two distribution-level signals (:mod:`repro_torch.explain.distributions`): a
mode-mixture test over every measured sample set, and the statistical
significance of the median gap backed by a re-ranking probe.

``frequency_bimodality``
    The majority of the session's measurement distributions split into two
    well-separated modes — the machine alternates frequency regimes
    (turbo boost, paper Fig. 6); no per-kernel story survives that.
``not_reproducible``
    The explain re-measurement cannot reproduce the census ranking: the
    gap is non-positive or statistically insignificant, and the
    re-ranking probe confirms the winner/loser order flips under the
    census protocol. Evidence = measured flip probability.
``shape_kernel_efficiency``
    Kernel excess dominates and the offending kernel is compute-bound —
    the same mathematical operation runs at shape-dependent efficiency
    (the cache/blocking effects the paper attributes anomalies to).
``memory_bound_segment``
    The offending kernel sits on the memory roof — either its excess
    dominates the gap, or the calibrated roofline itself says the loser
    streams more bytes than the winner.
``cache_reuse_pair``
    The residual dominates and the *winner's* residual is negative: its
    whole run beats the sum of its isolated kernels because adjacent
    kernels hand data over in cache. ``offending_kernel`` names the pair.
``dispatch_overhead``
    The loser pays for more (or slower) kernel dispatches than the
    winner — via a dominant positive residual, via an offending kernel
    whose calibrated floor is dispatch-dominated, or via the calibrated
    dispatch term of the roofline difference (tiny instances).
``unexplained``
    No component reaches the evidence threshold; the taxonomy cannot
    (yet) name the cause — these rows seed the ROADMAP's open questions.

The evidence score is the fraction of the gap the chosen component
explains, clamped to [0, 1] — except ``not_reproducible``, where it is
the probe's flip probability (the confidence that there is no gap to
explain), and ``frequency_bimodality``, where it is the share of measured
distributions that split into two modes.

A copy of the reference's ``repro.explain.classify``: :data:`CAUSES`,
the thresholds and the defaults are the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional, Tuple

from .attribution import AlgorithmAttribution, KernelAttribution
from .distributions import SessionBimodality

#: The taxonomy, in reporting order.
CAUSES = (
    "shape_kernel_efficiency",
    "memory_bound_segment",
    "dispatch_overhead",
    "frequency_bimodality",
    "cache_reuse_pair",
    "not_reproducible",
    "unexplained",
)

#: Below this many median-gap standard errors the census ranking counts as
#: statistically unreproduced and the re-ranking probe decides.
DEFAULT_FLIP_Z = 3.0
#: Minimum probe flip probability before an insignificant-but-positive gap
#: is declared not reproducible.
DEFAULT_FLIP_MIN_PROB = 0.25


@dataclass(frozen=True)
class Explanation:
    """One anomaly, explained (or honestly not)."""

    uid: str
    reason: str                      # the census anomaly reason
    cause: str                       # one of CAUSES
    evidence: float                  # cause-specific confidence, [0, 1]
    winner: str
    loser: str
    gap: float                       # t_loser - t_winner (seconds)
    gap_rel: float                   # gap / t_winner
    offending_algorithm: Optional[str]
    offending_kernel: Optional[str]  # KernelSpec.label (or "a+b" pair)
    components: Dict[str, float] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "uid": self.uid,
            "reason": self.reason,
            "cause": self.cause,
            "evidence": self.evidence,
            "winner": self.winner,
            "loser": self.loser,
            "gap": self.gap,
            "gap_rel": self.gap_rel,
            "offending_algorithm": self.offending_algorithm,
            "offending_kernel": self.offending_kernel,
            "components": dict(self.components),
        }


def pick_winner_loser(record: Mapping[str, Any]) -> Tuple[str, str]:
    """(winner, loser) algorithm names for one census anomaly record.

    Winner: best rank overall, ties broken by mean rank then name. Loser:
    for ``faster_outside_min_flops`` the best-ranked ``S_F`` member (the
    strongest representative that still lost); for ``min_flops_split`` the
    worst-ranked ``S_F`` member (the one you must not pick at random).
    Deterministic — the explain campaign's work list derives from it.
    """
    ranks: Dict[str, int] = {k: int(v) for k, v in record["ranks"].items()}
    means: Dict[str, float] = {k: float(v) for k, v in record["mean_ranks"].items()}
    sf = [n for n in record["min_flops_algs"] if n in ranks]
    if not sf:
        raise ValueError(f"record {record.get('uid')!r} has no ranked S_F member")

    def key(name: str) -> Tuple[int, float, str]:
        return (ranks[name], means.get(name, float("inf")), name)

    winner = min(ranks, key=key)
    if record.get("reason") == "min_flops_split":
        loser = max(sf, key=key)
    else:
        loser = min(sf, key=key)
    if loser == winner:
        # S_F's best IS the overall winner: nothing lost, nothing to
        # explain. Anomaly records can never reach here (reason 1 puts the
        # winner outside S_F; reason 2 splits S_F across classes).
        raise ValueError(
            f"record {record.get('uid')!r} (reason "
            f"{record.get('reason')!r}) has no winner/loser gap to explain"
        )
    return winner, loser


def _offending(
    winner: AlgorithmAttribution, loser: AlgorithmAttribution
) -> KernelAttribution:
    """The kernel that moves the gap most: largest |excess| across BOTH
    algorithms (the winner being unusually *efficient* on one kernel is as
    much a root cause as the loser being inefficient). Ties: loser first,
    then execution order."""
    candidates = [(abs(k.excess), 1, -i, k) for i, k in enumerate(loser.kernels)]
    candidates += [(abs(k.excess), 0, -i, k) for i, k in enumerate(winner.kernels)]
    return max(candidates, key=lambda c: c[:3])[3]


def _worst_memory_kernel(loser: AlgorithmAttribution) -> Optional[KernelAttribution]:
    """The loser's heaviest memory-bound kernel (by roofline share)."""
    mem = [k for k in loser.kernels if k.bound == "memory"]
    if not mem:
        return None
    best = max(range(len(mem)), key=lambda i: (mem[i].t_roofline, -i))
    return mem[best]


def classify_anomaly(
    record: Mapping[str, Any],
    winner: AlgorithmAttribution,
    loser: AlgorithmAttribution,
    *,
    min_evidence: float = 0.5,
    bimodality: Optional[SessionBimodality] = None,
    flip_probability: Optional[float] = None,
    gap_zscore: Optional[float] = None,
    flip_z: float = DEFAULT_FLIP_Z,
    flip_min_prob: float = DEFAULT_FLIP_MIN_PROB,
) -> Explanation:
    """Assign a cause + evidence score to one anomaly from its two
    attributions plus the distribution-level signals.

    ``min_evidence`` is the fraction of the gap a component must explain
    before the taxonomy commits to it. ``bimodality`` is the session-wide
    mode-mixture vote; ``gap_zscore``/``flip_probability`` come from
    :func:`repro_torch.explain.distributions.median_gap_zscore` and the runner's
    re-ranking probe (both optional: medians-only callers degrade to the
    v1 behaviour, with ``not_reproducible`` replacing the old
    evidence-zero ``unexplained`` for non-positive gaps)."""
    gap = loser.t_total - winner.t_total
    d_roofline = loser.t_roofline_sum - winner.t_roofline_sum
    d_excess = loser.excess_total - winner.excess_total
    d_residual = loser.residual - winner.residual
    d_dispatch = loser.t_dispatch_sum - winner.t_dispatch_sum
    d_memory = loser.t_bound_sum("memory") - winner.t_bound_sum("memory")
    components = {
        "roofline": d_roofline,
        "kernel_excess": d_excess,
        "residual": d_residual,
        "roofline_dispatch": d_dispatch,
        "roofline_memory": d_memory,
        "winner_residual": winner.residual,
    }

    def done(cause: str, evidence: float,
             off: Optional[KernelAttribution],
             off_label: Optional[str] = None,
             off_alg: Optional[str] = None) -> Explanation:
        if off is not None and off_alg is None:
            off_alg = off.name.split("::", 1)[0]
        if off is not None and off_label is None:
            off_label = off.kernel.label
        return Explanation(
            uid=str(record["uid"]),
            reason=str(record.get("reason", "")),
            cause=cause,
            evidence=max(0.0, min(1.0, evidence)),
            winner=winner.algorithm,
            loser=loser.algorithm,
            gap=gap,
            gap_rel=(gap / winner.t_total) if winner.t_total > 0 else 0.0,
            offending_algorithm=off_alg,
            offending_kernel=off_label,
            components=components,
        )

    # 1. machine-regime effects first: when the measurement distributions
    # themselves split into frequency modes, medians (and everything
    # derived from them) describe a mixture, not a kernel.
    if bimodality is not None and bimodality.is_bimodal:
        return done("frequency_bimodality", bimodality.share, None)

    # 2. rankings the medians cannot reproduce. A non-positive gap is
    # always one; a positive-but-insignificant gap needs the probe to
    # confirm the flip before the taxonomy gives up on components.
    if gap <= 0:
        return done("not_reproducible", flip_probability or 0.0, None)
    if (
        gap_zscore is not None
        and flip_probability is not None
        and gap_zscore < flip_z
        and flip_probability >= flip_min_prob
    ):
        return done("not_reproducible", flip_probability, None)

    # 3. per-kernel efficiency: the gap lives inside kernels.
    frac_excess = d_excess / gap
    frac_residual = d_residual / gap
    if frac_excess >= min_evidence and frac_excess >= frac_residual:
        off = _offending(winner, loser)
        if off.bound == "memory":
            cause = "memory_bound_segment"
        elif off.t_dispatch > max(off.t_roofline - off.t_dispatch, 0.0):
            # the offending kernel's calibrated floor is mostly dispatch:
            # its "inefficiency" is launch cost, not math
            cause = "dispatch_overhead"
        else:
            cause = "shape_kernel_efficiency"
        return done(cause, frac_excess, off)

    # 4. the residual: between-kernel time. Negative on the winner's side
    # means the winner's whole run beats its own kernel sum — adjacent
    # kernels share cache, and that sharing is what won.
    if frac_residual >= min_evidence:
        frac_reuse = -winner.residual / gap
        pair = winner.cache_pair()
        if winner.residual < 0 and frac_reuse >= min_evidence and pair is not None:
            a, b = pair
            return done(
                "cache_reuse_pair", frac_reuse, None,
                off_label=f"{a.kernel.label}+{b.kernel.label}",
                off_alg=winner.algorithm,
            )
        return done("dispatch_overhead", frac_residual, None)

    # 5. the roofline difference itself: normally "expected hardware
    # floors", but its calibrated dispatch/memory terms are real causes —
    # equal-FLOPs algorithms still differ in launches and bytes.
    frac_roofline = d_roofline / gap
    if frac_roofline >= min_evidence:
        frac_dispatch = d_dispatch / gap
        frac_memory = d_memory / gap
        if frac_dispatch >= min_evidence and frac_dispatch >= frac_memory:
            return done("dispatch_overhead", frac_dispatch, None)
        if frac_memory >= min_evidence:
            off = _worst_memory_kernel(loser)
            return done("memory_bound_segment", frac_memory, off)

    best = max(frac_excess, frac_residual, 0.0)
    return done("unexplained", best, None)
