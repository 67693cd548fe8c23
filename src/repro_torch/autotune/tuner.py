"""The paper's methodology as the framework's variant selector.

``rank_site`` runs the full pipeline on a :class:`VariantSite`:

1. single warm run per variant -> RT scores -> candidate filtering
   (paper Sec. I steps 1-3);
2. initial hypothesis = increasing single-run time (step 4);
3. Procedure 4 (convergence-driven incremental measurement with mean ranks
   over the quantile ladder);
4. FLOPs-discriminant test over the site's analytic FLOP table;
5. selection: best-rank variant, ties broken by (FLOPs, mean rank).

``rank_site_costmodel`` swaps wall-clock for the dry-run roofline cost model
(CostModelTimer) — compile-time selection for cluster-scale variants that
cannot be executed on this host. Both paths return the same report type, so
EXPERIMENTS.md can compare 'measured' vs 'modelled' verdicts per site.

Everything is built on the ExperimentEngine: a site becomes a
:class:`~repro_torch.core.MeasurementSession` (via :class:`CampaignSite` /
:func:`build_session`) and the engine schedules the Procedure-4 iterations.
``rank_sites`` ranks MANY sites as one interleaved campaign — persistable
(``save_path``), killable (``max_steps`` / ``deadline_s``) and resumable
(``resume_from``) without losing a single measurement.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Union

from repro_torch.core import (
    CostModelTimer,
    DiscriminantReport,
    ExperimentEngine,
    MeasurementSession,
    RankingResult,
    Timer,
    WallClockTimer,
    filter_candidates,
    flops_discriminant_test,
    initial_hypothesis_by_time,
)

from .variants import VariantSite


@dataclasses.dataclass
class TuneReport:
    site: str
    ranking: RankingResult
    discriminant: DiscriminantReport
    selected: str
    single_run_times: Dict[str, float]
    dropped: tuple
    wall_time_s: float
    backend: str

    def summary(self) -> str:
        lines = [f"site {self.site} [{self.backend}]"]
        for a in self.ranking.sequence:
            rf = self.discriminant.relative_flops.get(a.name, float("nan"))
            t = self.single_run_times.get(a.name, float("nan"))
            sel = " <= selected" if a.name == self.selected else ""
            lines.append(
                f"  rank {a.rank}  {a.name:24s} mr={a.mean_rank:.2f} "
                f"RF={rf:.2f} t1={t*1e3:.2f}ms{sel}"
            )
        lines.append(
            f"  FLOPs discriminant: "
            f"{'ANOMALY (' + self.discriminant.reason + ')' if self.discriminant.is_anomaly else 'valid'}"
        )
        return "\n".join(lines)


@dataclasses.dataclass
class CampaignSite:
    """A site prepared for an engine campaign: explicit measurement backend
    plus the analytic FLOP table the discriminant test needs. Produced from
    a :class:`VariantSite` by :func:`prepare_site` (wall-clock) or built
    directly around a simulated / cost-model timer."""

    name: str
    timer: Timer
    flops: Dict[str, float]
    initial_order: Optional[List[str]] = None
    single_run_times: Dict[str, float] = dataclasses.field(default_factory=dict)
    dropped: tuple = ()
    backend: str = "custom"
    #: Per-site measurement budget; None inherits the campaign default.
    max_measurements: Optional[int] = None


def prepare_site(
    site: VariantSite, *, seed: int = 0, rt_threshold: float = 1.5
) -> CampaignSite:
    """Paper Sec. I steps 1-4 on a variant site: warm runs, RT filtering,
    initial hypothesis by single-run time."""
    workloads = site.workloads(seed=seed, warmup=True)
    timer = WallClockTimer(workloads)
    single = {name: timer.measure(name) for name in workloads}
    flops = dict(site.flops_table())
    cand = filter_candidates(flops, single, rt_threshold=rt_threshold)
    h0 = [n for n in initial_hypothesis_by_time(single) if n in cand.names]
    return CampaignSite(
        name=site.name,
        timer=timer,
        flops=flops,
        initial_order=h0,
        single_run_times=single,
        dropped=cand.dropped,
        backend="wall-clock",
    )


def build_session(
    site: CampaignSite,
    *,
    m_per_iteration: int = 3,
    eps: float = 0.03,
    max_measurements: int = 30,
    quantile_ranges=None,
    shuffle_seed: Optional[int] = 0,
) -> MeasurementSession:
    """Turn a prepared site into an engine-schedulable session. The FLOP
    table, single-run times and filter decisions ride along in the session
    ``meta`` so reports survive engine save/load. A site-level
    ``max_measurements`` overrides the campaign default."""
    single = dict(site.single_run_times)
    order = site.initial_order
    if order is None:
        if not single:
            single = {name: site.timer.measure(name) for name in site.flops}
        order = initial_hypothesis_by_time(single)
    kwargs = {}
    if quantile_ranges is not None:
        kwargs["quantile_ranges"] = quantile_ranges
    return MeasurementSession(
        site.name,
        order,
        site.timer,
        m_per_iteration=m_per_iteration,
        eps=eps,
        max_measurements=(
            site.max_measurements
            if site.max_measurements is not None
            else max_measurements
        ),
        shuffle_seed=shuffle_seed,
        meta={
            "flops": site.flops,
            "single_run_times": single,
            "dropped": list(site.dropped),
            "backend": site.backend,
            "t_start": time.time(),
        },
        **kwargs,
    )


def report_from_session(
    session: MeasurementSession, measure_if_needed: bool = True
) -> TuneReport:
    """Full TuneReport (discriminant verdict + selection) from a session's
    current state — works mid-campaign (best-so-far ranks) and after
    ``ExperimentEngine.load``. With ``measure_if_needed=False`` the call is
    side-effect free (raises on a session with nothing to rank)."""
    meta = session.meta
    ranking = session.result(measure_if_needed=measure_if_needed)
    flops = {k: float(v) for k, v in meta.get("flops", {}).items()}
    discriminant = flops_discriminant_test(ranking, flops)
    t_start = float(meta.get("t_start", time.time()))
    return TuneReport(
        site=session.name,
        ranking=ranking,
        discriminant=discriminant,
        selected=_select(ranking, flops),
        single_run_times=dict(meta.get("single_run_times", {})),
        dropped=tuple(meta.get("dropped", ())),
        wall_time_s=time.time() - t_start,
        backend=str(meta.get("backend", "unknown")),
    )


def reports_from_engine(engine: ExperimentEngine) -> Dict[str, TuneReport]:
    """Best-so-far reports, strictly side-effect free: sessions that were
    never scheduled (no measurements to rank) are omitted rather than
    measured, so reading reports never perturbs a resumable campaign."""
    return {
        s.name: report_from_session(s, measure_if_needed=False)
        for s in engine.sessions
        if s.can_rank()
    }


def rank_site(
    site: VariantSite,
    *,
    seed: int = 0,
    m_per_iteration: int = 3,
    eps: float = 0.03,
    max_measurements: int = 30,
    rt_threshold: float = 1.5,
    quantile_ranges=None,
) -> TuneReport:
    """Wall-clock ranking of a variant site (paper-faithful pipeline)."""
    prepared = prepare_site(site, seed=seed, rt_threshold=rt_threshold)
    return rank_sites(
        [prepared],
        m_per_iteration=m_per_iteration,
        eps=eps,
        max_measurements=max_measurements,
        quantile_ranges=quantile_ranges,
    )[prepared.name]


def rank_site_costmodel(
    site_name: str,
    costs: Mapping[str, float],
    flops: Mapping[str, float],
    *,
    rel_sigma: float = 0.0,
    m_per_iteration: int = 3,
    eps: float = 0.03,
    max_measurements: int = 30,
) -> TuneReport:
    """Compile-time ranking from roofline-model costs (seconds/variant)."""
    timer = CostModelTimer(costs, rel_sigma=rel_sigma)
    single = {name: timer.measure(name) for name in costs}
    prepared = CampaignSite(
        name=site_name,
        timer=timer,
        flops=dict(flops),
        initial_order=initial_hypothesis_by_time(single),
        single_run_times=single,
        backend="cost-model",
    )
    return rank_sites(
        [prepared],
        m_per_iteration=m_per_iteration,
        eps=eps,
        max_measurements=max_measurements,
    )[site_name]


def rank_sites(
    sites: Sequence[Union[VariantSite, CampaignSite]] = (),
    *,
    seed: int = 0,
    m_per_iteration: int = 3,
    eps: float = 0.03,
    max_measurements: int = 30,
    rt_threshold: float = 1.5,
    quantile_ranges=None,
    policy: str = "round_robin",
    max_steps: Optional[int] = None,
    deadline_s: Optional[float] = None,
    save_path: Optional[str] = None,
    resume_from: Optional[str] = None,
    timers: Optional[Mapping[str, Timer]] = None,
) -> Dict[str, TuneReport]:
    """Rank many variant sites as ONE interleaved measurement campaign.

    Instead of running each site's Procedure-4 loop to convergence in turn,
    every site becomes a session in a shared :class:`ExperimentEngine`; the
    scheduler interleaves single iterations under ``policy``. The campaign
    can be bounded (``max_steps`` iterations, or a ``deadline_s`` wall-time
    budget), persisted (``save_path``) and later resumed exactly where it
    stopped (``resume_from``; pass ``timers`` to re-attach wall-clock
    backends). Reports are best-so-far when the campaign is interrupted;
    sites whose session was never scheduled are omitted from the dict.

    On resume the session parameters (m/eps/budget/quantiles) and the site
    list come from the saved state — combining ``resume_from`` with
    ``sites`` is rejected rather than silently ignoring the new sites.
    """
    if resume_from is not None:
        if sites:
            raise ValueError(
                "pass either sites or resume_from, not both: a resumed "
                "campaign's sites and tuning parameters come from the "
                "saved state"
            )
        engine = ExperimentEngine.load(resume_from, timers=timers)
        if deadline_s is not None:
            engine.deadline_s = deadline_s
    else:
        engine = ExperimentEngine(policy=policy, deadline_s=deadline_s)
        for site in sites:
            prepared = (
                site
                if isinstance(site, CampaignSite)
                else prepare_site(site, seed=seed, rt_threshold=rt_threshold)
            )
            engine.add_session(
                build_session(
                    prepared,
                    m_per_iteration=m_per_iteration,
                    eps=eps,
                    max_measurements=max_measurements,
                    quantile_ranges=quantile_ranges,
                )
            )
    try:
        engine.run(max_steps=max_steps)
    finally:
        # persist even on an interrupt mid-campaign so resume loses nothing
        if save_path is not None:
            engine.save(save_path)
    return reports_from_engine(engine)


def _select(ranking: RankingResult, flops: Mapping[str, float]) -> str:
    """Best performance class; ties broken by min FLOPs then mean rank."""
    best = ranking.best_class()
    return min(
        best,
        key=lambda n: (flops.get(n, float("inf")), ranking.mean_ranks.get(n, 0.0)),
    )
