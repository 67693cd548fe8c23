"""ExperimentEngine — schedulable pools of measurement sessions.

ELAPS-style separation of experiment *specification* (a
:class:`~repro_torch.core.session.MeasurementSession` per expression instance)
from *execution* (this scheduler) and *storage* (JSON persistence). The
engine owns many sessions and interleaves single Procedure-4 iterations
across them under a pluggable policy:

* ``round_robin`` — fair cycling; every pending session advances in turn.
* ``least_converged_first`` — always step the session farthest from
  convergence (largest ``||dx - dy||/p``; unstarted sessions first). Spends
  the measurement budget where the rank landscape is still moving.
* ``until_deadline`` — least-converged ordering under a mandatory wall-time
  budget (``deadline_s``): the campaign stops scheduling when the budget is
  spent, whatever each session's state; results report best-so-far ranks.

``save()``/``load()`` persist every session's measurement store, iteration
history, convergence state and (for simulated / cost-model backends) timer
RNG state — a killed campaign resumes bit-identical to an uninterrupted
run. Wall-clock campaigns resume by re-attaching workloads via the
``timers=``/``workloads=`` arguments of :meth:`ExperimentEngine.load`.

Each session carries its own batched quantile table across the campaign
(see :class:`~repro_torch.core.comparison.QuantileTable`): interleaving does not
discard analysis work, because the table keys on the session store's
version counter and only the stepped session's store mutates.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, Iterator, List, Mapping, Optional, Tuple

from .measure import Timer
from .session import MeasurementSession
from .types import IterationRecord, RankingResult

#: Scheduling policies understood by :class:`ExperimentEngine`.
POLICIES = ("round_robin", "least_converged_first", "until_deadline")


class ExperimentEngine:
    """A campaign: many sessions, one scheduler, one persistence root."""

    def __init__(
        self,
        policy: str = "round_robin",
        deadline_s: Optional[float] = None,
    ) -> None:
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; expected one of {POLICIES}")
        self.policy = policy
        self.deadline_s = deadline_s
        self.steps_taken = 0
        self._sessions: Dict[str, MeasurementSession] = {}
        self._cursor = 0  # round-robin position
        self._started_at: Optional[float] = None

    # --------------------------------------------------------- sessions ---

    def add_session(self, session: MeasurementSession) -> MeasurementSession:
        if session.name in self._sessions:
            raise ValueError(f"duplicate session name {session.name!r}")
        self._sessions[session.name] = session
        return session

    def session(self, name: str) -> MeasurementSession:
        return self._sessions[name]

    @property
    def sessions(self) -> Tuple[MeasurementSession, ...]:
        return tuple(self._sessions.values())

    @property
    def session_names(self) -> List[str]:
        return list(self._sessions)

    def __len__(self) -> int:
        return len(self._sessions)

    def __contains__(self, name: str) -> bool:
        return name in self._sessions

    def __iter__(self) -> Iterator[MeasurementSession]:
        return iter(self.sessions)

    def pending(self) -> List[MeasurementSession]:
        return [s for s in self._sessions.values() if not s.done]

    @property
    def done(self) -> bool:
        return not self.pending()

    # -------------------------------------------------------- scheduling ---

    def _budget_exhausted(self) -> bool:
        if self.deadline_s is None or self._started_at is None:
            return False
        return (time.monotonic() - self._started_at) >= self.deadline_s

    def _select(self) -> Optional[MeasurementSession]:
        names = list(self._sessions)
        if not names:
            return None
        if self.policy == "round_robin":
            k = len(names)
            for i in range(k):
                idx = (self._cursor + i) % k
                s = self._sessions[names[idx]]
                if not s.done:
                    self._cursor = (idx + 1) % k
                    return s
            return None
        # least_converged_first / until_deadline: farthest from convergence
        # (norm is inf before a session's first iteration, so fresh sessions
        # are scheduled before any refinement happens).
        pend = self.pending()
        if not pend:
            return None
        return max(pend, key=lambda s: s.norm)

    def step(self) -> Optional[Tuple[str, IterationRecord]]:
        """One scheduling decision: pick a session, run one iteration.
        Returns ``(session_name, iteration_record)`` or ``None`` when the
        campaign is finished (or its time budget is spent)."""
        if self._started_at is None:
            self._started_at = time.monotonic()
        if self._budget_exhausted():
            return None
        session = self._select()
        if session is None:
            return None
        rec = session.step()
        if rec is None:  # defensive: session raced to done
            return None
        self.steps_taken += 1
        return session.name, rec

    def run(
        self,
        max_steps: Optional[int] = None,
        deadline_s: Optional[float] = None,
    ) -> Dict[str, RankingResult]:
        """Drive the campaign until done / ``max_steps`` / the deadline."""
        if deadline_s is not None:
            self.deadline_s = deadline_s
        if self.policy == "until_deadline" and self.deadline_s is None:
            raise ValueError("until_deadline policy requires deadline_s")
        self._started_at = time.monotonic()
        steps = 0
        while max_steps is None or steps < max_steps:
            if self.step() is None:
                break
            steps += 1
        return self.results()

    def results(self) -> Dict[str, RankingResult]:
        """Best-so-far rankings, strictly side-effect free: sessions that
        were never scheduled (no measurements yet) are omitted rather than
        measured, so reading results never perturbs a resumable campaign."""
        return {
            name: s.result(measure_if_needed=False)
            for name, s in self._sessions.items()
            if s.can_rank()
        }

    # ------------------------------------------------------- persistence ---

    def to_dict(self, include_timers: bool = True) -> Dict[str, Any]:
        return {
            "version": 1,
            "policy": self.policy,
            "deadline_s": self.deadline_s,
            "steps_taken": self.steps_taken,
            "cursor": self._cursor,
            "sessions": [
                s.to_dict(include_timer=include_timers)
                for s in self._sessions.values()
            ],
        }

    def save(self, path: str, include_timers: bool = True) -> str:
        """Atomically persist the whole campaign to JSON."""
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(self.to_dict(include_timers=include_timers), fh, indent=1)
        os.replace(tmp, path)
        return path

    @classmethod
    def from_dict(
        cls,
        d: Mapping[str, Any],
        timers: Optional[Mapping[str, Timer]] = None,
        workloads: Optional[Mapping[str, Mapping[str, Callable[[], object]]]] = None,
        vectorized: bool = True,
    ) -> "ExperimentEngine":
        engine = cls(policy=d["policy"], deadline_s=d.get("deadline_s"))
        engine.steps_taken = int(d.get("steps_taken", 0))
        engine._cursor = int(d.get("cursor", 0))
        timers = timers or {}
        workloads = workloads or {}
        for sd in d["sessions"]:
            name = sd["name"]
            engine.add_session(
                MeasurementSession.from_dict(
                    sd,
                    timer=timers.get(name),
                    workloads=workloads.get(name),
                    vectorized=vectorized,
                )
            )
        return engine

    @classmethod
    def load(
        cls,
        path: str,
        timers: Optional[Mapping[str, Timer]] = None,
        workloads: Optional[Mapping[str, Mapping[str, Callable[[], object]]]] = None,
        vectorized: bool = True,
    ) -> "ExperimentEngine":
        """Resume a campaign. ``timers`` maps session name -> Timer for
        backends that do not serialize (wall-clock); ``workloads`` maps
        session name -> {algorithm: thunk} as a convenience for the same.
        ``vectorized`` picks the analysis path for the resumed sessions —
        a process choice, not campaign state; both settings resume any
        saved campaign bit-identically."""
        with open(path) as fh:
            d = json.load(fh)
        return cls.from_dict(d, timers=timers, workloads=workloads,
                             vectorized=vectorized)
