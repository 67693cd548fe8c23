"""Deterministic fault injection — every failure mode a reproducible test.

A census that survives SIGKILL in CI only by luck is not fault-tolerant; it
is untested. This module turns the failure modes the distributed census
must survive — torn partial appends, mid-file byte corruption, dropped
fsyncs, lease-heartbeat stalls, worker kills, transient IO errors — into a
**scheduled, seeded plan** that fires at named injection *sites* on exact
hit counts, so a chaos run is a test case you can re-run, not a CI flake
you hope reproduces.

Sites (where the plumbing consults the plan):

``store.append``
    :meth:`repro_torch.core.sweep.ShardStore.append_records`, once per record
    batch. Ops: ``torn_write`` (commit only a prefix of the batch, then
    crash), ``corrupt_byte`` (flip one byte of an *earlier, committed*
    record — bitrot), ``io_error`` (one transient ``OSError`` — exercises
    the retry path).
``store.fsync``
    the fsync call of a record batch. Op: ``drop_fsync`` (skip it — the
    power-loss window).
``campaign.step``
    every engine step of :func:`repro_torch.core.sweep.run_chunked_campaign`.
    Ops: ``sigkill`` (the worker dies mid-campaign, lease left behind),
    ``stall`` (a GC/NFS-style pause).
``lease.heartbeat``
    every :meth:`repro_torch.core.lease.Lease.heartbeat` call. Op: ``stall``
    (sleep past the TTL so another host steals the shard — the
    duplicate-takeover race).
``lease.acquire``
    inside :func:`repro_torch.core.lease.acquire_lease`. Op: ``io_error``.

Scheduling: each process counts its own hits per site; a fault is *due*
once the counter reaches its ``at``. Whether it then *fires* is decided by
a claim — an ``O_EXCL`` file create in the plan's scoreboard directory —
so across any number of worker processes each fault fires **exactly
once**, and a crashed-and-resumed chaos drain does not re-fire faults it
already delivered. Single-process plans (unit tests) use an in-memory
scoreboard and are fully deterministic. Randomness (which byte to
corrupt) comes from a per-fault RNG seeded by ``(plan seed, fault id)``.

Workers pick a plan up from the environment (``REPRO_FAULT_PLAN`` = path
to a plan JSON) via :func:`active_plan`, so the same injection reaches
every subprocess of a multi-host drain without threading a flag through
every CLI. No env var, no plan, zero overhead — the production path never
pays for chaos it did not ask for.
"""

from __future__ import annotations

import json
import os
import random
import signal
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence

#: Environment variable naming a fault-plan JSON file for this process
#: (and, transitively, every worker subprocess it spawns).
PLAN_ENV = "REPRO_FAULT_PLAN"

#: Every site the plumbing consults.
SITES = (
    "store.append", "store.fsync", "campaign.step",
    "lease.heartbeat", "lease.acquire",
)

#: Ops with generic semantics (performed by :meth:`FaultPlan.poke`); the
#: site-specific ops (torn_write / corrupt_byte / drop_fsync) are executed
#: by the site itself, which owns the file handles involved.
GENERIC_OPS = ("sigkill", "stall", "io_error")
OPS = GENERIC_OPS + ("torn_write", "corrupt_byte", "drop_fsync")


class InjectedFault(RuntimeError):
    """An injected crash. Deliberately NOT caught anywhere in the stack —
    it must take the worker down exactly like the real failure would."""


@dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: fire ``op`` at the ``at``-th hit of ``site``."""

    site: str
    op: str
    at: int            #: 1-based process-local hit count that arms the fault
    arg: float = 0.0   #: op-specific (stall seconds; torn-write keep-fraction)
    id: str = ""       #: unique within the plan (scoreboard key)

    def __post_init__(self) -> None:
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; one of {SITES}")
        if self.op not in OPS:
            raise ValueError(f"unknown fault op {self.op!r}; one of {OPS}")
        if self.at < 1:
            raise ValueError("fault 'at' is a 1-based hit count (>= 1)")


class FaultPlan:
    """A seeded schedule of faults plus the exactly-once claim machinery.

    ``state_dir`` (optional) makes claims durable and cross-process: a
    fault is claimed by atomically creating ``<state_dir>/<fault id>``.
    Without it, claims live in this process only — the unit-test mode.
    """

    def __init__(self, faults: Sequence[FaultSpec], seed: int = 0,
                 state_dir: Optional[str] = None) -> None:
        specs: List[FaultSpec] = []
        seen_ids = set()
        for i, f in enumerate(faults):
            fid = f.id or f"f{i:02d}-{f.site}-{f.op}-at{f.at}"
            if fid in seen_ids:
                raise ValueError(f"duplicate fault id {fid!r}")
            seen_ids.add(fid)
            specs.append(FaultSpec(f.site, f.op, f.at, f.arg, fid))
        self.faults = tuple(specs)
        self.seed = int(seed)
        self.state_dir = state_dir
        self._hits: Dict[str, int] = {}
        self._claimed: set = set()
        if state_dir:
            os.makedirs(state_dir, exist_ok=True)

    # ------------------------------------------------------- scheduling ---

    def due(self, site: str) -> List[FaultSpec]:
        """Count one hit at ``site``; return the faults now armed there
        (hit count reached, not yet claimed). The caller must
        :meth:`claim` each one it actually executes — a fault whose
        precondition is unmet (e.g. nothing committed yet to corrupt)
        stays armed for the next hit."""
        n = self._hits.get(site, 0) + 1
        self._hits[site] = n
        return [
            f for f in self.faults
            if f.site == site and n >= f.at and not self._is_claimed(f)
        ]

    def _is_claimed(self, spec: FaultSpec) -> bool:
        if spec.id in self._claimed:
            return True
        if self.state_dir:
            return os.path.exists(os.path.join(self.state_dir, spec.id))
        return False

    def claim(self, spec: FaultSpec) -> bool:
        """Atomically claim ``spec`` for this process. Exactly one claimer
        across every process sharing ``state_dir`` wins; the fault fires
        only in the winner."""
        if spec.id in self._claimed:
            return False
        if self.state_dir:
            try:
                fd = os.open(os.path.join(self.state_dir, spec.id),
                             os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                self._claimed.add(spec.id)
                return False
            os.close(fd)
        self._claimed.add(spec.id)
        return True

    def fired(self) -> List[str]:
        """Ids of every fault claimed so far (all processes, when durable)."""
        if self.state_dir:
            try:
                return sorted(os.listdir(self.state_dir))
            except OSError:
                return []
        return sorted(self._claimed)

    def rng(self, spec: FaultSpec) -> random.Random:
        """The fault's private RNG — a pure function of (plan seed, id),
        so a re-run corrupts the same byte."""
        return random.Random(f"{self.seed}:{spec.id}")

    # -------------------------------------------------------- execution ---

    def perform(self, spec: FaultSpec) -> None:
        """Execute a generic op (``sigkill`` / ``stall`` / ``io_error``)."""
        if spec.op == "sigkill":
            os.kill(os.getpid(), signal.SIGKILL)
        elif spec.op == "stall":
            time.sleep(spec.arg or 1.0)
        elif spec.op == "io_error":
            raise OSError(f"injected io_error at {spec.site} ({spec.id})")
        else:
            raise ValueError(f"op {spec.op!r} is site-specific, not generic")

    def poke(self, site: str) -> List[FaultSpec]:
        """Hit ``site``: claim-and-perform every due generic fault, return
        the due *site-specific* ones for the caller to execute (after
        claiming). This is the one-liner the plumbing calls."""
        custom: List[FaultSpec] = []
        for spec in self.due(site):
            if spec.op in GENERIC_OPS:
                if self.claim(spec):
                    self.perform(spec)
            else:
                custom.append(spec)
        return custom

    # ------------------------------------------------------ persistence ---

    def to_dict(self) -> Dict[str, Any]:
        return {
            "seed": self.seed,
            "faults": [
                {"site": f.site, "op": f.op, "at": f.at, "arg": f.arg,
                 "id": f.id}
                for f in self.faults
            ],
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any],
                  state_dir: Optional[str] = None) -> "FaultPlan":
        faults = [
            FaultSpec(
                site=str(f["site"]), op=str(f["op"]), at=int(f["at"]),
                arg=float(f.get("arg", 0.0)), id=str(f.get("id", "")),
            )
            for f in d.get("faults", ())
        ]
        return cls(faults, seed=int(d.get("seed", 0)), state_dir=state_dir)

    def save(self, path: str) -> str:
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(self.to_dict(), fh, indent=1, sort_keys=True)
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, path: str, state_dir: Optional[str] = None) -> "FaultPlan":
        """Load a plan file. The default scoreboard lives NEXT TO the plan
        (``<path>.fired/``) so every process naming the same plan file
        shares one exactly-once ledger."""
        with open(path) as fh:
            d = json.load(fh)
        if state_dir is None:
            state_dir = path + ".fired"
        return cls.from_dict(d, state_dir=state_dir)


_active: Optional[FaultPlan] = None
_active_src: Optional[str] = None


def active_plan() -> Optional[FaultPlan]:
    """The process-wide plan named by ``$REPRO_FAULT_PLAN``, or None.
    Loaded once per process (workers are short-lived; the scoreboard, not
    this cache, carries cross-process state)."""
    global _active, _active_src
    src = os.environ.get(PLAN_ENV) or None
    if src != _active_src:
        _active_src = src
        _active = FaultPlan.load(src) if src else None
    return _active
