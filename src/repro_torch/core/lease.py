"""Filesystem leases — the pull-based work queue's mutual-exclusion layer.

A census (or explanation campaign) stored under one shared directory is
drained by any number of *hosts*: each host repeatedly picks an unfinished
shard, takes its **lease**, and drives it with the existing resumable
chunk/save/append machinery (:func:`repro_torch.core.sweep.run_chunked_campaign`).
The lease protocol is deliberately tiny — one JSON file per shard on the
shared filesystem, no server, no sockets — because the hard part
(recovering a half-done shard byte-identically) is already solved by the
kill/resume contract: a lease takeover IS a resume.

Protocol (``shard-NNNN.lease.json`` next to the shard's JSONL):

* **Acquire** — atomic ``O_CREAT | O_EXCL`` create. Exactly one host wins;
  the file body records the owner token, acquisition time, last heartbeat
  and TTL.
* **Heartbeat** — the owner periodically rewrites the file (atomic
  tmp + rename), rate-limited to ``interval`` seconds. A heartbeat first
  re-reads the file and raises :class:`LeaseLost` if another owner took
  over — the losing host must stop writing to the shard immediately.
* **Expiry / takeover** — a lease whose heartbeat is older than ``ttl``
  seconds is *dead* (SIGKILLed host, lost VM, wedged process). A taker
  breaks it by renaming the stale file to a unique name (exactly one
  concurrent taker wins the rename) and then acquiring freshly. The new
  owner resumes the shard from its persisted engine state, so the merged
  result is byte-identical to an uninterrupted run (deterministic
  backends).
* **Release** — the owner removes the file (only if it still owns it).

Failure-model fine print: clocks across hosts must agree to well within
``ttl`` (the default 30 s tolerates ordinary NTP skew); a *live* host that
stalls longer than ``ttl`` (GC pause, NFS hiccup) can lose its lease to a
taker — it finds out at its next heartbeat (``LeaseLost``) and abandons
the shard, and because record appends are guarded by a heartbeat the
stale host never commits records after the takeover window closes.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import time
import uuid
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple

from .faults import FaultPlan, active_plan
from .retry import LEASE_POLICY, RetryPolicy, with_retries

log = logging.getLogger(__name__)

#: Default seconds without a heartbeat before a lease counts as dead.
DEFAULT_TTL = 30.0
#: Default seconds between heartbeat file rewrites (must be << ttl).
DEFAULT_HEARTBEAT_INTERVAL = 5.0

#: States :func:`read_lease_ex` distinguishes.
LEASE_ABSENT = "absent"      #: no lease file
LEASE_OK = "ok"              #: well-formed lease file
LEASE_CORRUPT = "corrupt"    #: file exists but does not decode to a lease


class LeaseLost(RuntimeError):
    """The shard's lease is no longer ours — stop writing, move on."""


def default_owner() -> str:
    """A token unique per worker process: host, pid, and a random tail
    (two workers on one host — the CI simulation — must not collide)."""
    return f"{socket.gethostname()}:{os.getpid()}:{uuid.uuid4().hex[:8]}"


@dataclass(frozen=True)
class LeaseInfo:
    """A lease file's decoded contents (whoever owns it)."""

    owner: str
    acquired_at: float
    heartbeat_at: float
    ttl: float

    def age(self, now: Optional[float] = None) -> float:
        """Seconds since the last heartbeat."""
        return (time.time() if now is None else now) - self.heartbeat_at

    def expired(self, now: Optional[float] = None) -> bool:
        return self.age(now) > self.ttl

    def to_dict(self) -> Dict[str, Any]:
        return {
            "owner": self.owner,
            "acquired_at": self.acquired_at,
            "heartbeat_at": self.heartbeat_at,
            "ttl": self.ttl,
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "LeaseInfo":
        return cls(
            owner=str(d["owner"]),
            acquired_at=float(d["acquired_at"]),
            heartbeat_at=float(d["heartbeat_at"]),
            ttl=float(d["ttl"]),
        )


def read_lease_ex(path: str) -> Tuple[Optional[LeaseInfo], str]:
    """The lease at ``path`` plus what we found: ``(info, "ok")``,
    ``(None, "absent")``, or ``(None, "corrupt")`` for a file that exists
    but does not decode to a lease — a torn/half-written file (possible
    only on filesystems without atomic rename) or bitrot. Corrupt is a
    distinct state because a corrupt lease carries no heartbeat: it can
    never expire on its own, so the steal path must treat it as
    stale-equivalent rather than wait on a TTL that will never tick."""
    try:
        with open(path) as fh:
            raw = fh.read()
    except FileNotFoundError:
        return None, LEASE_ABSENT
    except OSError:
        return None, LEASE_CORRUPT
    try:
        return LeaseInfo.from_dict(json.loads(raw)), LEASE_OK
    except (ValueError, KeyError, TypeError):
        return None, LEASE_CORRUPT


def read_lease(path: str) -> Optional[LeaseInfo]:
    """The lease at ``path``, or None when absent or unreadable (see
    :func:`read_lease_ex` for the three-way classification)."""
    return read_lease_ex(path)[0]


def _write_lease_file(path: str, info: LeaseInfo, *, exclusive: bool) -> None:
    tmp = f"{path}.tmp.{uuid.uuid4().hex[:8]}"
    with open(tmp, "w") as fh:
        json.dump(info.to_dict(), fh)
        fh.flush()
        os.fsync(fh.fileno())
    if exclusive:
        # link(2), not O_EXCL-then-write: the lease must appear with its
        # full contents atomically, or a racing reader sees a created-but-
        # empty file, classifies it corrupt, breaks it, and two acquirers
        # both win. link fails with FileExistsError exactly like O_EXCL.
        try:
            os.link(tmp, path)
        finally:
            os.remove(tmp)
    else:
        os.replace(tmp, path)


def _break_stale(path: str) -> None:
    """Remove a dead lease so the caller may retry an exclusive create.
    Breaking races with other takers: the rename succeeds for exactly one
    of them (the others get ENOENT and simply retry acquisition)."""
    grave = f"{path}.stale.{uuid.uuid4().hex[:8]}"
    try:
        os.rename(path, grave)
    except OSError:
        return  # somebody else broke (or the owner released) it first
    try:
        os.remove(grave)
    except OSError:
        pass


class Lease:
    """A HELD lease: heartbeat it while working, release it when done."""

    def __init__(self, path: str, info: LeaseInfo,
                 interval: float = DEFAULT_HEARTBEAT_INTERVAL,
                 faults: Optional[FaultPlan] = None) -> None:
        self.path = path
        self.owner = info.owner
        self.ttl = info.ttl
        self.interval = interval
        self.faults = faults if faults is not None else active_plan()
        self._last_beat = info.heartbeat_at

    def heartbeat(self, force: bool = False) -> None:
        """Refresh the lease file (rate-limited to ``interval`` seconds;
        ``force=True`` beats immediately — used right before record
        appends so a takeover can never interleave with a commit).

        Raises :class:`LeaseLost` when the file is gone or another owner
        holds it — the caller must abandon the shard without writing.
        """
        now = time.time()
        if not force and now - self._last_beat < self.interval:
            return
        if self.faults is not None:
            # a 'stall' here sleeps past the TTL *before* the ownership
            # re-check — the duplicate-takeover race, made schedulable
            self.faults.poke("lease.heartbeat")
        current = read_lease(self.path)
        if current is None or current.owner != self.owner:
            raise LeaseLost(
                f"lease {self.path} now belongs to "
                f"{current.owner if current else 'nobody'}"
            )
        _write_lease_file(
            self.path,
            LeaseInfo(self.owner, current.acquired_at, now, self.ttl),
            exclusive=False,
        )
        self._last_beat = now

    def release(self) -> None:
        """Drop the lease (no-op if it was already lost/taken over)."""
        current = read_lease(self.path)
        if current is not None and current.owner == self.owner:
            try:
                os.remove(self.path)
            except OSError:
                pass


def acquire_lease(
    path: str,
    owner: Optional[str] = None,
    *,
    ttl: float = DEFAULT_TTL,
    interval: float = DEFAULT_HEARTBEAT_INTERVAL,
    faults: Optional[FaultPlan] = None,
) -> Optional[Lease]:
    """Try to take the lease at ``path``. Returns a held :class:`Lease`,
    or None when a live owner holds it. A dead lease (heartbeat older than
    its recorded TTL) is broken and re-acquired in the same call, and a
    **corrupt** lease file (half-written JSON — it carries no heartbeat,
    so it would block the shard forever) is treated as stale-equivalent:
    broken immediately, with a warning logged."""
    owner = owner or default_owner()
    if faults is None:
        faults = active_plan()
    for _ in range(2):  # second pass: after breaking a stale lease
        if faults is not None:
            faults.poke("lease.acquire")  # 'io_error' → transient OSError
        now = time.time()
        info = LeaseInfo(owner=owner, acquired_at=now, heartbeat_at=now,
                         ttl=float(ttl))
        try:
            _write_lease_file(path, info, exclusive=True)
            return Lease(path, info, interval=interval, faults=faults)
        except FileExistsError:
            pass
        current, state = read_lease_ex(path)
        if state == LEASE_CORRUPT:
            log.warning(
                "lease %s is corrupt (half-written JSON) — treating as "
                "stale and stealing it", path,
            )
        elif current is not None and not current.expired():
            return None  # a live owner holds it
        # dead, corrupt, or released-under-us: break it, then retry once
        _break_stale(path)
    return None


def acquire_lease_with_backoff(
    path: str,
    owner: Optional[str] = None,
    *,
    ttl: float = DEFAULT_TTL,
    interval: float = DEFAULT_HEARTBEAT_INTERVAL,
    policy: RetryPolicy = LEASE_POLICY,
    faults: Optional[FaultPlan] = None,
) -> Optional[Lease]:
    """:func:`acquire_lease` wrapped in bounded, jitter-seeded retries.

    Retries cover *transient IO errors* (the shared filesystem hiccuped)
    AND contention losses (someone else holds a live lease): under a
    thundering herd every loser backs off on its own owner-seeded jitter
    schedule, so N hosts waking together do not re-collide in lockstep.
    Returns None once attempts are exhausted — the drain loop treats that
    exactly like a held lease and moves to the next shard."""
    owner = owner or default_owner()

    def attempt() -> Lease:
        got = acquire_lease(path, owner, ttl=ttl, interval=interval,
                            faults=faults)
        if got is None:
            raise _LeaseHeld(path)
        return got

    try:
        return with_retries(
            attempt,
            policy=policy,
            retry_on=(OSError, _LeaseHeld),
            seed=f"lease:{owner}:{path}",
            describe=f"acquire {path}",
            on_retry=lambda n, err, delay: log.debug(
                "lease %s attempt %d failed (%s); retrying in %.3fs",
                path, n, err, delay,
            ),
        )
    except _LeaseHeld:
        return None
    except OSError:
        log.warning("lease %s: acquisition kept failing with IO errors; "
                    "leaving the shard for another pass", path)
        return None


class _LeaseHeld(Exception):
    """Internal: someone else holds a live lease (retryable loss)."""
