"""Fault tolerance: failure detection, straggler mitigation, elastic events
(a copy of the reference's ``train/ft.py``: pure Python).

Single-host container: the cluster membership layer is driven by an
injectable clock + event source so every policy is unit-testable. On a real
deployment the heartbeats come from the coordination service (GCS / etcd /
torch.distributed); the policies below are the part that must be correct.

* :class:`FailureDetector` — heartbeat timeouts -> dead-host set; a change
  in the healthy set emits a :class:`MembershipEvent` (elastic re-mesh).
* :class:`StragglerMonitor` — per-host step durations; hosts slower than
  ``threshold x`` rolling median for ``patience`` consecutive steps are
  flagged. Mitigation at this layer: (a) deterministic data ownership means
  reassigning a straggler's shard is a pure row-range remap (no data
  motion), (b) persistent stragglers are evicted via a MembershipEvent
  (cheaper than letting every collective wait on them — the
  Hoefler/Lumsdaine noise-amplification argument, paper's ref [7]).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence, Set


@dataclasses.dataclass(frozen=True)
class MembershipEvent:
    step: int
    healthy: tuple   # tuple[int, ...]
    removed: tuple
    added: tuple
    reason: str


class FailureDetector:
    def __init__(
        self,
        hosts: Sequence[int],
        timeout_s: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self._timeout = timeout_s
        self._clock = clock
        now = clock()
        self._last_seen: Dict[int, float] = {h: now for h in hosts}
        self._healthy: Set[int] = set(hosts)

    def heartbeat(self, host: int) -> None:
        self._last_seen[host] = self._clock()

    def join(self, host: int) -> None:
        """Announce a (re)joining host; promoted to healthy by check()."""
        self._last_seen[host] = self._clock()
        self._healthy.discard(host)

    def check(self, step: int) -> Optional[MembershipEvent]:
        now = self._clock()
        dead = {
            h for h in self._healthy if now - self._last_seen[h] > self._timeout
        }
        joined = {
            h for h in self._last_seen
            if h not in self._healthy and now - self._last_seen[h] <= self._timeout
        }
        if not dead and not joined:
            return None
        self._healthy = (self._healthy - dead) | joined
        return MembershipEvent(
            step=step,
            healthy=tuple(sorted(self._healthy)),
            removed=tuple(sorted(dead)),
            added=tuple(sorted(joined)),
            reason="heartbeat-timeout" if dead else "join",
        )

    @property
    def healthy(self) -> Set[int]:
        return set(self._healthy)


class StragglerMonitor:
    def __init__(
        self,
        hosts: Sequence[int],
        threshold: float = 1.5,
        patience: int = 3,
        window: int = 16,
    ) -> None:
        self._threshold = threshold
        self._patience = patience
        self._durations: Dict[int, Deque[float]] = {
            h: deque(maxlen=window) for h in hosts
        }
        self._strikes: Dict[int, int] = {h: 0 for h in hosts}

    def record(self, host: int, duration_s: float) -> None:
        if host not in self._durations:
            self._durations[host] = deque(maxlen=16)
            self._strikes[host] = 0
        self._durations[host].append(duration_s)

    def _medians(self) -> Dict[int, float]:
        meds = {}
        for h, d in self._durations.items():
            if d:
                s = sorted(d)
                meds[h] = s[len(s) // 2]
        return meds

    def check(self) -> List[int]:
        """Hosts flagged as persistent stragglers this round."""
        meds = self._medians()
        if len(meds) < 2:
            return []
        global_median = sorted(meds.values())[len(meds) // 2]
        flagged = []
        for h, m in meds.items():
            if m > self._threshold * global_median:
                self._strikes[h] += 1
                if self._strikes[h] >= self._patience:
                    flagged.append(h)
            else:
                self._strikes[h] = 0
        return flagged


def reassign_shards(
    healthy_hosts: Sequence[int], num_shards: int
) -> Dict[int, List[int]]:
    """Deterministic shard ownership for the current membership.

    Shards are dealt round-robin over the sorted healthy hosts; with the
    deterministic data pipeline this is the complete straggler/failure data
    story — no state migrates, the mapping IS the recovery.
    """
    hosts = sorted(healthy_hosts)
    table: Dict[int, List[int]] = {h: [] for h in hosts}
    for s in range(num_shards):
        table[hosts[s % len(hosts)]].append(s)
    return table
