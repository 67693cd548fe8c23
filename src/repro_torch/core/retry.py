"""Bounded exponential backoff with seeded jitter — graceful degradation.

The distributed census runs on shared, messy filesystems: an append can
hit a transient ``EIO``/``ESTALE``, a lease create can collide with a
dozen hosts waking at once. The policy here is deliberately boring and
*bounded* — a worker either recovers within ``attempts`` tries or gives
the error back to a layer that can re-enqueue the work; nothing retries
forever, and nothing sleeps unjittered (synchronized retry storms are how
one NFS hiccup becomes a thundering herd).

Jitter is **seeded**: two workers derive different-but-reproducible delay
sequences from their owner tokens, so contention tests (N threads racing
one lease) are deterministic test cases, not timing lotteries.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple, Type, TypeVar

T = TypeVar("T")


@dataclass(frozen=True)
class RetryPolicy:
    """``attempts`` total tries; sleep ``min(cap, base * 2**k)`` scaled by
    ``1 + U(0, jitter)`` between them."""

    attempts: int = 5
    base: float = 0.05
    cap: float = 2.0
    jitter: float = 0.5

    def __post_init__(self) -> None:
        if self.attempts < 1:
            raise ValueError("attempts must be >= 1")
        if self.base < 0 or self.cap < 0 or self.jitter < 0:
            raise ValueError("base/cap/jitter must be >= 0")

    def delays(self, seed: Optional[object] = None) -> List[float]:
        """The ``attempts - 1`` sleeps this policy would take, jittered by
        an RNG seeded from ``seed`` (reproducible per worker token)."""
        rng = random.Random(None if seed is None else str(seed))
        return [
            min(self.cap, self.base * (2.0 ** k)) * (1.0 + rng.random() * self.jitter)
            for k in range(self.attempts - 1)
        ]


#: Store IO (appends, manifest rewrites): a few quick tries, fail fast —
#: the work queue re-enqueues the shard if the filesystem stays broken.
STORE_IO_POLICY = RetryPolicy(attempts=3, base=0.02, cap=0.5)
#: Lease acquisition: slightly longer tail, contention is expected.
LEASE_POLICY = RetryPolicy(attempts=5, base=0.02, cap=0.5)


def with_retries(
    fn: Callable[[], T],
    *,
    policy: RetryPolicy = STORE_IO_POLICY,
    retry_on: Tuple[Type[BaseException], ...] = (OSError,),
    seed: Optional[object] = None,
    describe: str = "operation",
    on_retry: Optional[Callable[[int, BaseException, float], None]] = None,
    sleep: Callable[[float], None] = time.sleep,
) -> T:
    """Run ``fn`` with bounded, jittered retries on ``retry_on`` errors.

    The last failure propagates unwrapped once attempts are exhausted —
    callers see the real exception, annotated by ``on_retry`` logs rather
    than a new wrapper type. ``sleep`` is injectable for tests."""
    delays = policy.delays(seed)
    for attempt in range(policy.attempts):
        try:
            return fn()
        except retry_on as err:
            if attempt >= policy.attempts - 1:
                raise
            delay = delays[attempt]
            if on_retry is not None:
                on_retry(attempt + 1, err, delay)
            if delay > 0:
                sleep(delay)
    raise AssertionError(f"unreachable: {describe}")  # pragma: no cover
