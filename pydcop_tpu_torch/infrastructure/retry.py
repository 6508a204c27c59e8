"""Retry policies: exponential backoff with jitter and attempt/deadline caps.

The port's own copy of ``pydcop_tpu/infrastructure/retry.py``, unchanged:
the fleet collector's in-sweep scrape retry and the router's forwards
take a :class:`RetryPolicy`, so operators tune attempts, backoff shape and
total budget, and a pinned ``seed`` draws the same jitter schedule in
either package.

Jitter modes (AWS architecture-blog taxonomy):

- ``full``: sleep ~ U(0, backoff) — best collision avoidance, the
  default.
- ``equal``: sleep ~ backoff/2 + U(0, backoff/2) — bounded below, for
  callers that must guarantee a minimum spacing.
- ``none``: sleep = backoff exactly — deterministic, for tests.

Stdlib only: the host-only ``fleet`` and ``router`` verbs import it.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Optional

__all__ = ["RetryPolicy"]

_JITTER_MODES = ("full", "equal", "none")


@dataclass
class RetryPolicy:
    """Backoff schedule for retried operations.

    ``max_attempts`` counts the first try: 3 means one try + two
    retries.  ``deadline`` (seconds) caps the whole operation including
    sleeps — :meth:`start` + :meth:`sleep_before_retry` enforce it.
    ``seed`` pins the jitter PRNG for reproducible schedules."""

    max_attempts: int = 3
    base_delay: float = 0.1
    max_delay: float = 2.0
    deadline: Optional[float] = None
    jitter: str = "full"
    seed: Optional[int] = None
    _rng: random.Random = field(init=False, repr=False)

    def __post_init__(self) -> None:
        if self.max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {self.max_attempts}"
            )
        if self.jitter not in _JITTER_MODES:
            raise ValueError(
                f"invalid jitter mode {self.jitter!r}: "
                f"expected one of {_JITTER_MODES}"
            )
        self._rng = random.Random(self.seed)

    def backoff(self, attempt: int) -> float:
        """Upper bound of the sleep after failed attempt ``attempt``
        (0-based): min(max_delay, base_delay * 2**attempt)."""
        return min(self.max_delay, self.base_delay * (2.0 ** attempt))

    def sleep_duration(self, attempt: int) -> float:
        """One jittered sleep for the given failed attempt."""
        cap = self.backoff(attempt)
        if self.jitter == "none":
            return cap
        if self.jitter == "equal":
            return cap / 2.0 + self._rng.uniform(0.0, cap / 2.0)
        return self._rng.uniform(0.0, cap)

    # -- deadline-aware driving ----------------------------------------

    def start(self) -> float:
        """Mark the start of an operation; pass the returned token to
        :meth:`sleep_before_retry`."""
        return time.monotonic()

    def sleep_before_retry(self, attempt: int, started: float) -> bool:
        """Sleep between failed attempt ``attempt`` and the next one.
        Returns False — without sleeping — when no attempt remains
        (attempt cap or deadline exhausted), True after sleeping."""
        if attempt + 1 >= self.max_attempts:
            return False
        duration = self.sleep_duration(attempt)
        if self.deadline is not None:
            remaining = self.deadline - (time.monotonic() - started)
            if remaining <= 0:
                return False
            duration = min(duration, remaining)
        if duration > 0:
            time.sleep(duration)
        return True
