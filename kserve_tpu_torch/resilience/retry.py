"""One retry policy for every outbound hop.

Port of kserve_tpu/resilience/retry.py (the peer page client's retries
ride it here).  A single calculator: exponential
backoff with FULL jitter (AWS architecture-blog shape — jitter over the
whole interval, not +/- a fraction, so synchronized clients decorrelate),
`Retry-After` aware, capped by both a per-request retry budget and the
propagated deadline.  The policy computes delays; callers own the loop,
which keeps it usable from async and sync callers alike.
"""

from __future__ import annotations

import datetime
import random
from dataclasses import dataclass
from email.utils import parsedate_to_datetime
from typing import FrozenSet, Optional

RETRYABLE_STATUSES: FrozenSet[int] = frozenset({429, 502, 503, 504})


def parse_retry_after(value) -> Optional[float]:
    """Seconds to wait from a Retry-After header value: delta-seconds
    (`"2"`, `"1.5"`) or an HTTP-date.  None for absent/malformed — a bad
    header must never break the retry loop."""
    if value is None:
        return None
    text = str(value).strip()
    if not text:
        return None
    try:
        return max(float(text), 0.0)
    except ValueError:
        # not delta-seconds; try HTTP-date below
        pass
    try:
        when = parsedate_to_datetime(text)
    except (TypeError, ValueError):
        return None
    if when.tzinfo is None:
        when = when.replace(tzinfo=datetime.timezone.utc)
    now = datetime.datetime.now(datetime.timezone.utc)
    return max((when - now).total_seconds(), 0.0)


@dataclass
class RetryPolicy:
    """Exponential backoff + full jitter with hard spend limits.

    `max_attempts` counts TOTAL tries (1 = no retries).  `retry_budget_s`
    bounds the cumulative wall time one request may spend across retries,
    independent of attempt count — a slow backend must not hold a caller
    hostage for attempts x timeout.  A `seed` makes the jitter stream
    deterministic for chaos tests.
    """

    max_attempts: int = 3
    base_backoff_s: float = 0.1
    max_backoff_s: float = 2.0
    multiplier: float = 2.0
    retry_budget_s: float = 30.0
    retryable_statuses: FrozenSet[int] = RETRYABLE_STATUSES
    seed: Optional[int] = None

    def __post_init__(self):
        self._rng = random.Random(self.seed)

    def retryable(self, status: int) -> bool:
        return status in self.retryable_statuses

    def next_delay(
        self,
        attempt: int,
        *,
        retry_after: Optional[float] = None,
        elapsed: float = 0.0,
        deadline=None,
    ) -> Optional[float]:
        """Backoff before the next try, or None when retrying must stop.

        `attempt` is the number of tries already made (>= 1).  Stops when
        attempts are exhausted, when the delay would blow `retry_budget_s`
        (given `elapsed` seconds already spent), or when the propagated
        `deadline` cannot cover the wait — retrying past a dead deadline
        only burns backend capacity on an answer nobody will read.
        A server-sent `retry_after` floors the computed delay (the server
        knows its own recovery horizon better than our jitter does).
        """
        if attempt >= self.max_attempts:
            return None
        try:
            grown = self.base_backoff_s * (self.multiplier ** (attempt - 1))
        except OverflowError:
            # float exponent overflow at attempt ~1025 with multiplier 2:
            # the cap is what matters, not the astronomically grown value
            grown = self.max_backoff_s
        cap = min(self.max_backoff_s, grown)
        delay = self._rng.uniform(0.0, max(cap, 0.0))
        if retry_after is not None:
            delay = max(delay, retry_after)
        if elapsed + delay > self.retry_budget_s:
            return None
        if deadline is not None and deadline.remaining() <= delay:
            return None
        return delay
