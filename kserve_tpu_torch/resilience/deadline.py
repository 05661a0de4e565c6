"""Request deadline: one budget, propagated across every hop.

Port of kserve_tpu/resilience/deadline.py.  The wire form (the
`x-request-deadline` header) is the REMAINING budget in seconds, not an
absolute time: peers share no clock, and each hop re-anchors the budget
on its own monotonic clock, so transit time is charged.  In the process
the deadline rides a contextvar: the REST server binds it once and the
engine's admission reads it without a parameter through every call.
"""

from __future__ import annotations

import contextlib
from contextvars import ContextVar
from typing import Optional

from .clock import MONOTONIC, Clock

DEADLINE_HEADER = "x-request-deadline"


class DeadlineExceededError(TimeoutError):
    """The request's deadline expired before (or while) it was served:
    504 at the protocol layer."""

    def __init__(self, detail: str = "request deadline exceeded"):
        super().__init__(detail)


class Deadline:
    """An absolute expiry point on a monotonic clock."""

    __slots__ = ("expires_at", "clock")

    def __init__(self, expires_at: float, clock: Clock = MONOTONIC):
        self.expires_at = expires_at
        self.clock = clock

    @classmethod
    def after(cls, seconds: float, clock: Clock = MONOTONIC) -> "Deadline":
        return cls(clock.now() + seconds, clock)

    def remaining(self) -> float:
        return self.expires_at - self.clock.now()

    @property
    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def to_header(self) -> str:
        """The remaining budget for the next hop, clamped at 0 (a dead
        budget still travels, so the receiver rejects instead of working)."""
        return f"{max(self.remaining(), 0.0):.3f}"

    @classmethod
    def from_header(cls, value: Optional[str],
                    clock: Clock = MONOTONIC) -> Optional["Deadline"]:
        """Parse a remaining-seconds header; a malformed value is ignored
        (None) rather than failing the request."""
        if not value:
            return None
        try:
            seconds = float(value)
        except (TypeError, ValueError):
            return None
        return cls.after(seconds, clock)

    def __repr__(self) -> str:
        return f"Deadline(remaining={self.remaining():.3f}s)"


_current_deadline: ContextVar[Optional[Deadline]] = ContextVar(
    "kserve_tpu_torch_request_deadline", default=None)


def current_deadline() -> Optional[Deadline]:
    """The deadline of the current async context (None = unbounded)."""
    return _current_deadline.get()


@contextlib.contextmanager
def deadline_scope(deadline: Optional[Deadline]):
    """Bind `deadline` as the current deadline for the enclosed block."""
    token = _current_deadline.set(deadline)
    try:
        yield deadline
    finally:
        _current_deadline.reset(token)
