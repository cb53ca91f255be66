"""The check budget: a wall-clock deadline shared by composed checkers.

The engines do not honour deadlines yet (ROADMAP queue A6): a deadline
that reaches one is refused there, and ``checker.check_safe`` turns the
refusal into an ``unknown`` result.
"""

from __future__ import annotations

import time


class Deadline:
    """A wall-clock check budget, shared by every checker in a compose.

    Constructed once (``checker.resolve_opts`` wraps the raw
    ``"check-deadline"`` seconds value exactly once per check) so that
    parallel checkers and nested engines all see one budget."""

    __slots__ = ("seconds", "_t0")

    def __init__(self, seconds: float, *, start: float | None = None):
        self.seconds = float(seconds)
        self._t0 = time.monotonic() if start is None else start

    @classmethod
    def coerce(cls, v) -> "Deadline | None":
        """None passes through; a Deadline passes through; a number
        becomes a fresh Deadline starting now."""
        if v is None or isinstance(v, cls):
            return v
        return cls(float(v))

    def remaining(self) -> float:
        return self.seconds - (time.monotonic() - self._t0)

    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def clamp(self, timeout: float) -> float:
        """Bound a wait by the budget: min(timeout, remaining), floored
        at 0."""
        return max(0.0, min(timeout, self.remaining()))

    def __repr__(self):
        return f"Deadline({self.seconds}s, {self.remaining():.3f}s left)"
