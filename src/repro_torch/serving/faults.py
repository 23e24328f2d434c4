"""The serving stack's failure vocabulary and its injectable clock.

The port's copy of what the scheduler, engine and async front-end use from
``repro/serving/faults.py``: the typed ``Request.error_kind`` constants
(``ERR_*``), :class:`SchedulerStall` (an idle plan with work pending,
carrying the queue snapshot) and :class:`SimClock`, the simulated clock
behind deterministic deadlines and open-loop tests.  The fault injector
(``FaultPlan``, ``FaultInjector``) is not ported yet.
"""

from __future__ import annotations

from typing import Optional

ERR_INVALID = "invalid"       # malformed or not-yet-ported request
ERR_CAPACITY = "capacity"     # could never fit the pool / grew past it
ERR_NAN = "nan"               # non-finite logits on the request's row
ERR_DEADLINE = "deadline"     # TTFT or total deadline exceeded
ERR_SHED = "shed"             # load shed under backpressure or thrash


class SchedulerStall(RuntimeError):
    """An idle step plan while work is pending.

    Carries ``snapshot`` (step index, waiting uids, running slot -> uid
    map) so a crash report shows what wedged.  Without a fault layer the
    engine raises it: the scheduler's contract is defer, preempt or
    reject, never idle."""

    def __init__(self, message: str, snapshot: Optional[dict] = None):
        super().__init__(message)
        self.snapshot = snapshot or {}


class SimClock:
    """Deterministic clock for deadline tests and replayable runs.

    Drop-in for the engine's ``clock=`` argument: ``now()`` returns
    seconds, and tests move time with ``advance`` / ``advance_ms``.  Also
    callable, so it can stand wherever ``time.perf_counter`` did."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    __call__ = now

    def advance(self, seconds: float) -> None:
        self._t += float(seconds)

    def advance_ms(self, ms: float) -> None:
        self._t += float(ms) / 1e3
