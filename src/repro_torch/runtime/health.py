"""Straggler detection for the serving engine.

PyTorch counterpart of the part of ``repro/runtime/health.py`` that the
engine uses: :class:`StragglerDetector` keeps each host's recent step times
and flags steps slower than ``threshold`` times the rolling median.  The
engine runs one single-host instance (:meth:`StragglerDetector.record_slow`)
and counts the flagged steps in ``Engine.metrics["slow_steps"]``.  The
heartbeat monitor and the elastic re-planning belong to training and are
not ported yet.
"""

from __future__ import annotations

from collections import defaultdict, deque
from typing import Dict, Sequence, Set


class StragglerDetector:
    """Rolling-median step-time comparison, per host."""

    def __init__(self, n_hosts: int, window: int = 16,
                 threshold: float = 1.8):
        self.window = window
        self.threshold = threshold
        self._times: Dict[int, deque] = defaultdict(
            lambda: deque(maxlen=window))

    def record(self, host_id: int, step_time_s: float) -> None:
        self._times[host_id].append(step_time_s)

    def record_slow(self, host_id: int, step_time_s: float) -> bool:
        """Record one step; True when it is slower than ``threshold`` times
        this host's own rolling median.  The comparison runs before the
        sample joins the window, so a slow step cannot hide itself by
        raising the median, and it stays False until the window is half
        full."""
        ts = self._times[host_id]
        slow = (len(ts) >= max(self.window // 2, 2)
                and step_time_s > self.threshold * self._median(ts))
        ts.append(step_time_s)
        return slow

    def _median(self, xs: Sequence[float]) -> float:
        s = sorted(xs)
        return s[len(s) // 2]

    def stragglers(self) -> Set[int]:
        """Hosts whose median step time is above ``threshold`` times the
        fleet's median of medians."""
        per_host = {h: self._median(ts) for h, ts in self._times.items()
                    if len(ts) >= max(self.window // 2, 2)}
        if len(per_host) < 2:
            return set()
        fleet = self._median(list(per_host.values()))
        return {h for h, m in per_host.items()
                if m > self.threshold * fleet}
