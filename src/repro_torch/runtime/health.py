"""Fault-tolerance runtime: heartbeats, straggler detection, elastic resize.

PyTorch counterpart of ``repro/runtime/health.py`` (no tensor in it: host
bookkeeping in Python).  The mechanisms run against an abstract host
registry, with injectable clocks, so one machine can test them with
simulated hosts and failures; a launcher wires the same objects to real
hosts.

  HeartbeatMonitor    every host stamps its step each step; hosts silent
                      for more than ``timeout_s`` are suspects.  The
                      trainer (``launch/train.py``) beats it once a step.
  StragglerDetector   per-step durations; hosts slower than ``threshold``
                      times the rolling median get flagged.  The trainer
                      records its step times into one; the serving engine
                      runs one single-host instance (``record_slow``) and
                      counts the flagged steps in
                      ``Engine.metrics["slow_steps"]``.
  ElasticPlan         given the dead hosts, the largest usable (pod, data)
                      slice that keeps every model group whole, and which
                      checkpoint shard each surviving host reloads.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict, deque
from typing import Dict, List, Optional, Sequence, Set


@dataclasses.dataclass
class HostState:
    host_id: int
    last_beat: float
    last_step: int = -1


class HeartbeatMonitor:
    def __init__(self, n_hosts: int, timeout_s: float = 60.0,
                 clock=time.monotonic):
        self._clock = clock
        self.timeout_s = timeout_s
        now = clock()
        self.hosts: Dict[int, HostState] = {
            h: HostState(h, now) for h in range(n_hosts)}

    def beat(self, host_id: int, step: int) -> None:
        st = self.hosts[host_id]
        st.last_beat = self._clock()
        st.last_step = max(st.last_step, step)

    def dead_hosts(self) -> Set[int]:
        now = self._clock()
        return {h for h, st in self.hosts.items()
                if now - st.last_beat > self.timeout_s}

    def max_step(self) -> int:
        return max((st.last_step for st in self.hosts.values()), default=-1)


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


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    """Result of re-planning after failures."""
    usable_hosts: tuple
    new_data_size: int          # shrunk data axis
    new_pod_size: int
    reassigned_shards: dict     # data-shard index -> host id


def plan_elastic(n_pods: int, hosts_per_pod: int, model_hosts: int,
                 dead: Set[int]) -> Optional[ElasticPlan]:
    """Shrink the data axis to exclude dead hosts.

    Host topology: host id = ((pod * data_size) + data_idx) — each
    "host row" owns one data-parallel slice holding all 16 model shards
    (model groups never split across hosts here, matching the v5e pod
    slicing where a TP=16 group is one tray).

    A dead host kills its data slice; the plan drops it, renumbers the
    data axis, and maps every surviving slice to a checkpoint shard.  If
    a whole pod dies, the pod axis shrinks instead.  Returns None if
    nothing survives.
    """
    alive_by_pod: Dict[int, List[int]] = {}
    for pod in range(n_pods):
        rows = [pod * hosts_per_pod + r for r in range(hosts_per_pod)]
        alive_by_pod[pod] = [h for h in rows if h not in dead]

    pods_alive = {p: rows for p, rows in alive_by_pod.items() if rows}
    if not pods_alive:
        return None
    # keep the data axis uniform across pods: min alive rows per pod
    new_data = min(len(rows) for rows in pods_alive.values())
    # prefer power-of-two/divisor sizes so global batch still divides
    while new_data > 1 and hosts_per_pod % new_data:
        new_data -= 1
    usable = []
    reassign = {}
    shard = 0
    for p, rows in sorted(pods_alive.items()):
        for h in rows[:new_data]:
            usable.append(h)
            reassign[shard] = h
            shard += 1
    return ElasticPlan(usable_hosts=tuple(usable),
                       new_data_size=new_data,
                       new_pod_size=len(pods_alive),
                       reassigned_shards=reassign)
