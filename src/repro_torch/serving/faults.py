"""Deterministic fault injection for the serving stack, and its failure
vocabulary.

PyTorch counterpart of ``repro/serving/faults.py``.  A :class:`FaultPlan` is
a seeded, replayable schedule of faults -- device-step exceptions, NaN
logits on chosen rows, allocator corruption, scheduler stalls, clock jumps
-- and a :class:`FaultInjector` fires them at precise (step, site) points
through the hook sites the engine calls:

  ``pre_step``        before scheduling: clock advances, allocator
                      corruption (caught by the audit that runs right
                      after, before any block can be handed out) and
                      stalls (the scheduler is skipped for the step).
  ``raise_if_armed``  before a device dispatch (``SITE_PREFILL`` /
                      ``SITE_DECODE``): raises :class:`InjectedFault`
                      before the call writes the cache, so a retry is
                      clean.
  ``latency``         between the step's time stamp and the device call:
                      advances the simulated clock (a slow device step,
                      for the straggler detector).
  ``corrupt_logits``  after the device call: writes NaN into chosen rows
                      of the logits in place, on their device and without
                      waiting for it, for the engine's NaN guard.

Everything is deterministic: a choice that needs randomness (an untargeted
corruption picking its block) draws from ``np.random.default_rng(
plan.seed)``, the same draws as the reference, and the injector's ``log``
records what fired where.  The allocator and the schedule are host state,
so only ``corrupt_logits`` touches a tensor.

The module also holds the typed ``Request.error_kind`` constants
(``ERR_*``), :class:`SchedulerStall` (an idle plan with work pending,
carrying the queue snapshot) and :class:`SimClock`, the simulated clock
behind deterministic deadlines and latency faults.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence

import numpy as np

# -- Request.error_kind vocabulary (typed failure domains) -----------------
ERR_INVALID = "invalid"       # malformed request (submit-time validation)
ERR_CAPACITY = "capacity"     # could never fit the pool / grew past it
ERR_FAULT = "fault"           # persistent injected or device step failure
ERR_NAN = "nan"               # non-finite logits on the request's row
ERR_DEADLINE = "deadline"     # TTFT or total deadline exceeded
ERR_SHED = "shed"             # load shed under stall, backpressure, thrash
ERR_AUDIT = "audit"           # leased KV blocks quarantined by audit()

# -- injection sites -------------------------------------------------------
SITE_STEP = "step"            # before scheduling (clock, corruption, stall)
SITE_PREFILL = "prefill"      # before the batched chunk dispatch
SITE_DECODE = "decode"        # before the batched decode or verify dispatch


class InjectedFault(RuntimeError):
    """A planned fault fired at a device dispatch site."""

    def __init__(self, site: str, step: int, uid: Optional[int] = None):
        self.site = site
        self.step = step
        self.uid = uid
        who = f"uid={uid}" if uid is not None else "untargeted"
        super().__init__(f"injected {site} fault at step {step} ({who})")


class SchedulerStall(RuntimeError):
    """An idle step plan while work is pending.

    Carries ``snapshot`` (step index, waiting uids, running slot -> uid
    map) so a crash report shows what wedged.  With the fault layer on the
    engine sheds load instead and keeps serving; without it this raises:
    the scheduler's contract is defer, preempt or reject, never idle."""

    def __init__(self, message: str, snapshot: Optional[dict] = None):
        super().__init__(message)
        self.snapshot = snapshot or {}


class SimClock:
    """Deterministic clock for deadline tests and replayable runs.

    Drop-in for the engine's ``clock=`` argument: ``now()`` returns
    seconds, and faults or tests move time with ``advance`` /
    ``advance_ms``.  Also callable, so it can stand wherever
    ``time.perf_counter`` did."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    __call__ = now

    def advance(self, seconds: float) -> None:
        self._t += float(seconds)

    def advance_ms(self, ms: float) -> None:
        self._t += float(ms) / 1e3


@dataclasses.dataclass
class Fault:
    """One scheduled fault, armed from ``step`` on; fires at most ``times``
    times (a persistent fault is one with a large ``times``)."""

    kind: str                     # exception | nan | corrupt | stall | clock
    step: int                     # armed from this engine step (inclusive)
    site: str = SITE_DECODE
    uid: Optional[int] = None     # target request (None: any / the rng)
    times: int = 1
    advance_ms: float = 0.0       # clock faults: how far time jumps
    flavor: str = "refcount"      # corrupt: refcount | free_dup | index
    fired: int = 0


class FaultPlan:
    """A seeded, chainable schedule of :class:`Fault` s."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.faults: List[Fault] = []

    def add(self, fault: Fault) -> "FaultPlan":
        self.faults.append(fault)
        return self

    def step_exception(self, step: int, uid: Optional[int] = None,
                       site: str = SITE_DECODE,
                       times: int = 1) -> "FaultPlan":
        """Raise :class:`InjectedFault` before the site's device call.
        ``times=1`` is a transient fault (the retry succeeds); a large
        ``times`` with a ``uid`` is a request that poisons every batch it
        joins (the retries run out and the request is isolated)."""
        return self.add(Fault("exception", step, site=site, uid=uid,
                              times=times))

    def nan_logits(self, step: int, uid: Optional[int] = None,
                   site: str = SITE_DECODE, times: int = 1) -> "FaultPlan":
        """Write NaN into the target request's logits row after the device
        call: the NaN guard must fail that request (its whole sampling
        group) and no other."""
        return self.add(Fault("nan", step, site=site, uid=uid, times=times))

    def corrupt_pages(self, step: int, uid: Optional[int] = None,
                      flavor: str = "refcount") -> "FaultPlan":
        """Break one allocator invariant before scheduling: ``refcount``
        (a refcount above its lease count), ``free_dup`` (a leased block
        on the free list) or ``index`` (a prefix-index entry pointed at
        another block).  With ``uid`` the corruption takes that request's
        exclusive tail block, so only its leaseholder is hit."""
        return self.add(Fault("corrupt", step, uid=uid, flavor=flavor))

    def stall(self, step: int, times: int = 1) -> "FaultPlan":
        """Skip scheduling for the step: the engine sees an idle plan with
        work pending and sheds."""
        return self.add(Fault("stall", step, times=times))

    def advance_clock(self, step: int, ms: float, site: str = SITE_STEP,
                      times: int = 1) -> "FaultPlan":
        """Jump the simulated clock by ``ms``: at ``SITE_STEP`` before
        scheduling (deadline expiry), at ``SITE_DECODE`` inside the device
        step's timing window (a slow step, for the straggler detector)."""
        return self.add(Fault("clock", step, site=site, advance_ms=ms,
                              times=times))


class FaultInjector:
    """Executes a :class:`FaultPlan` through the engine's hook sites.

    The engine calls ``bind`` with its clock and allocator.  Every hook is
    a no-op once the plan is spent, so an injector with an empty plan
    leaves the streams bitwise equal to no injector at all."""

    def __init__(self, plan: Optional[FaultPlan] = None):
        self.plan = plan or FaultPlan()
        self.rng = np.random.default_rng(self.plan.seed)
        self.clock: Any = None
        self.pager: Any = None
        self.log: List[dict] = []

    def bind(self, clock: Any = None, pager: Any = None) -> None:
        self.clock = clock
        self.pager = pager

    # -- hook sites -------------------------------------------------------
    def pre_step(self, step: int, scheduler: Any) -> bool:
        """Fire the step-scoped faults; True stalls the scheduler this
        step.  A corruption that finds no target yet (its uid holds no
        blocks) stays armed and tries again next step."""
        stalled = False
        for f in self.plan.faults:
            if step < f.step or f.fired >= f.times:
                continue
            if f.kind == "clock" and f.site == SITE_STEP:
                f.fired += 1
                self._advance(f.advance_ms)
                self.log.append({"step": step, "kind": "clock",
                                 "ms": f.advance_ms})
            elif f.kind == "corrupt":
                if self._corrupt(step, f, scheduler):
                    f.fired += 1
            elif f.kind == "stall":
                f.fired += 1
                stalled = True
                self.log.append({"step": step, "kind": "stall"})
        return stalled

    def raise_if_armed(self, site: str, step: int,
                       uids: Sequence[int]) -> None:
        """Raise the first armed exception fault matching (site, batch).
        A fault aimed at a uid fires only while its request is in the
        batch: once the engine isolates the request, the survivors
        dispatch cleanly."""
        for f in self.plan.faults:
            if (f.kind == "exception" and f.site == site and step >= f.step
                    and f.fired < f.times
                    and (f.uid is None or f.uid in uids)):
                f.fired += 1
                self.log.append({"step": step, "site": site,
                                 "kind": "exception", "uid": f.uid})
                raise InjectedFault(site, step, uid=f.uid)

    def latency(self, step: int) -> None:
        """Advance the clock inside the device step's timing window."""
        for f in self.plan.faults:
            if (f.kind == "clock" and f.site != SITE_STEP
                    and step >= f.step and f.fired < f.times):
                f.fired += 1
                self._advance(f.advance_ms)
                self.log.append({"step": step, "kind": "latency",
                                 "ms": f.advance_ms})

    def nan_rows(self, site: str, step: int,
                 uids: Sequence[Optional[int]]) -> List[int]:
        """Row indexes whose logits an armed NaN fault wipes this call."""
        rows: List[int] = []
        for f in self.plan.faults:
            if f.kind != "nan" or f.site != site or step < f.step:
                continue
            for i, u in enumerate(uids):
                if f.fired >= f.times:
                    break
                if u is None:
                    continue
                if f.uid is None or u == f.uid:
                    f.fired += 1
                    rows.append(i)
                    self.log.append({"step": step, "site": site,
                                     "kind": "nan", "uid": u, "row": i})
        return sorted(set(rows))

    def corrupt_logits(self, site: str, step: int, logits,
                       uids: Sequence[Optional[int]]):
        """Apply the armed NaN faults to ``logits`` in place (row ``i``
        belongs to ``uids[i]``; None rows are padding and never touched);
        returns the same tensor."""
        for r in self.nan_rows(site, step, uids):
            logits[r] = float("nan")
        return logits

    # -- internals --------------------------------------------------------
    def _advance(self, ms: float) -> None:
        if self.clock is None or not hasattr(self.clock, "advance_ms"):
            raise RuntimeError(
                "clock faults need an advanceable clock: construct the "
                "Engine with clock=SimClock()")
        self.clock.advance_ms(ms)

    def _corrupt(self, step: int, fault: Fault, scheduler: Any) -> bool:
        """Mutate the allocator's state per ``fault.flavor``; False when no
        target exists yet (the fault stays armed)."""
        pager = self.pager
        if pager is None:
            return False
        target: Optional[int] = None
        if fault.uid is not None:
            for slot in sorted(s for s, q in scheduler.running.items()
                               if q.req.uid == fault.uid):
                blocks = pager.owned[slot]
                # prefer the exclusive mutable tail: one leaseholder, so
                # the audit's blast radius is this slot
                for bid in reversed(blocks):
                    if (pager.refcount[bid] == 1
                            and pager.block_hash[bid] is None):
                        target = bid
                        break
                if target is None and blocks:
                    target = blocks[-1]
                if target is not None:
                    break
        else:
            exclusive = [bid for bid in range(pager.cfg.n_blocks)
                         if pager.refcount[bid] == 1]
            if exclusive:
                target = int(self.rng.choice(exclusive))
        if fault.flavor == "refcount":
            if target is None:
                return False
            pager.refcount[target] += 1
        elif fault.flavor == "free_dup":
            if target is None:
                return False
            pager.free.append(target)
        elif fault.flavor == "index":
            if not pager.index:
                return False
            hashes = sorted(pager.index)
            h = hashes[int(self.rng.integers(len(hashes)))]
            target = pager.index[h]
            pager.index[h] = (target + 1) % pager.cfg.n_blocks
        else:
            raise ValueError(f"unknown corruption flavor {fault.flavor!r}")
        self.log.append({"step": step, "kind": "corrupt",
                         "flavor": fault.flavor, "block": target,
                         "uid": fault.uid})
        return True
