"""Continuous-arrival serving front end with per-step streaming.

PyTorch counterpart of ``repro/serving/async_serving.py``.  The engine's
:meth:`Engine.run` drains a closed batch: everything is submitted up front
and nothing comes back until it finishes.  Users send an open stream:
requests arrive while earlier ones decode, want their tokens as they are
produced, and judge latency from their true arrival, queueing included.
This module is that front end, over the engine's split step:

  ``Engine.step_async()``   plans the step, runs its prompt chunks and
                            dispatches the batched decode and its per-row
                            keyed sampling without waiting for the card;
  (overlap window)          the host takes newly arrived requests into the
                            scheduler and flushes earlier steps' tokens to
                            stream consumers, work that cannot depend on
                            this step's tokens;
  ``Engine.finish_step()``  waits for the tokens and does the
                            token-dependent bookkeeping (append, block
                            registration, stop detection).

Streams stay bitwise those of the closed ``run()`` for the same arrival
order: every decision on a token's value is taken after the wait, and
sampling is keyed per row (``fold_in(seed/stream, position)``), so a
request's stream depends on its own identity and position only.

Streaming follows saxml's ``stream_interval_steps``: token deltas go to
callbacks or generators every N engine steps, and always at completion.

The open-loop runner (:func:`run_open_loop`) serves a seeded arrival
schedule (:func:`poisson_arrivals`) and reports goodput and TTFT / TPOT
percentiles from true arrival.

On a mesh of more than one rank (``Engine(mesh=)``) every rank runs its
own server over its own engine, and their clocks differ.  Rank 0's clock
decides each turn's release: at every turn of ``drain`` / ``stream`` /
``step`` one broadcast (``collectives.from_rank0``) carries the arrivals
rank 0 found due, and every rank submits those arrivals in that order,
stamped with rank 0's instants.  An idle turn waits on each rank's own
clock first, and the ranks meet in the broadcast.  The engine's per-step plan
check (``Engine._agree``) then finds the ranks' plans equal.  A mesh of
one skips the broadcast.  The latency helpers exclude requests that
never produced a first token (``t_first_token == 0.0`` on errored or
rejected requests), whose ``t_first_token - t_enqueue`` would be a large
negative sample.
"""

from __future__ import annotations

import dataclasses
import heapq
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.distribution import collectives as C
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.faults import ERR_SHED


# -- latency accounting (shared with launch/serve.py) -----------------------
def first_token_latencies(requests) -> np.ndarray:
    """Seconds from TRUE arrival (``t_enqueue``) to the first sampled
    token, one sample per request that actually produced one.  Requests
    that never got a first token (rejected at submit, failed before
    prefill finished) keep the dataclass default ``t_first_token ==
    0.0`` — including them would inject ``-t_enqueue`` (huge negative)
    samples and corrupt every percentile, so they are filtered here."""
    return np.asarray([r.t_first_token - r.t_enqueue for r in requests
                       if r.t_first_token > 0.0], np.float64)


def time_per_output_token(requests) -> np.ndarray:
    """Per-request TPOT in seconds: ``(t_done - t_first_token) /
    (n_tokens - 1)`` over the primary stream, for error-free requests
    that decoded at least one token past the first."""
    out = []
    for r in requests:
        n = len(r.output or [])
        if r.error is None and r.t_first_token > 0.0 and n >= 2:
            out.append((r.t_done - r.t_first_token) / (n - 1))
    return np.asarray(out, np.float64)


def latency_summary_ms(samples_s: np.ndarray) -> Dict[str, float]:
    """{p50, p95, p99, mean} in milliseconds (zeros when empty: an empty
    run shows as zero goodput instead of a NaN that would not survive
    JSON)."""
    if len(samples_s) == 0:
        return {"p50": 0.0, "p95": 0.0, "p99": 0.0, "mean": 0.0}
    ms = np.asarray(samples_s, np.float64) * 1e3
    return {"p50": float(np.percentile(ms, 50)),
            "p95": float(np.percentile(ms, 95)),
            "p99": float(np.percentile(ms, 99)),
            "mean": float(np.mean(ms))}


def negative_latency_samples(requests) -> int:
    """Count of impossible (negative) latency samples among requests
    that did produce a first token: with the ``t_first_token == 0.0``
    filter in place this is 0 even when rejected or errored requests
    share the list."""
    ttft = first_token_latencies(requests)
    tpot = time_per_output_token(requests)
    return int(np.sum(ttft < 0)) + int(np.sum(tpot < 0))


def poisson_arrivals(seed: int, n: int, rate_per_s: float) -> np.ndarray:
    """Seeded Poisson arrival process: ``n`` arrival offsets in seconds
    (cumulative Exp(rate) gaps), replayable for closed-vs-open
    bit-exactness comparisons."""
    if rate_per_s <= 0:
        raise ValueError("arrival rate must be positive")
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rate_per_s, size=n))


class StreamHandle:
    """A submitted (or scheduled-for-arrival) request's streaming
    surface.  Tokens land in ``buffer`` as ``(sibling, token)`` pairs in
    production order; ``on_token(handle, sibling, tokens, done)`` fires
    at each flush with the new tokens for that sibling.  ``req`` is the
    live engine :class:`Request` — ``done``/``error`` become meaningful
    once the engine returns it."""

    def __init__(self, prompt: np.ndarray, kw: Dict[str, Any],
                 on_token: Optional[Callable] = None,
                 t_arrival: Optional[float] = None):
        self.prompt = prompt
        self.kw = kw
        self.on_token = on_token
        self.t_arrival = t_arrival
        self.req: Optional[Request] = None     # set at submission
        self.uid: Optional[int] = None
        self.buffer: Deque[Tuple[int, int]] = deque()
        self.done = False
        self._offsets: List[int] = []

    @property
    def error(self) -> Optional[str]:
        return self.req.error if self.req is not None else None

    @property
    def error_kind(self) -> Optional[str]:
        return self.req.error_kind if self.req is not None else None

    def _streams(self) -> List[List[int]]:
        if self.req is None:
            return []
        if self.req.outputs is not None:
            return self.req.outputs
        return [self.req.output or []]


class AsyncServer:
    """Open-loop serving over one :class:`Engine`.

    ``submit()`` is legal at any moment — including from inside the
    overlap window while a device step is in flight.  ``step()`` runs
    one pipelined engine step: dispatch, then (device busy) release due
    scheduled arrivals and flush stream deltas, then sync.  Deadlines
    keep their engine semantics and are measured against the request's
    true arrival time (``t_arrival`` stamps ``t_enqueue``), so a
    request that queued behind a burst can expire without ever running.

    ``max_queue_depth`` bounds the waiting queue (admission-level
    backpressure): arrivals beyond it are shed immediately with
    ``error_kind=ERR_SHED`` instead of growing the queue without
    bound — an open-loop front-end with an unbounded queue just
    converts overload into unbounded TTFT."""

    def __init__(self, engine: Engine, stream_interval_steps: int = 1,
                 max_queue_depth: Optional[int] = None):
        self.engine = engine
        self.stream_interval_steps = max(1, int(stream_interval_steps))
        self.max_queue_depth = max_queue_depth
        self._active: Dict[int, StreamHandle] = {}
        self._arrivals: List[Tuple[float, int, StreamHandle]] = []  # heap
        self._arrival_seq = 0          # heap tiebreak = arrival order
        self._shed_uid = 0
        self._steps = 0
        self.midflight_submits = 0     # arrivals while work was in flight
        self.peak_queue_depth = 0

    # -- submission ------------------------------------------------------
    def submit(self, prompt: np.ndarray, *,
               on_token: Optional[Callable] = None,
               t_arrival: Optional[float] = None, **kw) -> StreamHandle:
        """Submit now.  ``t_arrival`` stamps the request's true arrival
        instant (defaults to the engine clock's now); latency and
        deadlines are charged from it."""
        handle = StreamHandle(prompt, kw, on_token, t_arrival)
        self._submit_handle(handle)
        return handle

    def schedule_arrival(self, t_arrival: float, prompt: np.ndarray, *,
                         on_token: Optional[Callable] = None,
                         **kw) -> StreamHandle:
        """Register a FUTURE arrival (open-loop workloads): the request
        is submitted once the clock passes ``t_arrival``, with
        ``t_enqueue`` stamped to ``t_arrival`` itself even if release
        happens later (the engine was mid-step) — release jitter must
        show up as queueing delay, not vanish from it."""
        handle = StreamHandle(prompt, kw, on_token, t_arrival)
        heapq.heappush(self._arrivals,
                       (float(t_arrival), self._arrival_seq, handle))
        self._arrival_seq += 1
        return handle

    def _submit_handle(self, handle: StreamHandle) -> None:
        eng = self.engine
        if (self.max_queue_depth is not None
                and eng.scheduler.queue_depth() >= self.max_queue_depth):
            # backpressure shed: never reaches the engine
            self._shed_uid -= 1
            now = eng._now()
            handle.req = Request(
                uid=self._shed_uid, prompt=np.asarray(handle.prompt),
                t_enqueue=(handle.t_arrival if handle.t_arrival is not None
                           else now),
                t_done=now, output=[],
                error=(f"shed at admission: queue depth "
                       f"{eng.scheduler.queue_depth()} >= "
                       f"{self.max_queue_depth}"),
                error_kind=ERR_SHED, **handle.kw)
            eng.metrics["shed_requests"] += 1
            handle.done = True
            if handle.on_token is not None:
                handle.on_token(handle, 0, [], True)
            return
        if eng.scheduler.has_work() or eng._pending is not None:
            self.midflight_submits += 1
        kw = dict(handle.kw)
        if handle.t_arrival is not None:
            kw["t_enqueue"] = handle.t_arrival
        handle.req = eng.submit_request(handle.prompt, **kw)
        handle.uid = handle.req.uid
        self._active[handle.uid] = handle
        self.peak_queue_depth = max(self.peak_queue_depth,
                                    eng.scheduler.queue_depth())

    def poll_arrivals(self) -> int:
        """Release every scheduled arrival whose instant has passed (on a
        mesh, by rank 0's clock)."""
        return self._turn(wait=False)

    def _turn(self, wait: bool) -> int:
        """One turn of the loop: with ``wait``, idle until the next
        arrival is due; then release the due arrivals (:meth:`_released`)
        at rank 0's instants.  Returns how many were released."""
        if wait:
            self._wait_for_next_arrival()
        due = self._released()
        for t_arrival, _, handle in due:
            handle.t_arrival = t_arrival
            self._submit_handle(handle)
        return len(due)

    def _pop_due(self) -> List[Tuple[float, int, "StreamHandle"]]:
        """Pop every scheduled arrival due by this rank's clock, in
        release order."""
        now = self.engine._now()
        out = []
        while self._arrivals and self._arrivals[0][0] <= now:
            out.append(heapq.heappop(self._arrivals))
        return out

    def _released(self) -> List[Tuple[float, int, "StreamHandle"]]:
        """The arrivals this turn releases: those due by this rank's clock
        on a mesh of one, or none; on a larger mesh rank 0's, whose
        (sequence, instant) pairs one broadcast sends (the release
        broadcast), and every other rank pops the same."""
        mesh = self.engine.mesh
        if mesh is None or mesh.size == 1:
            return self._pop_due()
        due = self._pop_due() if mesh.rank == 0 else None
        sent = C.from_rank0(
            None if due is None else [(seq, t) for t, seq, _ in due], mesh)
        if due is not None:
            return due
        out = []
        for seq, t_arrival in sent:
            _, got, handle = heapq.heappop(self._arrivals)
            if got != seq:
                raise RuntimeError(
                    f"arrival {got} is this rank's next, rank 0 released "
                    f"{seq}: the ranks' schedules differ")
            out.append((t_arrival, got, handle))
        return out

    def next_arrival(self) -> Optional[float]:
        return self._arrivals[0][0] if self._arrivals else None

    def has_work(self) -> bool:
        eng = self.engine
        return bool(eng.scheduler.has_work() or eng._pending is not None
                    or eng._rejected or self._arrivals)

    # -- the pipelined step ---------------------------------------------
    def step(self) -> List[Request]:
        """One engine step with the host overlap window in the middle.
        Returns the requests that completed/failed this step (their
        handles are flushed and marked done)."""
        self.poll_arrivals()
        out, pending = self.engine.step_async()
        done: List[Request] = list(out) if out else []
        if out is None and pending is None:
            return done
        self._steps += 1
        # -- overlap window: the card owns this step's decode; do the
        # host work that cannot depend on its tokens --------------------
        self.poll_arrivals()               # mid-flight arrivals
        if self._steps % self.stream_interval_steps == 0:
            self._flush_active()           # stream earlier steps' tokens
        # -- wait for the tokens, finish the step -----------------------
        done.extend(self.engine.finish_step(pending))
        for req in done:
            handle = self._active.pop(req.uid, None)
            if handle is None:
                continue
            self._flush_handle(handle, final=True)
        return done

    def drain(self, max_steps: int = 1_000_000) -> List[Request]:
        """Serve until every submitted AND scheduled request completes;
        idles (advancing a SimClock, or sleeping on the wall clock) when
        the engine is empty but arrivals are still due."""
        done: List[Request] = []
        for _ in range(max_steps):
            if not self.has_work():
                break
            eng = self.engine
            if (not eng.scheduler.has_work() and not eng._rejected
                    and eng._pending is None and self._arrivals):
                self._turn(wait=True)
                continue
            done.extend(self.step())
        return done

    def stream(self, handle: StreamHandle):
        """Generator surface: yield ``(sibling, token)`` for ``handle``
        as tokens are produced, pumping engine steps in between (other
        requests keep being served by the same pump)."""
        while True:
            while handle.buffer:
                yield handle.buffer.popleft()
            if handle.done:
                return
            if not self.has_work():
                return                      # defensive: orphaned handle
            eng = self.engine
            if (not eng.scheduler.has_work() and not eng._rejected
                    and eng._pending is None and self._arrivals):
                self._turn(wait=True)
                continue
            self.step()

    # -- internals -------------------------------------------------------
    def _wait_for_next_arrival(self) -> None:
        nxt = self.next_arrival()
        if nxt is None:
            return
        now = self.engine._now()
        if nxt <= now:
            return
        clk = self.engine._clock
        if clk is not None and hasattr(clk, "advance"):
            clk.advance(nxt - now)         # simulated time: jump
        else:
            time.sleep(min(nxt - now, 0.05))

    def _flush_active(self) -> None:
        for handle in self._active.values():
            self._flush_handle(handle, final=False)

    def _flush_handle(self, handle: StreamHandle, final: bool) -> None:
        streams = handle._streams()
        while len(handle._offsets) < len(streams):
            handle._offsets.append(0)
        delivered: List[Tuple[int, List[int]]] = []
        for s, out in enumerate(streams):
            new = out[handle._offsets[s]:]
            if new:
                handle._offsets[s] = len(out)
                handle.buffer.extend((s, t) for t in new)
                delivered.append((s, list(new)))
        if final:
            handle.done = True
        if handle.on_token is not None:
            for s, toks in delivered:
                handle.on_token(handle, s, toks,
                                final and s == len(streams) - 1)
            if final and not delivered:
                handle.on_token(handle, 0, [], True)


# -- open-loop runner ------------------------------------------------------
@dataclasses.dataclass
class OpenLoopReport:
    """What an open-loop run measured.  All latencies are charged from
    TRUE arrival time; goodput counts only error-free requests."""

    n_requests: int
    completed_ok: int
    failed: int
    wall_s: float
    arrival_rate_req_s: float
    goodput_tok_s: float          # error-free tokens / wall second
    goodput_req_s: float          # error-free completions / wall second
    ttft_ms: Dict[str, float]     # {p50, p95, p99, mean}
    tpot_ms: Dict[str, float]
    neg_latency_samples: int      # must be 0 (TTFT-filter regression)
    midflight_submits: int        # arrivals while work was in flight
    peak_queue_depth: int

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def run_open_loop(engine: Engine,
                  workload: List[Tuple[float, np.ndarray, Dict[str, Any]]],
                  *, stream_interval_steps: int = 1,
                  max_queue_depth: Optional[int] = None,
                  on_token: Optional[Callable] = None
                  ) -> Tuple[List[StreamHandle], OpenLoopReport]:
    """Serve ``workload`` — ``(arrival_offset_s, prompt, submit_kw)``
    triples, offsets relative to the run's start — open loop, and
    measure it.  Arrivals are released by the engine's own clock (wall
    by default, a SimClock for deterministic tests)."""
    server = AsyncServer(engine,
                         stream_interval_steps=stream_interval_steps,
                         max_queue_depth=max_queue_depth)
    t0 = engine._now()
    handles = [server.schedule_arrival(t0 + dt, prompt,
                                       on_token=on_token, **kw)
               for dt, prompt, kw in workload]
    server.drain()
    wall = max(engine._now() - t0, 1e-9)

    reqs = [h.req for h in handles if h.req is not None]
    ok = [r for r in reqs if r.error is None]
    ok_tokens = sum(sum(len(s) for s in (r.outputs or [r.output or []]))
                    for r in ok)
    offsets = [dt for dt, _, _ in workload]
    span = max(max(offsets), 1e-9) if offsets else 1e-9
    report = OpenLoopReport(
        n_requests=len(workload),
        completed_ok=len(ok),
        failed=len(reqs) - len(ok),
        wall_s=float(wall),
        arrival_rate_req_s=float(len(workload) / span),
        goodput_tok_s=float(ok_tokens / wall),
        goodput_req_s=float(len(ok) / wall),
        ttft_ms=latency_summary_ms(first_token_latencies(reqs)),
        tpot_ms=latency_summary_ms(time_per_output_token(reqs)),
        neg_latency_samples=negative_latency_samples(reqs),
        midflight_submits=server.midflight_submits,
        peak_queue_depth=server.peak_queue_depth)
    return handles, report
