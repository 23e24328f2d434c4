"""Serving engine: executes the Scheduler's step plans over the KV cache.

PyTorch counterpart of ``repro/serving/engine.py`` on the paged KV pool or
the dense per-slot cache.  The
:class:`~repro_torch.serving.scheduler.Scheduler`
owns policy (admission, chunked prefill under a token budget, preemption
with recompute-on-resume, prefix reuse); :class:`Engine` owns mechanism:
each step it republishes the page table, runs the plan's copy-on-write
block copies, runs ALL of the step's prompt chunks as one padded
``prefill_chunk_batch`` call of fixed ``(max_slots, prefill_chunk_tokens)``
extent, runs every running decode as one batched ``decode_step``, and
samples each row's next token.  After each chunk or decode it registers
the freshly filled full blocks in the allocator's prefix index, so a later
request with the same prompt prefix maps those blocks and prefills only
the rest.

``cache_kind="dense"`` serves from the contiguous per-slot reservation
instead: each admitted prompt runs as one whole-prompt ``prefill`` whose
(1, max_seq) cache is copied into its slot, then decodes with the rest;
there are no blocks, so no prefix reuse, copy-on-write or preemption, and
``n_samples > 1`` is rejected as in the reference.

Sampling is the reference's, key for key: each request's root key is
``prng_key(seed)`` or the next split of the engine's key; sibling ``i``
draws stream ``fold_in(root, stream + i)`` and its token ``t`` with
``fold_in(stream_key, t)`` (:mod:`repro_torch.core.prng`, bitwise equal to
``jax.random``), so a row's draw depends on its own key and logits only.
A request with ``n_samples = n > 1`` prefills once and, at its first
token, draws ``n`` tokens from the one prompt row and forks into ``n``
siblings that share the prompt's blocks (``Scheduler.fork_group``); their
tails un-share through copy-on-write.

**Stepping.**  :meth:`Engine.step` runs one step to its end;
:meth:`Engine.step_async` plans the step, runs its chunks, dispatches the
batched decode and its sampling, and returns without waiting on the card;
:meth:`Engine.finish_step` waits for the sampled tokens and does the
token-dependent bookkeeping.  The dispatch reads nothing back from the
card: the step's operands go up from pinned host memory without blocking,
the paged write of the decode step needs no host read
(``transformer.decode_step``), and the tokens come back by a non-blocking
copy into pinned memory with an event behind it.  ``submit`` is legal
while a step is in flight; ``t_enqueue`` stamps a request's true arrival,
from which its deadlines (``deadline_ms``, ``ttft_deadline_ms``) are
charged by the per-step watchdog.  ``serving/async_serving.py`` is the
open-loop front end over this split.

**Energy.**  Every device call is charged the roofline energy of the
weights it streams, the KV rows it touches and its operations
(``launch/roofline.step_joules``, H100 constants):
``metrics["energy_joules"]`` is a model, not a measurement.

Not ported yet (ROADMAP): speculative decoding, fault injection and mesh
sharding raise at construction.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.device import Device, resolve_device
from repro_torch.launch.roofline import step_joules, tree_bytes
from repro_torch.models.model import Model, count_params, params_to
from repro_torch.serving.faults import (ERR_DEADLINE, ERR_NAN, ERR_SHED,
                                        SchedulerStall)
from repro_torch.serving.paged_cache import (BlockAllocator, PagedConfig,
                                             chain_hash)
from repro_torch.serving.scheduler import (PrefillChunk, Scheduler,
                                           StepPlan, validate_request)

NOT_PORTED = "not yet ported"


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray            # (len,) int32
    max_new_tokens: int = 64
    temperature: float = 1.0
    top_p: float = 1.0
    n_samples: int = 1            # best-of-n: fork n siblings at token 1
    seed: Optional[int] = None    # PRNG root (None: engine-assigned)
    stream: int = 0               # sibling i draws stream ``stream + i``
    stop_tokens: Optional[Sequence[int]] = None  # per-request stop ids
    deadline_ms: Optional[float] = None       # total budget since arrival
    ttft_deadline_ms: Optional[float] = None  # first-token budget
    # filled by the engine:
    output: Optional[List[int]] = None           # == outputs[0]
    outputs: Optional[List[List[int]]] = None    # one stream per sibling
    t_enqueue: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0
    error: Optional[str] = None
    error_kind: Optional[str] = None
    rng_key: Any = None           # PRNG root (derived from seed / engine)


def sample_logits(key, logits: torch.Tensor, temperature=1.0,
                  top_p=1.0) -> torch.Tensor:
    """Temperature + nucleus sampling, (B, V) -> (B,) int32, as the
    reference's ``sample_logits``: ``temperature``/``top_p`` are scalars or
    per-row (B,) values; ``temperature <= 0`` rows take the argmax.  A (2,)
    ``key`` draws the whole batch's noise; a (B, 2) key batch draws row
    ``b`` with ``key[b]`` (:func:`sample_logits_per_row`)."""
    b = logits.shape[0]
    dev = logits.device
    t = torch.as_tensor(temperature, dtype=torch.float32).to(dev)
    t = torch.broadcast_to(t, (b,))
    p = torch.as_tensor(top_p, dtype=torch.float32).to(dev)
    p = torch.clamp(torch.broadcast_to(p, (b,)), min=1e-6)
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits / torch.clamp(t, min=1e-6)[:, None]
    sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    csum = torch.cumsum(probs, dim=-1)
    # smallest k with cumulative prob >= top_p, per row
    keep = csum - probs < p[:, None]
    thresh = torch.amin(torch.where(keep, sorted_logits, math.inf), dim=-1,
                        keepdim=True)
    masked = torch.where(scaled >= thresh, scaled, -math.inf)
    sampled = prng.categorical(key.to(dev), masked)
    return torch.where(t <= 0.0, greedy, sampled).to(torch.int32)


def sample_logits_per_row(keys, logits: torch.Tensor, temperature=1.0,
                          top_p=1.0) -> torch.Tensor:
    """Per-row keyed sampling: ``keys`` (B, 2), one key per row, and row
    ``i``'s draw depends only on ``(keys[i], logits[i], temperature[i],
    top_p[i])`` -- a sequence's stream is the same whatever shares its
    batch, so a fork sibling replays as an independent request and a
    preempted sequence resumes its stream unchanged."""
    if keys.dim() != 2 or keys.shape[0] != logits.shape[0]:
        raise ValueError(f"keys {tuple(keys.shape)} must be (B, 2) for "
                         f"logits {tuple(logits.shape)}")
    return sample_logits(keys, logits, temperature, top_p)


def legacy_chunk_shape_keys(plan_log) -> set:
    """The ``(B, chunk_len, pos_offset)`` shape keys a per-shape-grouped
    chunk step would have used for the chunks in ``plan_log``: the
    counterfactual cost that the padded chunk step avoids."""
    keys = set()
    for plan in plan_log:
        groups: Dict[Any, int] = {}
        for (_, s, e) in plan.get("prefills", []):
            groups[(e - s, s)] = groups.get((e - s, s), 0) + 1
        keys |= {(n, ln, off) for (ln, off), n in groups.items()}
    return keys


def _copy_pool_blocks(attn: Dict[str, torch.Tensor], src: torch.Tensor,
                      dst: torch.Tensor) -> None:
    """Copy whole pool blocks src -> dst across every layer (and the scale
    pools of an int8 pool): the device half of copy-on-write.  The source
    rows are gathered before any destination is written."""
    for buf in attn.values():
        buf[:, dst] = buf[:, src]


class _Draw:
    """A step's sampled tokens and logits-row finiteness on their way to the
    host.  On the card they are copied into pinned memory without blocking
    and an event is recorded behind the copy; :meth:`wait` blocks on that
    event alone.  On the CPU they are there already.  ``wait`` returns
    (tokens, finite): the first ``n_tok`` values, picked at ``rows`` when
    given, and the rest as booleans."""

    def __init__(self, both: torch.Tensor, n_tok: int,
                 rows: Optional[List[int]] = None):
        self.n_tok, self.rows = n_tok, rows
        self.event = None
        self.host = both
        if both.is_cuda:
            self.host = torch.empty(both.shape, dtype=both.dtype,
                                    pin_memory=True)
            self.host.copy_(both, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()

    def wait(self):
        if self.event is not None:
            self.event.synchronize()
        both = self.host.numpy()
        toks = both[:self.n_tok]
        if self.rows is not None:
            toks = toks[self.rows]
        return toks, both[self.n_tok:].astype(bool)


@dataclasses.dataclass
class _PendingDecode:
    """A dispatched batched decode whose tokens have not been read:
    ``draw`` holds them on their way to the host."""

    slots: List[int]
    draw: _Draw
    t0: float


@dataclasses.dataclass
class _PendingStep:
    """A step that :meth:`Engine.step_async` returned before its decode's
    tokens were read; :meth:`Engine.finish_step` completes it."""

    decode: _PendingDecode
    plan: StepPlan


class Engine:
    """Single-device continuous-batching engine (plan executor).

    ``device`` is where the cache lives and the steps run (the card unless
    ``"cpu"`` is passed); ``params`` are moved there.  ``cache_kind`` is
    ``"paged"`` (the block pool) or ``"dense"`` (a contiguous
    ``max_seq`` reservation per slot).  ``n_pages`` sizes the pool
    (default: the full ``max_slots * max_seq`` reservation);
    shrinking it oversubscribes, which the scheduler absorbs by deferring
    admission and preempting on mid-decode growth.  Requests that could
    never run come back from :meth:`run` with ``.error`` set.  ``seed``
    roots the keys of requests submitted without one; ``draft_proposer``
    is accepted as in the reference and inert while ``spec_tokens`` is 0.
    ``prefix_caching`` turns the allocator's prefix index on or off,
    ``preempt_limit`` is the scheduler's starvation bound and
    ``nan_guard`` fails a request whose logits row is not finite.
    ``clock`` is None (the wall clock), a callable or an object with
    ``now()`` such as :class:`~repro_torch.serving.faults.SimClock`: every
    time stamp and deadline reads it.  ``shed_after_preempts`` sheds the
    lowest-value waiter after that many preempting steps in a row.  The
    arguments the port shares with the reference come in its order."""

    def __init__(self, model: Model, params: Any, max_slots: int = 8,
                 max_seq: int = 1024, eos_id: int = 2, seed: int = 0,
                 cache_kind: str = "paged", page_size: int = 64,
                 n_pages: Optional[int] = None,
                 prefill_chunk_tokens: int = 512,
                 prefix_caching: bool = True, preempt_limit: int = 3,
                 faults: Any = None, clock: Any = None,
                 nan_guard: bool = True,
                 shed_after_preempts: Optional[int] = None,
                 spec_tokens: int = 0, draft_proposer: Any = None,
                 mesh: Any = None, device: Device = None):
        if cache_kind not in ("paged", "dense"):
            raise ValueError(f"cache_kind must be 'paged' or 'dense', got "
                             f"{cache_kind!r}")
        for name, off in (("spec_tokens", spec_tokens),
                          ("faults", faults is not None),
                          ("mesh", mesh is not None)):
            if off:
                raise NotImplementedError(f"Engine({name}) is {NOT_PORTED}")
        self.device = resolve_device(device)
        if clock is None:
            self._now: Callable[[], float] = time.perf_counter
        elif hasattr(clock, "now"):
            self._now = clock.now
        else:
            self._now = clock
        self._clock = clock
        self.shed_after_preempts = shed_after_preempts
        self.key = prng.prng_key(seed)
        self.model = model
        self.params = params_to(params, self.device)
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.prefill_chunk_tokens = prefill_chunk_tokens
        self.nan_guard = nan_guard
        self.page_size = page_size
        self.paged = cache_kind == "paged"
        self.pager: Optional[BlockAllocator] = None
        if self.paged:
            mb = -(-max_seq // page_size)
            self.n_pages = n_pages or max_slots * mb
            self.pager = BlockAllocator(PagedConfig(
                n_layers=model.cfg.n_layers,
                n_kv_heads=model.cfg.n_kv_heads, head_dim=model.cfg.hd(),
                block_size=page_size, n_blocks=self.n_pages,
                max_slots=max_slots, max_blocks_per_seq=mb),
                enable_prefix_cache=prefix_caching)
            self.cache = model.init_paged_cache(
                max_slots, block_size=page_size, n_blocks=self.n_pages,
                max_blocks_per_seq=mb, device=self.device)
        else:
            self.cache = model.init_cache(max_slots, max_seq,
                                          device=self.device)
        self.scheduler = Scheduler(
            max_slots=max_slots, max_seq=max_seq, pager=self.pager,
            prefill_chunk_tokens=prefill_chunk_tokens,
            preempt_limit=preempt_limit)
        # roofline energy model: every device call streams the weights once
        # plus the KV rows it touches (paged pool only, as the reference)
        self._param_bytes = float(tree_bytes(params))
        self._n_params = float(count_params(params))
        self._kv_row_bytes = 0
        if self.paged:
            attn = self.cache["attn"]
            per_pos = (2 * model.cfg.n_kv_heads * model.cfg.hd()
                       * attn["k"].element_size())
            if "ks" in attn:
                per_pos += 2 * model.cfg.n_kv_heads * 4   # dequant scales
            self._kv_row_bytes = per_pos * model.cfg.n_layers
        self.plan_log: List[Dict[str, Any]] = []
        self.metrics = {"tokens_out": 0, "requests_done": 0,
                        "decode_steps": 0, "t_decode": 0.0,
                        "chunk_batch_calls": 0, "t_prefill": 0.0,
                        "prefill_chunks": 0, "preemptions": 0,
                        "cow_copies": 0, "prefix_hits": 0,
                        "prefix_cached_tokens": 0, "prefix_evictions": 0,
                        "fanouts": 0, "blocks_live_peak": 0,
                        "blocks_saved_by_sharing_peak": 0,
                        "prefill_compiles": 0, "seq_steps": 0,
                        "steps_per_token": 0.0,
                        # uid -> {cached_tokens, cache_hit}
                        "requests": {},
                        "requests_failed": 0, "requests_rejected": 0,
                        "nan_rows": 0, "deadline_misses": 0,
                        "shed_requests": 0,
                        # roofline accounting: prefix K/V bytes a chunk
                        # step reads through the page table, against the
                        # full-extent gather; modeled energy
                        "prefix_attn_bytes": 0,
                        "prefix_attn_bytes_gather": 0,
                        "energy_joules": 0.0}
        self._host_pt: Optional[np.ndarray] = None
        self._done_at_prefill: List[Request] = []
        self._rejected: List[Request] = []
        self._uid = 0
        self._step = 0
        self._pending: Optional[_PendingStep] = None
        self._preempt_streak = 0

    def _put(self, x, dtype=torch.int32) -> torch.Tensor:
        """Host -> device upload of a step operand.  On the card the array
        is staged in pinned memory and copied without blocking the host;
        the caching host allocator keeps each staging block until an event
        behind its copy has passed, so none is rewritten in flight."""
        t = torch.as_tensor(np.asarray(x), dtype=dtype)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    # -- public API ---------------------------------------------------------
    def submit(self, prompt: np.ndarray, **kw) -> int:
        """Enqueue a request; returns its uid.  A malformed request (empty
        prompt, ``max_new_tokens`` that leaves no prompt room,
        ``n_samples < 1``, a group wider than the slot table or on the
        dense cache, a prompt that could never fit the pool) gets ``.error``
        here and comes back from the next :meth:`run` without entering the
        scheduler.  Its root key is ``prng_key(seed)``, or the next split
        of the engine's key when no seed is given.

        Legal at any time, also between :meth:`step_async` and
        :meth:`finish_step`: the request waits for the next plan.
        ``t_enqueue`` stamps its true arrival (an open-loop front end
        releases arrivals between steps, after their instant); queueing
        delay and deadlines are charged from it."""
        self._uid += 1
        t_enq = kw.pop("t_enqueue", None)
        req = Request(uid=self._uid, prompt=np.asarray(prompt, np.int32),
                      t_enqueue=self._now() if t_enq is None else t_enq,
                      output=[], **kw)
        if req.seed is not None:
            req.rng_key = prng.prng_key(req.seed)
        else:
            self.key, req.rng_key = prng.split(self.key)
        err = validate_request(req, self.max_seq, self.max_slots,
                               self.pager)
        if err is not None:
            req.error, req.error_kind = err
            self._rejected.append(req)
            return req.uid
        self.scheduler.add(req)
        return req.uid

    def submit_request(self, prompt: np.ndarray, **kw) -> Request:
        """:meth:`submit`, returning the :class:`Request` itself: the async
        front end holds it to stream its outputs while it is in flight."""
        uid = self.submit(prompt, **kw)
        if self._rejected and self._rejected[-1].uid == uid:
            return self._rejected[-1]
        req = self.scheduler.request(uid)
        assert req is not None, f"submitted uid {uid} vanished"
        return req

    def run(self, max_steps: int = 10_000) -> List[Request]:
        """Serve until the scheduler drains; returns every finished,
        rejected or failed request (deadline, shed, NaN), each failure
        with its typed ``error_kind``."""
        done: List[Request] = []
        for _ in range(max_steps):
            out = self.step()
            if out is None:
                break
            done.extend(out)
        return done

    def step(self) -> Optional[List[Request]]:
        """Execute one scheduler step to its end; returns the requests that
        completed, were rejected or failed during it, or None when the
        engine is idle."""
        done, pending = self._step_impl(sync=True)
        assert pending is None
        return done

    def step_async(self):
        """:meth:`step` without waiting for the decode's tokens: returns
        ``(done, pending)``; ``pending`` (when not None) is the dispatched
        decode, which :meth:`finish_step` completes.  The card computes
        the decode and its sampling while the host takes arrivals and
        flushes streams.  The chunk step runs to its end first, as in the
        reference: its first tokens decide fanouts and stops."""
        return self._step_impl(sync=False)

    def finish_step(self, pending: Optional[_PendingStep] = None
                    ) -> List[Request]:
        """Complete a :meth:`step_async` step: wait for its tokens, append
        them, register filled blocks, retire stops.  Returns ``[]`` when
        nothing is pending."""
        if pending is None:
            pending = self._pending
        if pending is None:
            return []
        self._pending = None
        done = self._decode_complete(pending.decode)
        self._step_tail(pending.plan)
        return done

    def _step_impl(self, sync: bool):
        """One scheduler step; returns ``(done, pending)``, ``done`` None
        when the engine was idle.  ``sync=False`` leaves the decode's
        completion to :meth:`finish_step`."""
        if self._pending is not None:
            raise RuntimeError(
                "finish_step() must complete the in-flight step before "
                "the next one is dispatched")
        done: List[Request] = []
        if self._rejected:
            now = self._now()
            for req in self._rejected:
                req.t_done = now
                self.metrics["requests_rejected"] += 1
                done.append(req)
            self._rejected = []
        if not self.scheduler.has_work():
            return (done if done else None), None
        self._step += 1
        plan = self.scheduler.schedule()
        now = self._now()
        for req in plan.rejected:
            req.t_done = now
            self.metrics["requests_rejected"] += 1
            done.append(req)
        expired = self._enforce_deadlines(plan)
        done.extend(expired)
        if not plan.made_progress() and not expired:
            self._handle_stall()
        if plan.preempted and self.shed_after_preempts is not None:
            self._preempt_streak += 1
            if self._preempt_streak >= self.shed_after_preempts:
                done.extend(self._shed(
                    f"{self._preempt_streak} consecutive preempting "
                    "steps (thrash)"))
                self._preempt_streak = 0
        elif not plan.preempted:
            self._preempt_streak = 0
        self.plan_log.append(plan.summary())
        for uid, cached in plan.admitted:
            self.metrics["requests"].setdefault(
                uid, {"cached_tokens": int(cached), "cache_hit": cached > 0})
        self.metrics["preemptions"] = self.scheduler.n_preempted
        self.metrics["prefix_hits"] = self.scheduler.prefix_stats["hits"]
        self.metrics["prefix_cached_tokens"] = \
            self.scheduler.prefix_stats["cached_tokens"]
        if self.paged:
            self.metrics["prefix_evictions"] = self.pager.stats["evictions"]
        if self.paged and plan.has_work():
            # one republish per step covers its allocations, COW remaps and
            # any releases since the last one
            self._host_pt = self.pager.page_table()
            self.cache["page_table"] = self._put(self._host_pt)
        if plan.cows:
            _copy_pool_blocks(self.cache["attn"],
                              self._put([s for s, _ in plan.cows], torch.long),
                              self._put([d for _, d in plan.cows], torch.long))
            self.metrics["cow_copies"] += len(plan.cows)
        if plan.prefills:
            done.extend(self._run_chunks(plan.prefills))
            self.metrics["prefill_compiles"] = self.prefill_compile_count()
            self.plan_log[-1]["prefill_compiles"] = \
                self.metrics["prefill_compiles"]
        done.extend(self._done_at_prefill)
        self._done_at_prefill = []
        if plan.decodes:
            if not sync:
                self._pending = _PendingStep(
                    self._decode_dispatch(plan.decodes), plan)
                return done, self._pending
            done.extend(self._decode_once(plan.decodes))
        self._step_tail(plan)
        return done, None

    def _step_tail(self, plan: StepPlan) -> None:
        self.metrics["steps_per_token"] = (
            self.metrics["seq_steps"] / max(1, self.metrics["tokens_out"]))
        if not self.paged:
            return
        live = shared = 0
        for rc in self.pager.refcount:
            if rc > 0:
                live += 1
                shared += rc - 1
        self.metrics["blocks_live_peak"] = max(
            self.metrics["blocks_live_peak"], live)
        self.metrics["blocks_saved_by_sharing_peak"] = max(
            self.metrics["blocks_saved_by_sharing_peak"], shared)

    def cache_utilization(self) -> float:
        """Fraction of the KV pool in use (of the slots, for the dense
        cache)."""
        if self.paged:
            return self.pager.utilization()
        return len(self.scheduler.running) / self.max_slots

    def throughput_tok_s(self) -> float:
        """Decode-only throughput: ``tokens_out / t_decode``."""
        t = self.metrics["t_decode"]
        return self.metrics["tokens_out"] / t if t > 0 else 0.0

    def prefill_compile_count(self) -> int:
        """Distinct padded shapes the chunk step has run with for this
        model config (the counterpart of the reference's compile count:
        one per pool key)."""
        return self.model.prefill_compile_count()

    # -- deadlines, shedding, stalls -----------------------------------------
    def _fail_request(self, req: Request, msg: str, kind: str,
                      plan: Any = None, quarantine: bool = False
                      ) -> Request:
        """Fail one request (its whole sampling group) while the rest of the
        batch serves on: quarantine the blocks it wrote when their content
        is suspect (NaN), retract what it still has planned in ``plan``,
        release its leases, stamp the typed error."""
        if self.paged and quarantine:
            bs = self.page_size
            for slot, seq in list(self.scheduler.running.items()):
                if seq.req is req:
                    self.pager.quarantine(slot, seq.cached_len // bs)
        self.scheduler.fail_request(req, plan)
        req.error, req.error_kind = msg, kind
        req.t_done = self._now()
        self.metrics["requests_failed"] += 1
        return req

    def _enforce_deadlines(self, plan: StepPlan) -> List[Request]:
        """The per-step watchdog: fail every request in flight past its
        TTFT or total deadline, charged from its arrival (work it had
        planned this step retracts; the others' streams are unaffected,
        their sampling being keyed per row)."""
        failed: List[Request] = []
        now = self._now()
        reqs: Dict[int, Request] = {}
        for seq in (list(self.scheduler.running.values())
                    + list(self.scheduler.waiting)):
            reqs.setdefault(seq.req.uid, seq.req)
        for req in reqs.values():
            if req.error is not None:
                continue
            age_ms = (now - req.t_enqueue) * 1e3
            if (req.ttft_deadline_ms is not None
                    and req.t_first_token == 0.0
                    and age_ms > req.ttft_deadline_ms):
                which, budget = "ttft", req.ttft_deadline_ms
            elif req.deadline_ms is not None and age_ms > req.deadline_ms:
                which, budget = "total", req.deadline_ms
            else:
                continue
            self.metrics["deadline_misses"] += 1
            failed.append(self._fail_request(
                req, f"{which} deadline of {budget:g} ms exceeded "
                     f"({age_ms:.1f} ms since submit)", ERR_DEADLINE,
                plan=plan))
        return failed

    def _shed(self, reason: str) -> List[Request]:
        """Admission-reject the lowest-value waiter (typed error)."""
        shed: List[Request] = []
        for req in self.scheduler.shed_load(1):
            req.error = f"load shed: {reason}"
            req.error_kind = ERR_SHED
            req.t_done = self._now()
            self.metrics["shed_requests"] += 1
            self.metrics["requests_failed"] += 1
            shed.append(req)
        return shed

    def _handle_stall(self) -> None:
        """An idle plan with work pending breaks the scheduler's contract
        (defer, preempt or reject): raise :class:`SchedulerStall` with the
        queue snapshot.  (The reference's fault layer sheds instead; it is
        not ported.)"""
        waiting, running = (len(self.scheduler.waiting),
                            len(self.scheduler.running))
        snapshot = {
            "step": self._step, "injected": False,
            "waiting": [s.req.uid for s in self.scheduler.waiting],
            "running": {slot: seq.req.uid for slot, seq
                        in sorted(self.scheduler.running.items())}}
        raise SchedulerStall(
            "scheduler made no progress with work pending "
            f"(waiting={waiting}, running={running})", snapshot)

    # -- internals ------------------------------------------------------
    def _seq_key(self, seq) -> torch.Tensor:
        """The sequence's sampling-stream root, ``fold_in(request_root,
        stream + sibling_index)``; position ``t`` then draws with
        ``fold_in(stream_root, t)``."""
        if seq.sample_key is None:
            seq.sample_key = prng.fold_in(
                seq.req.rng_key, seq.req.stream + seq.sibling_index)
        return seq.sample_key

    def _draw(self, logits: torch.Tensor, rows: List[int], make_keys,
              temps: List[float], top_ps: List[float]) -> _Draw:
        """Sample one token from logits row ``rows[j]`` with key
        ``make_keys()[j]``, ``temps[j]`` and ``top_ps[j]`` for each j (rows
        may repeat), and check every logits row for finiteness; both come
        to the host in one copy, which the returned :class:`_Draw` waits
        for.  When every draw is greedy the argmax is the sampler's result
        whatever the keys, so neither the keys nor the draw are computed.
        Without ``nan_guard`` every row counts as finite."""
        if self.nan_guard:
            finite = torch.isfinite(logits).all(dim=-1).to(torch.int64)
        else:
            finite = torch.ones(logits.shape[0], dtype=torch.int64,
                                device=logits.device)
        if all(t <= 0.0 for t in temps):
            # greedy: every row's argmax, picked on the host
            both = torch.cat([torch.argmax(logits, dim=-1), finite])
            return _Draw(both, logits.shape[0], rows)
        # one host-to-card copy: rows, the two key words, t, top_p
        args = self._put(torch.cat([
            torch.tensor(rows, dtype=torch.float64)[:, None],
            make_keys().to(torch.float64),
            torch.tensor([temps, top_ps], dtype=torch.float64).T],
            dim=1), torch.float64)
        tok = sample_logits_per_row(args[:, 1:3].long(),
                                    logits[args[:, 0].long()],
                                    args[:, 3].float(), args[:, 4].float())
        return _Draw(torch.cat([tok.to(torch.int64), finite]), len(rows))

    def _first_tokens(self, logits: torch.Tensor,
                      chunks: List[PrefillChunk]):
        """Draw the first tokens of this step's finishing chunks (chunk
        ``i``'s row of ``logits`` is row ``i``): for a request with
        ``n_samples = n``, ``n`` draws from its one row, sibling ``s`` with
        the key ``fold_in(fold_in(root, stream + s), 0)``.  Returns
        ({chunk index: its tokens}, every row's finiteness)."""
        rows: List[int] = []
        roots: List[torch.Tensor] = []
        streams: List[int] = []
        temps: List[float] = []
        top_ps: List[float] = []
        spans: Dict[int, slice] = {}
        for i, c in enumerate(chunks):
            if not c.last or c.seq.resuming:
                continue
            req = c.seq.req
            n = req.n_samples
            spans[i] = slice(len(rows), len(rows) + n)
            rows += [i] * n
            roots += [req.rng_key] * n
            streams += range(req.stream, req.stream + n)
            temps += [req.temperature] * n
            top_ps += [req.top_p] * n
        toks, finite = self._draw(
            logits, rows, lambda: prng.fold_in(prng.fold_in(
                torch.stack(roots), torch.tensor(streams)), 0),
            temps, top_ps).wait()
        return {i: toks[span] for i, span in spans.items()}, finite

    def _account_energy(self, n_tokens: float, attn_pairs: float,
                        kv_rows_read: float) -> None:
        """Add the modeled energy of one device call to
        ``metrics["energy_joules"]`` (``roofline.step_joules``): the call
        streams the weights once plus the KV rows it touches
        (``kv_rows_read`` reads and one write a token) and runs ``2 P``
        operations a token plus ``4 H hd`` per (query, key) pair a
        layer."""
        if n_tokens <= 0:
            return
        cfg = self.model.cfg
        bytes_moved = (self._param_bytes
                       + (kv_rows_read + n_tokens) * self._kv_row_bytes)
        flops = (2.0 * self._n_params * n_tokens
                 + 4.0 * cfg.n_heads * cfg.hd() * cfg.n_layers
                 * attn_pairs)
        self.metrics["energy_joules"] += step_joules(bytes_moved, flops)

    def _account_prefix_bytes(self, offs: np.ndarray,
                              lens: np.ndarray) -> None:
        """The prefix K/V bytes one chunk step reads, per layer and row:
        the paged kernel fetches ``ceil(prefix / block_size)`` live blocks
        through the page table, where a gather would take every row's
        whole ``max_blocks x block_size`` extent.  The same numbers charge
        the call's energy: the prefix rows are its KV reads, and each row
        attends causally within its own chunk."""
        k = self.cache["attn"]["k"]
        _, _, bs, kvh, hd = k.shape
        mb = self.pager.cfg.max_blocks_per_seq
        n_layers = self.model.cfg.n_layers
        per_pos = 2 * kvh * hd * k.element_size()
        if "ks" in self.cache["attn"]:
            per_pos += 2 * kvh * 4               # f32 dequant scales
        live = lens > 0
        live_tiles = int((-(-offs[live] // bs)).sum())
        self.metrics["prefix_attn_bytes"] += (
            live_tiles * bs * per_pos * n_layers)
        self.metrics["prefix_attn_bytes_gather"] += (
            int(live.sum()) * mb * bs * per_pos * n_layers)
        ln = lens.astype(np.int64)
        pairs = float((ln * offs + ln * (ln + 1) // 2).sum())
        self._account_energy(float(ln.sum()), pairs,
                             float(live_tiles * bs))

    def _run_chunks(self, chunks: List[PrefillChunk]) -> List[Request]:
        """Paged: all of this step's chunks as ONE call padded to the fixed
        ``(max_slots, prefill_chunk_tokens)`` extent; padding rows carry
        slot -1 and write nothing.  Dense: one whole-prompt ``prefill`` per
        chunk, its cache copied into the chunk's slot."""
        if not self.paged:
            return self._run_dense_prefills(chunks)
        failed: List[Request] = []
        nrows, width = self.max_slots, self.prefill_chunk_tokens
        toks = np.zeros((nrows, width), np.int32)
        lens = np.zeros((nrows,), np.int32)
        offs = np.zeros((nrows,), np.int32)
        slots = np.full((nrows,), -1, np.int32)
        for i, c in enumerate(chunks):
            lens[i] = c.end - c.start
            toks[i, :lens[i]] = c.seq.tokens[c.start:c.end]
            offs[i] = c.start
            slots[i] = c.seq.slot
        t0 = self._now()
        logits, self.cache = self.model.prefill_chunk_batch(
            self.params, toks, self.cache, slots, offs,
            page_table=self._host_pt, chunk_lens=lens)
        self.metrics["chunk_batch_calls"] += 1
        self._account_prefix_bytes(offs, lens)
        first, finite = self._first_tokens(logits, chunks)
        self.metrics["t_prefill"] += self._now() - t0
        for i, c in enumerate(chunks):
            seq = c.seq
            if self.scheduler.running.get(seq.slot) is not seq:
                continue
            if not finite[i]:
                self.metrics["nan_rows"] += 1
                failed.append(self._fail_request(
                    seq.req, "non-finite logits during prefill", ERR_NAN,
                    quarantine=True))
                continue
            self._register_blocks(seq)
            self._finish_chunk(c, first.get(i))
        return failed

    def _run_dense_prefills(self, chunks: List[PrefillChunk]
                            ) -> List[Request]:
        failed: List[Request] = []
        for c in chunks:
            t0 = self._now()
            logits, pcache = self.model.prefill(
                self.params, {"tokens": c.seq.tokens[None, c.start:c.end]},
                max_seq=self.max_seq)
            self._merge_slot_cache(c.seq.slot, pcache, c.end)
            first, finite = self._first_tokens(logits, [c])
            self.metrics["t_prefill"] += self._now() - t0
            if not finite[0]:
                self.metrics["nan_rows"] += 1
                failed.append(self._fail_request(
                    c.seq.req, "non-finite logits during prefill", ERR_NAN,
                    quarantine=True))
                continue
            self._finish_chunk(c, first.get(0))
        return failed

    def _merge_slot_cache(self, slot: int, pcache, plen: int) -> None:
        """Copy a (1, max_seq) prefill cache into slot ``slot`` of the
        dense cache (every buffer's batch axis follows its layer axis)."""
        for key, buf in self.cache["attn"].items():
            buf[:, slot] = pcache["attn"][key][:, 0]
        self.cache["lens"][slot] = plen

    def _stop_hit(self, seq, tok: int) -> bool:
        req = seq.req
        return (tok == self.eos_id
                or (req.stop_tokens is not None and tok in req.stop_tokens)
                or len(seq.output) >= req.max_new_tokens
                or seq.kv_len >= self.max_seq - 1)

    def _finish_seq(self, seq) -> Optional[Request]:
        """Retire one sequence; returns the Request when it completed the
        whole request (its group's last sibling, or a singleton)."""
        req = seq.req
        self.scheduler.finish(seq.slot)
        if seq.group is not None:
            seq.group.finished += 1
            if seq.group.finished < seq.group.n:
                return None
        req.t_done = self._now()
        if req.outputs is None:
            req.outputs = [seq.output]
        self.metrics["requests_done"] += 1
        self._preempt_streak = 0     # a completion shows no thrash
        return req

    def _finish_chunk(self, chunk: PrefillChunk, first) -> None:
        """Count the chunk; on the prompt's last chunk take the first output
        token(s) ``first`` drawn from its logits row: ``n`` of them for an
        ``n_samples = n`` request, which then fans out into its siblings."""
        seq, req = chunk.seq, chunk.seq.req
        self.metrics["prefill_chunks"] += 1
        if not chunk.last:
            return
        if seq.resuming:
            # recompute-on-resume: the next token was already sampled
            # before preemption; decode re-feeds it
            seq.resuming = False
            return
        n = req.n_samples
        if n == 1:
            sibs = [seq]
            seq.output.append(int(first[0]))
            req.outputs = [seq.output]
        else:
            sibs = self.scheduler.fork_group(seq)
            for s, tok in zip(sibs, first):
                s.output.append(int(tok))
            req.outputs = [s.output for s in sibs]
            self.metrics["fanouts"] += 1
            self.plan_log[-1].setdefault("forked", []).append((req.uid, n))
            # sibling rows carry the shared prompt length before their
            # first decode; their page-table rows publish at the next
            # step's republish
            self.cache["lens"][[s.slot for s in sibs[1:]]] = seq.kv_len
        req.t_first_token = self._now()
        for s in sibs:
            # a first token can already be terminal (a stop id, eos or
            # max_new_tokens=1): retire the sibling before any decode
            if self._stop_hit(s, s.output[-1]):
                done = self._finish_seq(s)
                if done is not None:
                    self._done_at_prefill.append(done)

    def _register_blocks(self, seq) -> None:
        """Publish every freshly filled full block of ``seq`` into the
        allocator's prefix index, hash-chained on its whole token prefix."""
        if self.pager is None or not self.pager.enable_prefix_cache:
            return
        bs = self.page_size
        full = seq.kv_len // bs
        if full <= seq.registered:
            return
        # the token at pool row i is concat(prompt, output)[i]
        ids = np.concatenate(
            [seq.prompt, np.asarray(seq.output or [], np.int32)])
        for j in range(seq.registered, full):
            parent = seq.block_hashes[j - 1] if j else None
            block = ids[j * bs:(j + 1) * bs]
            h = chain_hash(parent, block)
            seq.block_hashes.append(h)
            self.pager.register_block(seq.slot, j, h, block)
        seq.registered = full

    def _decode_once(self, slots: List[int]) -> List[Request]:
        """One batched decode step over every slot row, dispatched and
        completed back to back (the synchronous path); rows outside
        ``slots`` are ignored and their lengths re-synced after."""
        return self._decode_complete(self._decode_dispatch(slots))

    def _decode_dispatch(self, slots: List[int]) -> _PendingDecode:
        """The token-independent half of a decode step: upload the rows'
        tokens, run the batched ``decode_step`` and the sampling, and start
        the tokens' copy to the host, without waiting for the card.  Row
        ``i`` draws with ``fold_in(stream_key, len(output))`` of its
        sequence."""
        tokens = np.zeros((self.max_slots,), np.int32)
        seqs = [self.scheduler.running[i] for i in slots]
        for i, seq in zip(slots, seqs):
            tokens[i] = seq.output[-1]
        t0 = self._now()
        logits, self.cache = self.model.decode_step(
            self.params, self.cache, self._put(tokens))
        draw = self._draw(
            logits, slots, lambda: prng.fold_in(
                torch.stack([self._seq_key(seq) for seq in seqs]),
                torch.tensor([len(seq.output) for seq in seqs])),
            [seq.req.temperature for seq in seqs],
            [seq.req.top_p for seq in seqs])
        self.metrics["decode_steps"] += 1
        self.metrics["seq_steps"] += len(slots)
        kv_now = sum(seq.kv_len for seq in seqs)
        self._account_energy(float(len(slots)), float(kv_now),
                             float(kv_now))
        return _PendingDecode(slots=slots, draw=draw, t0=t0)

    def _decode_complete(self, p: _PendingDecode) -> List[Request]:
        """The token-dependent half: wait for the tokens, append them,
        register filled blocks, retire stops, re-sync lengths.  ``t_decode``
        is charged from dispatch to here, the host's overlap window
        included, as in the reference."""
        drawn, finite = p.draw.wait()
        nxt = dict(zip(p.slots, drawn))
        self.metrics["t_decode"] += self._now() - p.t0
        finished: List[Request] = []
        for i in p.slots:
            seq = self.scheduler.running.get(i)
            if seq is None or seq.req.error is not None:
                continue
            if not finite[i]:
                self.metrics["nan_rows"] += 1
                finished.append(self._fail_request(
                    seq.req, "non-finite logits during decode", ERR_NAN,
                    quarantine=True))
                continue
            tok = int(nxt[i])
            seq.output.append(tok)
            self.metrics["tokens_out"] += 1
            self._register_blocks(seq)
            if self._stop_hit(seq, tok):
                done = self._finish_seq(seq)
                if done is not None:
                    finished.append(done)
        # the scheduler's lengths are authoritative: decoded rows advanced
        # at planning, finished/free rows drop to 0, a mid-prefill row gets
        # its prefill progress back
        self.cache["lens"] = self._put(self.scheduler.device_lens())
        return finished
