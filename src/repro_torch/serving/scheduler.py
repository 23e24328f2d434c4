"""Continuous-batching scheduler: chunked prefill, mixed steps, preemption.

The port's copy of ``repro/serving/scheduler.py``: host Python, unchanged
but for its imports.

The engine (engine.py) used to fold queueing, admission, prefill, decode,
sampling and metrics into one class, admitting one *full-prompt* prefill
at a time — a long prompt monopolized the device while every running
decode stalled, and mid-decode growth on an oversubscribed pool raised
``OutOfBlocks``.  This module extracts the policy half of that engine
into an explicit Sarathi/vLLM-style scheduler:

  * **Queues.**  ``waiting`` (FIFO of not-yet-admitted sequences, with
    preempted sequences requeued at the *front*) and ``running`` (slot ->
    :class:`Sequence`).  The engine never touches them directly; it asks
    for a plan.
  * **Step plans.**  :meth:`Scheduler.schedule` emits a :class:`StepPlan`
    carrying (a) every running decode and (b) up to
    ``prefill_chunk_tokens`` of prompt-chunk work, so long prompts are
    prefilled in fixed-size chunks *interleaved* with decode steps
    instead of ahead of them.  The engine executes the plan verbatim:
    ALL of a step's chunks as one padded ``model.prefill_chunk_batch``
    call against the paged pool (per-row lengths/offsets are data — no
    same-shape grouping, see docs/ARCHITECTURE.md on shape stability),
    decodes as one batched step.
  * **Prefix reuse.**  Admission hashes the prompt's full blocks and asks
    the allocator for the longest cached run
    (``BlockAllocator.lookup_prefix``); hit blocks are mapped into the
    slot read-only (ref++) and the first prefill chunk starts at
    ``cached_len`` — the shared prefix executes **zero** prefill tokens.
    At least one prompt token is always re-prefilled (the engine needs
    last-token logits to sample from), so ``cached_len`` is capped at the
    last full block strictly before ``len(tokens)``.  Blocks are *leases*:
    release/preempt decrement refcounts, and capacity checks count
    zero-ref cached blocks as reclaimable.
  * **Preemption.**  When a decode needs to grow into a new block and the
    pool is exhausted, a victim is preempted: its leases are dropped
    (``BlockAllocator.release`` — registered blocks park on the LRU with
    KV intact), the request keeps its generated tokens host-side, and it
    is requeued for recompute-on-resume over ``prompt + output[:-1]``
    (chunked, under the same budget; the resume admission re-runs the
    prefix lookup, so a preempted sequence usually remaps its own still-
    cached blocks instead of recomputing), after which decode resumes by
    re-feeding ``output[-1]``.  ``OutOfBlocks`` can no longer reach the
    serving path: the scheduler only grows through
    ``BlockAllocator.can_allocate`` / ``append_cost``.
  * **Starvation bound.**  Victims are picked newest-first among
    sequences preempted fewer than ``preempt_limit`` times; a sequence
    past the limit is exempt unless *every* running sequence is exempt,
    so repeatedly evicted requests eventually hold their slot and finish.
  * **Copy-on-write.**  A decode append that would land in a shared or
    registered block (only reachable for the partial tail block mapped by
    ``BlockAllocator.fork``) re-points the slot at a fresh block and
    records the (src, dst) pair on ``StepPlan.cows``; the engine copies
    the device rows before executing the step's writes.
  * **Progress guarantee.**  Every plan either does work, preempts, or
    rejects a request with ``.error`` (never-fits prompts, oversized
    ``max_new_tokens``, empty prompts) — the engine raises if a plan
    makes no progress while work remains, instead of spinning.
  * **Sampling groups.**  A request with ``n_samples = n > 1`` admits
    *once* (one :class:`SamplingGroup`, one prompt prefill) while its
    admission reserves ``n`` slots and prices the pool as
    ``prompt_blocks + fork_cost`` (``BlockAllocator.fork_cost``).  When
    the prompt's last chunk completes, the engine calls
    :meth:`Scheduler.fork_group`: ``n - 1`` sibling sequences are
    created into the reserved slots, each ``fork``-ing the parent's
    block leases (prompt KV shared read-only, refcounted); the siblings'
    diverging tails un-share lazily through the existing COW path on
    their first appends.  Siblings decode/finish independently but are
    **preempted as a unit** when *external* growth pressure victimizes
    any of them (all planned decodes and COW pairs of the group retract
    in the same step), so a half-evicted group never wedges the pool;
    intra-group contention instead sheds one sibling at a time so the
    grower always makes progress.  A preempted sibling resumes like any
    sequence — recompute over ``prompt + output[:-1]``, which remaps the
    still-registered shared prompt blocks from the prefix index instead
    of recomputing them.

The dense (non-paged) fallback uses the same scheduler with ``pager=None``:
prompts are planned as one whole-prompt chunk (the contiguous cache has
no block granularity to chunk into), preemption never triggers, and
``n_samples > 1`` is rejected (fork/COW need the block pool).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.faults import ERR_CAPACITY, ERR_INVALID
from repro_torch.serving.paged_cache import BlockAllocator


def validate_request(req: Any, max_seq: int, max_slots: int,
                     pager: Optional[BlockAllocator]
                     ) -> Optional[Tuple[str, str]]:
    """Static request validation — everything knowable at ``submit()``
    time, before any scheduling: malformed ``n_samples`` /
    ``max_new_tokens``, empty prompt, a sampling group wider than the
    slot table or on the dense cache, and a (clamped) prompt whose
    blocks could never fit the whole pool.  Returns ``(message,
    error_kind)`` or None.  Pure: the prompt is *not* clamped here —
    admission does that.  The scheduler's ``_admission_error`` re-runs
    these checks as the run-time backstop (resumed sequences regrow
    their token lists; direct ``Scheduler.add`` callers skip submit)."""
    n_samples = getattr(req, "n_samples", 1)
    if n_samples < 1:
        return f"n_samples={n_samples} must be >= 1", ERR_INVALID
    if n_samples > 1:
        if pager is None:
            return ("n_samples > 1 requires the paged KV cache "
                    "(fork/copy-on-write)"), ERR_INVALID
        if n_samples > max_slots:
            return (f"n_samples={n_samples} exceeds "
                    f"max_slots={max_slots}"), ERR_INVALID
    if req.max_new_tokens < 1:
        return (f"max_new_tokens={req.max_new_tokens} must be >= 1",
                ERR_INVALID)
    keep = max_seq - req.max_new_tokens
    if keep <= 0:
        return (f"max_new_tokens={req.max_new_tokens} leaves no "
                f"room for any prompt within max_seq={max_seq}"), ERR_INVALID
    prompt = np.asarray(req.prompt, np.int32).reshape(-1)
    if prompt.size == 0:
        return "empty prompt", ERR_INVALID
    if pager is not None:
        plen = min(int(prompt.size), keep)
        need = pager.blocks_needed(plen)
        if n_samples > 1:
            need += pager.fork_cost(plen, n_samples)
        if need > pager.cfg.n_blocks:
            return (f"sequence needs {need} blocks, pool holds only "
                    f"{pager.cfg.n_blocks}"), ERR_CAPACITY
    return None


@dataclasses.dataclass
class SamplingGroup:
    """One ``n_samples > 1`` request's fanout unit.

    Created at :meth:`Scheduler.add`; ``fanned`` flips when the prompt's
    last chunk completes and :meth:`Scheduler.fork_group` materializes
    the siblings.  The request is done when ``finished == n`` (the
    engine tracks that); ``siblings[i].output`` is the request's
    ``outputs[i]``."""

    req: Any
    n: int
    siblings: List["Sequence"] = dataclasses.field(default_factory=list)
    fanned: bool = False
    finished: int = 0


@dataclasses.dataclass
class Sequence:
    """Scheduler-side state for one request (waiting or running)."""

    req: Any                                 # serving.engine.Request
    prompt: Optional[np.ndarray] = None      # admitted (clamped) prompt
    tokens: Optional[np.ndarray] = None      # rows to prefill this run
    slot: int = -1
    prefilled: int = 0                       # prefill rows already in the pool
    kv_len: int = 0                          # total pool rows (grows in decode)
    order: int = -1                          # admission stamp (victims: newest)
    resuming: bool = False                   # recompute-after-preemption
    cached_len: int = 0                      # prefix rows mapped from cache
    prefix_hashes: Optional[List[int]] = None  # chain hashes of .tokens
    block_hashes: List[int] = dataclasses.field(default_factory=list)
    registered: int = 0                      # full blocks already in the index
    n_preemptions: int = 0                   # starvation-bound counter
    # generated tokens of THIS sequence (for a singleton / sampling-group
    # sibling 0 this is the request's ``output`` list itself; other
    # siblings own their entry of ``req.outputs``)
    output: Optional[List[int]] = None
    group: Optional[SamplingGroup] = None    # n_samples > 1 fanout unit
    sibling_index: int = 0                   # 0 = parent / singleton
    sample_key: Any = None                   # engine-lazy per-stream PRNG key

    @property
    def prefill_done(self) -> bool:
        return self.tokens is not None and self.prefilled >= len(self.tokens)


@dataclasses.dataclass
class PrefillChunk:
    """One prompt chunk: rows [start, end) of ``seq.tokens``."""

    seq: Sequence
    start: int
    end: int

    @property
    def last(self) -> bool:
        return self.end >= len(self.seq.tokens)


@dataclasses.dataclass
class SpecVerify:
    """One planned draft-then-verify decode step for ``seq``.

    The engine feeds ``[output[-1], drafts...]`` as a (k+1)-token chunk
    at ``pos_offset = start`` (the sequence's kv_len when planned),
    samples every position from the verified logits with the per-token
    keyed draws non-speculative decode would have used, and rolls the
    rejected tail back by `BlockAllocator.truncate`.  ``start`` is
    recorded because planning advances ``seq.kv_len`` optimistically by
    ``len(drafts) + 1``."""

    seq: Sequence
    drafts: List[int]
    start: int


@dataclasses.dataclass
class StepPlan:
    """What the engine must execute this step (then plans are discarded —
    the scheduler already advanced its accounting, so a plan is executed
    exactly once, synchronously)."""

    prefills: List[PrefillChunk] = dataclasses.field(default_factory=list)
    decodes: List[int] = dataclasses.field(default_factory=list)   # slot ids
    decode_uids: List[int] = dataclasses.field(default_factory=list)
    # speculative verify steps — decode-phase work a plain decode would
    # otherwise cover (a slot appears in decodes OR verifies, never both)
    verifies: List[SpecVerify] = dataclasses.field(default_factory=list)
    preempted: List[int] = dataclasses.field(default_factory=list)  # uids
    rejected: List[Any] = dataclasses.field(default_factory=list)  # Requests
    # copy-on-write (src, dst) block pairs the engine must copy on-device
    # before executing this step's writes
    cows: List[Tuple[int, int]] = dataclasses.field(default_factory=list)
    # (uid, cached_len) for admissions that mapped a cached prefix
    cached: List[Tuple[int, int]] = dataclasses.field(default_factory=list)
    # (uid, cached_len) for EVERY admission this step (cached_len = 0 on
    # a prefix-cache miss) — per-request cache attribution in metrics
    admitted: List[Tuple[int, int]] = dataclasses.field(default_factory=list)

    def has_work(self) -> bool:
        return bool(self.prefills or self.decodes or self.verifies)

    def made_progress(self) -> bool:
        return bool(self.prefills or self.decodes or self.verifies
                    or self.preempted or self.rejected)

    def summary(self) -> Dict[str, Any]:
        """Compact, host-only trace entry (engine.plan_log; tests assert
        chunk/decode interleaving and prefix-cache skips on it)."""
        return {
            "prefills": [(c.seq.req.uid, c.start, c.end)
                         for c in self.prefills],
            "decodes": list(self.decode_uids),
            "verifies": [(v.seq.req.uid, v.start, len(v.drafts))
                         for v in self.verifies],
            "preempted": list(self.preempted),
            "rejected": [r.uid for r in self.rejected],
            "cows": list(self.cows),
            "cached": list(self.cached),
            "admitted": list(self.admitted),
        }


class Scheduler:
    """Owns admission, chunking, growth and preemption policy.

    ``pager`` is the engine's host-side :class:`BlockAllocator` for the
    paged pool (None for the dense fallback).  The scheduler is the only
    component that allocates/releases blocks; the engine republishes the
    page table once per step and executes plans.
    """

    def __init__(self, max_slots: int, max_seq: int,
                 pager: Optional[BlockAllocator] = None,
                 prefill_chunk_tokens: int = 512,
                 preempt_limit: int = 3,
                 spec_tokens: int = 0,
                 draft_proposer: Any = None):
        if prefill_chunk_tokens < 1:
            raise ValueError("prefill_chunk_tokens must be >= 1")
        if preempt_limit < 1:
            raise ValueError("preempt_limit must be >= 1")
        if spec_tokens < 0:
            raise ValueError("spec_tokens must be >= 0")
        if spec_tokens and pager is None:
            raise ValueError("speculative decoding requires the paged "
                             "pool (rollback is block truncation)")
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.pager = pager
        self.prefill_chunk_tokens = prefill_chunk_tokens
        self.preempt_limit = preempt_limit
        # draft-then-verify decode: propose up to spec_tokens drafts per
        # decode-eligible sequence each step (0 / no proposer = off)
        self.spec_tokens = spec_tokens
        self.proposer = draft_proposer
        self.waiting: Deque[Sequence] = deque()
        self.running: Dict[int, Sequence] = {}
        self.n_preempted = 0
        self._order = 0
        # prefix-cache admission stats (allocator keeps block-level ones)
        self.prefix_stats = {"admissions": 0, "hits": 0, "cached_tokens": 0}

    # -- public API ------------------------------------------------------
    def add(self, req: Any) -> None:
        """Enqueue a request for admission.  Legal at ANY point between
        engine steps — continuous-arrival serving calls this mid-flight
        while earlier requests are still decoding; the new arrival is
        considered at the next ``schedule()``'s admission pass.  FIFO by
        arrival except that preempted sequences requeue at the front
        (resume-before-admit keeps the starvation bound meaningful)."""
        if req.output is None:
            req.output = []
        # sibling 0's stream IS req.output, so singleton callers keep
        # reading/mutating the list they always did
        seq = Sequence(req=req, output=req.output)
        n = getattr(req, "n_samples", 1)
        if n > 1:
            seq.group = SamplingGroup(req=req, n=n, siblings=[seq])
        self.waiting.append(seq)

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    def queue_depth(self) -> int:
        """Sequences admitted to the waiting queue but not yet running —
        the open-loop front-end's backpressure signal.  Preempted
        sequences waiting to resume count too: they hold no blocks
        while queued, so they are demand just like fresh arrivals."""
        return len(self.waiting)

    def request(self, uid: int) -> Optional[Any]:
        """Look up a live request by uid (waiting or running), or None
        once it has finished/failed.  The async front-end holds the
        returned object to stream ``output`` deltas mid-flight."""
        for seq in self.waiting:
            if seq.req.uid == uid:
                return seq.req
        for seq in self.running.values():
            if seq.req.uid == uid:
                return seq.req
        return None

    def device_lens(self) -> np.ndarray:
        """Authoritative per-slot KV lengths (0 for free slots)."""
        lens = np.zeros(self.max_slots, np.int64)
        for slot, seq in self.running.items():
            lens[slot] = seq.kv_len
        return lens

    def finish(self, slot: int) -> None:
        """A sequence completed: release its blocks and free the slot."""
        self.running.pop(slot)
        if self.pager is not None:
            self.pager.release(slot)

    def schedule(self) -> StepPlan:
        """Build this step's plan; mutates allocator + queue state.

        Order matters: decodes first (they may preempt), then prefill
        chunks for already-running sequences, then admissions — all under
        one ``prefill_chunk_tokens`` budget.  Chunk planning never
        preempts; it defers until decodes release blocks.  A final guard
        breaks prefill-vs-prefill block deadlock by preempting the
        newest sequence.
        """
        plan = StepPlan()

        # ---- decodes: every running seq past prefill, oldest first ----
        # (a sequence with a planned verify step skips plain decode — the
        # verify emits its next token(s); failed speculation falls back)
        cands = sorted(self.running.values(), key=lambda s: s.order)
        for seq in cands:
            if self.running.get(seq.slot) is not seq or not seq.prefill_done:
                continue                     # preempted earlier this step
            if self._plan_verify(seq, plan):
                continue                     # spec verify covers this seq
            if not self._grow_for_decode(seq, plan):
                continue                     # seq itself preempted / failed
            plan.decodes.append(seq.slot)
            plan.decode_uids.append(seq.req.uid)
            seq.kv_len += 1                  # the planned step will write it
        if plan.decodes:                     # keep the parallel lists paired
            plan.decodes, plan.decode_uids = map(list, zip(
                *sorted(zip(plan.decodes, plan.decode_uids))))

        # ---- prefill chunks under the token budget --------------------
        budget = self.prefill_chunk_tokens
        for seq in sorted(self.running.values(), key=lambda s: s.order):
            if budget <= 0:
                break
            if self.running.get(seq.slot) is not seq or seq.prefill_done:
                continue
            budget -= self._plan_chunk(seq, budget, plan)

        # ---- admissions (FIFO; head-of-line blocks, preserving order) -
        while budget > 0 and self.waiting:
            seq = self.waiting[0]
            err = self._admission_error(seq)
            if err is not None:
                self.waiting.popleft()
                seq.req.error, seq.req.error_kind = err
                plan.rejected.append(seq.req)
                continue
            # an unfanned sampling group admits once but will need n
            # slots at fanout — reserve its siblings' slots now so the
            # fork can never find the slot table full
            unfanned = seq.group is not None and not seq.group.fanned
            need_slots = seq.group.n if unfanned else 1
            if (len(self.running) + self._slots_reserved()
                    + need_slots > self.max_slots):
                break          # slots busy/reserved: defer, keep order
            # longest cached prefix of *full* blocks, capped so at least
            # one prompt token is re-prefilled (its logits seed sampling)
            bids: List[int] = []
            hashes: List[int] = []
            cached_len = 0
            if self.pager is not None:
                bs = self.pager.cfg.block_size
                if self.pager.enable_prefix_cache:
                    if seq.prefix_hashes is None:  # once per (re)queued seq
                        seq.prefix_hashes = \
                            self.pager.prefix_hashes(seq.tokens)
                    bids, hashes = self.pager.lookup_prefix(
                        seq.tokens, seq.prefix_hashes)
                    k = min(len(bids), (len(seq.tokens) - 1) // bs)
                    bids, hashes = bids[:k], hashes[:k]
                    cached_len = k * bs
                # headroom for NEW blocks after mapping the cached run;
                # a group admission additionally prices the fanout's
                # first divergent appends (fork_cost) so the siblings'
                # COW blocks are there when the fork happens
                extra = (self.pager.fork_cost(len(seq.tokens), seq.group.n)
                         if unfanned else 0)
                first = min(len(seq.tokens) - cached_len, budget,
                            (self.pager.reusable_free_count(bids) - extra)
                            * bs)
            else:
                first = min(len(seq.tokens), budget)
            if first <= 0:
                break          # pool temporarily full: defer until released
            self.waiting.popleft()
            seq.slot = min(set(range(self.max_slots)) - set(self.running))
            seq.order = self._order
            self._order += 1
            self.running[seq.slot] = seq
            self.prefix_stats["admissions"] += 1
            plan.admitted.append((seq.req.uid, cached_len if bids else 0))
            if bids:
                self.pager.acquire_cached(seq.slot, bids)
                seq.block_hashes = list(hashes)
                seq.registered = len(bids)
                seq.cached_len = seq.prefilled = seq.kv_len = cached_len
                self.prefix_stats["hits"] += 1
                self.prefix_stats["cached_tokens"] += cached_len
                plan.cached.append((seq.req.uid, cached_len))
            budget -= self._plan_chunk(seq, budget, plan)

        # ---- deadlock guard: all running mid-prefill, no blocks, no
        # decodes -> evict a victim so the older prefill can proceed ----
        if not plan.has_work() and self.running:
            self._preempt_unit(self._select_victim(), plan)
        return plan

    def fork_group(self, seq: Sequence) -> List[Sequence]:
        """Fan a just-prefilled sampling-group parent out into its
        siblings; returns all ``n`` sequences (parent first).

        Each sibling leases every block the parent holds
        (``BlockAllocator.fork`` — prompt KV shared read-only, refcount
        bumped) and starts fully prefilled at the parent's ``kv_len``;
        the divergent tails un-share through COW on their first appends.
        Slots were reserved at admission, so the fork cannot find the
        slot table full.  The caller (engine) appends each sibling's
        first sampled token and publishes the new page-table rows."""
        group = seq.group
        assert group is not None and not group.fanned and seq.prefill_done
        assert self.pager is not None, "fork needs the paged pool"
        free = sorted(set(range(self.max_slots)) - set(self.running))
        assert len(free) >= group.n - 1, \
            f"fanout of uid={seq.req.uid} found only {len(free)} free " \
            f"slots for {group.n - 1} siblings (reservation broken)"
        group.fanned = True
        group.siblings = [seq]
        for i in range(1, group.n):
            slot = free[i - 1]
            self.pager.fork(seq.slot, slot)
            sib = Sequence(
                req=seq.req, prompt=seq.prompt, tokens=seq.tokens,
                slot=slot, prefilled=seq.prefilled, kv_len=seq.kv_len,
                order=seq.order, cached_len=seq.cached_len,
                block_hashes=list(seq.block_hashes),
                registered=seq.registered,
                n_preemptions=seq.n_preemptions,
                output=[], group=group, sibling_index=i)
            self.running[slot] = sib
            group.siblings.append(sib)
        return group.siblings

    def fail_request(self, req: Any, plan: Optional[StepPlan] = None
                     ) -> None:
        """Tear down *every* sequence of ``req`` — running siblings and
        requeued ones alike (a sampling group fails as a unit, so a
        faulted sibling never leaves the rest racing a dead request).
        Running slots release their block leases; anything ``req`` still
        had planned in ``plan`` (decodes, prefill chunks, COW pairs)
        retracts so the engine never executes work for it.  The caller
        owns setting ``req.error`` / ``req.error_kind``."""
        for slot, seq in list(self.running.items()):
            if seq.req is req and self.running.get(slot) is seq:
                if plan is not None:
                    self._retract_planned(seq, plan)
                self.running.pop(slot)
                if self.pager is not None:
                    self.pager.release(slot)
        self.waiting = deque(s for s in self.waiting if s.req is not req)

    def shed_load(self, k: int = 1) -> List[Any]:
        """Graceful degradation: admission-reject up to ``k`` of the
        lowest-value *waiting* requests (smallest progress first, then
        newest-first) and return them for the engine to mark with a
        typed ``.error``.  Requests with running siblings are exempt —
        shedding targets work not yet holding device state, so dropping
        it frees scheduler pressure without releasing any lease."""
        running_uids = {s.req.uid for s in self.running.values()}
        by_uid: Dict[int, List[Sequence]] = {}
        for s in self.waiting:
            if s.req.uid not in running_uids:
                by_uid.setdefault(s.req.uid, []).append(s)
        if not by_uid:
            return []

        def value(uid: int) -> Tuple[int, int]:
            progress = max(len(s.output or []) for s in by_uid[uid])
            return (progress, -uid)          # least done, then newest

        shed: List[Any] = []
        for uid in sorted(by_uid, key=value)[:k]:
            req = by_uid[uid][0].req
            self.waiting = deque(s for s in self.waiting
                                 if s.req is not req)
            shed.append(req)
        return shed

    # -- internals -------------------------------------------------------
    def _slots_reserved(self) -> int:
        """Slots promised to running-but-unfanned sampling groups."""
        return sum(s.group.n - 1 for s in self.running.values()
                   if s.group is not None and not s.group.fanned)

    def _admission_error(self, seq: Sequence) -> Optional[Tuple[str, str]]:
        """Validate (and on first admission, clamp) a sequence; returns
        ``(error message, error kind)`` to reject with, or None.  Mostly
        a backstop behind submit-time :func:`validate_request` — but the
        pool-fit check re-runs against ``seq.tokens``, which outgrows
        the prompt across preemption/resume cycles."""
        req = seq.req
        if seq.tokens is None:
            # the seed engine's `prompt[-max_seq + max_new_tokens:]`
            # silently flipped to a positive-index slice on oversized
            # max_new_tokens, keeping almost nothing; validate_request
            # rejects that case and we clamp explicitly here.
            err = validate_request(req, self.max_seq, self.max_slots,
                                   self.pager)
            if err is not None:
                return err
            keep = self.max_seq - req.max_new_tokens
            prompt = np.asarray(req.prompt, np.int32).reshape(-1)
            if prompt.size > keep:
                prompt = prompt[-keep:]
            seq.prompt = prompt
            seq.tokens = prompt
        if self.pager is not None:
            need = self.pager.blocks_needed(len(seq.tokens))
            if seq.group is not None and not seq.group.fanned:
                need += self.pager.fork_cost(len(seq.tokens), seq.group.n)
            if need > self.pager.cfg.n_blocks:
                return (f"sequence needs {need} blocks, pool holds only "
                        f"{self.pager.cfg.n_blocks}", ERR_CAPACITY)
        return None

    def _select_victim(self) -> Sequence:
        """Newest-first among sequences under the starvation bound.

        A sequence preempted ``preempt_limit`` times is exempt from
        victim selection unless every running sequence is exempt (the
        progress guarantee needs *someone* evictable); within the exempt
        fallback the newest still goes first, so the oldest survivor
        keeps its slot and eventually finishes."""
        cands = list(self.running.values())
        fair = [s for s in cands if s.n_preemptions < self.preempt_limit]
        # sampling-group siblings share the parent's admission order;
        # the sibling_index tie-break keeps victim choice deterministic
        return max(fair or cands, key=lambda s: (s.order, s.sibling_index))

    def _grow_for_decode(self, seq: Sequence, plan: StepPlan) -> bool:
        """Make room for one more KV row; True iff ``seq`` may decode.

        The append may need a grown block *and* a copy-on-write block
        (when the write position lands in a shared tail —
        ``BlockAllocator.append_cost`` prices both).  Preempts victims
        (``_select_victim``) until the growth fits.  A victim belonging
        to a *different* fanned sampling group takes its whole group
        with it (unit preemption — all of the group's planned decodes
        and COW pairs retract this same step); a victim in ``seq``'s OWN
        group is shed alone, so intra-group contention drains one
        sibling at a time instead of the grower evicting itself.  If
        ``seq`` itself is selected, it is preempted
        (recompute-on-resume) — unless even an empty pool could not hold
        it, in which case it fails with ``.error`` (it could never
        complete)."""
        if self.pager is None:
            return True
        while (self.pager.append_cost(seq.slot, seq.kv_len)
               > self.pager.n_free()):
            victim = self._select_victim()
            if victim is seq:
                whole_pool = self.pager.cfg.n_blocks
                if self.pager.blocks_needed(seq.kv_len + 1) > whole_pool:
                    seq.req.error = (
                        f"sequence grew to {seq.kv_len + 1} tokens "
                        f"({self.pager.blocks_needed(seq.kv_len + 1)} "
                        f"blocks) — more than the whole "
                        f"{whole_pool}-block pool")
                    seq.req.error_kind = ERR_CAPACITY
                    # a group fails as a unit: one sibling that can never
                    # fit dooms the request, so tear every sibling down
                    # (running and requeued alike) instead of leaving the
                    # rest racing a request already rejected
                    doomed = ([seq] if seq.group is None
                              else seq.group.siblings)
                    for s in doomed:
                        if self.running.get(s.slot) is s:
                            self._retract_planned(s, plan)
                            self.running.pop(s.slot)
                            self.pager.release(s.slot)
                    if seq.group is not None:
                        self.waiting = deque(
                            s for s in self.waiting
                            if s.group is not seq.group)
                    plan.rejected.append(seq.req)
                    return False
                self._preempt(seq, plan)
                return False
            if (victim.group is not None and victim.group.fanned
                    and victim.group is seq.group):
                self._preempt(victim, plan)      # shed ONE own sibling
            else:
                self._preempt_unit(victim, plan)
        cow = self.pager.cow_for_append(seq.slot, seq.kv_len)
        if cow is not None:
            plan.cows.append(cow)
        self.pager.ensure(seq.slot, seq.kv_len + 1)
        return True

    def _plan_verify(self, seq: Sequence, plan: StepPlan) -> bool:
        """Plan a draft-then-verify step for ``seq`` if speculation is on
        and a useful draft exists; True iff a verify covers this seq's
        decode this step.

        Speculation is strictly *opportunistic*: it never preempts
        anyone.  Under pool pressure the draft shrinks token by token
        toward zero (the k+1 rows are priced by ``append_cost(..., n)``
        against the free pool) and an empty draft falls back to the
        plain decode path, which owns the preemption policy.  ``k`` is
        further capped by the request's remaining output budget (a
        verify step emits up to k+1 tokens) and by ``max_seq``
        headroom."""
        if self.spec_tokens <= 0 or self.proposer is None \
                or self.pager is None:
            return False
        out = seq.output if seq.output is not None else []
        if not out:
            return False                     # decode re-feeds output[-1]
        k = min(self.spec_tokens,
                seq.req.max_new_tokens - len(out) - 1,
                self.max_seq - 1 - seq.kv_len)
        if k < 1:
            return False
        drafts = [int(t) for t in
                  self.proposer.propose(seq.prompt, out, k)][:k]
        while drafts and (self.pager.append_cost(
                seq.slot, seq.kv_len, len(drafts) + 1)
                > self.pager.n_free()):
            drafts.pop()                     # shrink, never preempt
        if not drafts:
            return False
        start = seq.kv_len
        cow = self.pager.cow_for_append(seq.slot, start)
        if cow is not None:
            plan.cows.append(cow)
        self.pager.ensure(seq.slot, start + len(drafts) + 1)
        plan.verifies.append(SpecVerify(seq=seq, drafts=drafts,
                                        start=start))
        # optimistic: the engine resets kv_len to the accepted length
        # and truncates the slot's lease list after the verify executes
        seq.kv_len = start + len(drafts) + 1
        return True

    def _plan_chunk(self, seq: Sequence, budget: int, plan: StepPlan) -> int:
        """Plan the next prompt chunk for ``seq`` under ``budget`` tokens;
        returns the number of tokens planned (0 = deferred)."""
        start = seq.prefilled
        end = min(len(seq.tokens), start + budget)
        if self.pager is None:
            # dense fallback: the contiguous cache is filled by one-shot
            # prefill, so the "chunk" is always the whole prompt.
            end = len(seq.tokens)
        elif not self.pager.can_allocate(seq.slot, end):
            fit = (len(self.pager.owned[seq.slot]) + self.pager.n_free()) \
                * self.pager.cfg.block_size
            end = min(end, fit)
        if end <= start:
            return 0
        if self.pager is not None:
            self.pager.ensure(seq.slot, end)
        plan.prefills.append(PrefillChunk(seq=seq, start=start, end=end))
        seq.prefilled = end
        seq.kv_len = end
        return end - start

    def _retract_planned(self, seq: Sequence, plan: StepPlan) -> None:
        """Strip everything already planned this step for a sequence
        about to leave ``running``.  A COW planned for it maps a dst
        block that release() is about to free (and that may be re-leased
        within this very plan) — retract it so the engine never copies
        into a reassigned block (the dst is ref-1 exclusive, so lease
        membership identifies the pairs).  Likewise its planned decode:
        the starvation bound (or a group unit-preemption) can evict a
        sequence whose decode was already planned.  Planned prefill
        chunks retract too (the watchdog can fail a mid-prefill request
        after planning)."""
        if self.pager is not None and plan.cows:
            mine = set(self.pager.owned[seq.slot])
            plan.cows[:] = [p for p in plan.cows if p[1] not in mine]
        if seq.slot in plan.decodes:
            i = plan.decodes.index(seq.slot)
            plan.decodes.pop(i)
            plan.decode_uids.pop(i)
        plan.verifies[:] = [v for v in plan.verifies if v.seq is not seq]
        plan.prefills[:] = [c for c in plan.prefills if c.seq is not seq]

    def _preempt_unit(self, seq: Sequence, plan: StepPlan) -> None:
        """Preempt ``seq`` — and, when it belongs to a fanned sampling
        group, every running sibling with it in the same step.  All of
        the group's planned decodes and COW pairs retract together (per
        sibling, in :meth:`_preempt`), so the engine never executes a
        decode or device copy for a half-evicted group.  Siblings are
        requeued lowest-index-first at the waiting front and resume as
        ordinary sequences whose prompt blocks remap from the prefix
        index."""
        group = seq.group
        if group is None or not group.fanned:
            self._preempt(seq, plan)
            return
        members = [s for s in group.siblings
                   if self.running.get(s.slot) is s]
        for s in sorted(members, key=lambda s: s.sibling_index,
                        reverse=True):         # appendleft: sib 0 ends front
            self._preempt(s, plan)

    def _preempt(self, seq: Sequence, plan: StepPlan) -> None:
        """Evict ``seq``: leases dropped (registered blocks stay cached
        at zero refs), request requeued at the front of ``waiting`` with
        its generated tokens preserved.  On resume its KV is recomputed
        (chunked) over ``prompt + output[:-1]`` — re-admission re-runs
        the prefix lookup, so whatever full blocks survived on the LRU
        are remapped rather than recomputed; the final sampled token has
        no KV yet and is re-fed as the next decode input (``resuming``
        suppresses the duplicate first-token sample)."""
        self._retract_planned(seq, plan)
        if self.pager is not None:
            self.pager.release(seq.slot)
        self.running.pop(seq.slot)
        out = list(seq.output if seq.output is not None
                   else (seq.req.output or []))
        if out:
            seq.tokens = np.concatenate(
                [seq.prompt, np.asarray(out[:-1], np.int32)])
            seq.resuming = True
        else:
            seq.tokens = seq.prompt
            seq.resuming = False
        seq.slot = -1
        seq.prefilled = 0
        seq.kv_len = 0
        seq.cached_len = 0
        seq.prefix_hashes = None             # .tokens changed: rehash
        seq.block_hashes = []
        seq.registered = 0
        seq.n_preemptions += 1
        self.n_preempted += 1
        plan.preempted.append(seq.req.uid)
        self.waiting.appendleft(seq)
