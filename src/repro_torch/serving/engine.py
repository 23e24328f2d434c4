"""Serving engine: executes the Scheduler's step plans over the KV cache.

PyTorch counterpart of ``repro/serving/engine.py`` for greedy requests on
the paged KV pool or the dense per-slot cache.  The
:class:`~repro_torch.serving.scheduler.Scheduler`
owns policy (admission, chunked prefill under a token budget, preemption
with recompute-on-resume, prefix reuse); :class:`Engine` owns mechanism:
each step it republishes the page table, runs the plan's copy-on-write
block copies, runs ALL of the step's prompt chunks as one padded
``prefill_chunk_batch`` call of fixed ``(max_slots, prefill_chunk_tokens)``
extent, runs every running decode as one batched ``decode_step``, and takes
the argmax of each row's logits.  After each chunk or decode it registers
the freshly filled full blocks in the allocator's prefix index, so a later
request with the same prompt prefix maps those blocks and prefills only
the rest.

``cache_kind="dense"`` serves from the contiguous per-slot reservation
instead: each admitted prompt runs as one whole-prompt ``prefill`` whose
(1, max_seq) cache is copied into its slot, then decodes with the rest;
there are no blocks, so no prefix reuse, copy-on-write or preemption, and
``n_samples > 1`` is rejected as in the reference.

Not ported yet (ROADMAP): sampling with ``temperature > 0`` and
``n_samples > 1`` on the paged pool (they need the reference's threefry
keys) come back from :meth:`Engine.run` with ``.error`` set; speculative
decoding, fault injection, async stepping and mesh sharding raise at
construction or call.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.device import Device, resolve_device
from repro_torch.models.model import Model, params_to
from repro_torch.serving.faults import ERR_INVALID, ERR_NAN
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
    temperature: float = 1.0      # only 0 (greedy) is served so far
    n_samples: int = 1            # only 1 is served so far
    stop_tokens: Optional[Sequence[int]] = None  # per-request stop ids
    # filled by the engine:
    output: Optional[List[int]] = None
    outputs: Optional[List[List[int]]] = None
    t_enqueue: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0
    error: Optional[str] = None
    error_kind: Optional[str] = None


def _copy_pool_blocks(attn: Dict[str, torch.Tensor], src: torch.Tensor,
                      dst: torch.Tensor) -> None:
    """Copy whole pool blocks src -> dst across every layer (and the scale
    pools of an int8 pool): the device half of copy-on-write.  The source
    rows are gathered before any destination is written."""
    for buf in attn.values():
        buf[:, dst] = buf[:, src]


class Engine:
    """Single-device continuous-batching engine (plan executor).

    ``device`` is where the cache lives and the steps run (the card unless
    ``"cpu"`` is passed); ``params`` are moved there.  ``cache_kind`` is
    ``"paged"`` (the block pool) or ``"dense"`` (a contiguous
    ``max_seq`` reservation per slot).  ``n_pages`` sizes the pool
    (default: the full ``max_slots * max_seq`` reservation);
    shrinking it oversubscribes, which the scheduler absorbs by deferring
    admission and preempting on mid-decode growth.  Requests that could
    never run come back from :meth:`run` with ``.error`` set."""

    def __init__(self, model: Model, params: Any, max_slots: int = 8,
                 max_seq: int = 1024, eos_id: int = 2,
                 cache_kind: str = "paged", page_size: int = 64,
                 n_pages: Optional[int] = None,
                 prefill_chunk_tokens: int = 512, spec_tokens: int = 0,
                 faults: Any = None, mesh: Any = None,
                 device: Device = None):
        if cache_kind not in ("paged", "dense"):
            raise ValueError(f"cache_kind must be 'paged' or 'dense', got "
                             f"{cache_kind!r}")
        for name, off in (("spec_tokens", spec_tokens),
                          ("faults", faults is not None),
                          ("mesh", mesh is not None)):
            if off:
                raise NotImplementedError(f"Engine({name}) is {NOT_PORTED}")
        self.device = resolve_device(device)
        self.model = model
        self.params = params_to(params, self.device)
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.prefill_chunk_tokens = prefill_chunk_tokens
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
                max_slots=max_slots, max_blocks_per_seq=mb))
            self.cache = model.init_paged_cache(
                max_slots, block_size=page_size, n_blocks=self.n_pages,
                max_blocks_per_seq=mb, device=self.device)
        else:
            self.cache = model.init_cache(max_slots, max_seq,
                                          device=self.device)
        self.scheduler = Scheduler(
            max_slots=max_slots, max_seq=max_seq, pager=self.pager,
            prefill_chunk_tokens=prefill_chunk_tokens)
        self.plan_log: List[Dict[str, Any]] = []
        self.metrics = {"tokens_out": 0, "requests_done": 0,
                        "decode_steps": 0, "t_decode": 0.0,
                        "chunk_batch_calls": 0, "t_prefill": 0.0,
                        "prefill_chunks": 0, "preemptions": 0,
                        "cow_copies": 0, "prefix_hits": 0,
                        "prefix_cached_tokens": 0, "prefix_evictions": 0,
                        "blocks_live_peak": 0,
                        "blocks_saved_by_sharing_peak": 0,
                        "prefill_compiles": 0, "seq_steps": 0,
                        "steps_per_token": 0.0,
                        # uid -> {cached_tokens, cache_hit}
                        "requests": {},
                        "requests_failed": 0, "requests_rejected": 0,
                        "nan_rows": 0}
        self._host_pt: Optional[np.ndarray] = None
        self._done_at_prefill: List[Request] = []
        self._rejected: List[Request] = []
        self._uid = 0

    def _put(self, x, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype).to(self.device)

    # -- public API ---------------------------------------------------------
    def submit(self, prompt: np.ndarray, **kw) -> int:
        """Enqueue a request; returns its uid.  A malformed or not yet
        servable request gets ``.error`` here and comes back from the next
        :meth:`run` without entering the scheduler."""
        self._uid += 1
        req = Request(uid=self._uid, prompt=np.asarray(prompt, np.int32),
                      t_enqueue=time.perf_counter(), output=[], **kw)
        if req.temperature > 0 or (req.n_samples > 1 and self.paged):
            # (the dense cache rejects n_samples > 1 in validate_request,
            # as the reference does)
            err = (f"sampling (temperature > 0, n_samples > 1) is "
                   f"{NOT_PORTED}", ERR_INVALID)
        else:
            err = validate_request(req, self.max_seq, self.max_slots,
                                   self.pager)
        if err is not None:
            req.error, req.error_kind = err
            self._rejected.append(req)
            return req.uid
        self.scheduler.add(req)
        return req.uid

    def run(self, max_steps: int = 10_000) -> List[Request]:
        """Serve until the scheduler drains; returns every finished or
        rejected request."""
        done: List[Request] = []
        for _ in range(max_steps):
            out = self.step()
            if out is None:
                break
            done.extend(out)
        return done

    def step_async(self):
        raise NotImplementedError(f"Engine.step_async is {NOT_PORTED}")

    def step(self) -> Optional[List[Request]]:
        """Execute one scheduler step; returns the requests that completed
        or were rejected during it, or None when the engine is idle."""
        done: List[Request] = []
        now = time.perf_counter()
        for req in self._rejected:
            req.t_done = now
            self.metrics["requests_rejected"] += 1
            done.append(req)
        self._rejected = []
        if not self.scheduler.has_work():
            return done if done else None
        plan = self.scheduler.schedule()
        now = time.perf_counter()
        for req in plan.rejected:
            req.t_done = now
            self.metrics["requests_rejected"] += 1
            done.append(req)
        if not plan.made_progress():
            raise RuntimeError(
                "scheduler made no progress with work pending (waiting="
                f"{len(self.scheduler.waiting)}, running="
                f"{len(self.scheduler.running)})")
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
            self.metrics["prefill_compiles"] = \
                self.model.prefill_compile_count()
            self.plan_log[-1]["prefill_compiles"] = \
                self.metrics["prefill_compiles"]
        done.extend(self._done_at_prefill)
        self._done_at_prefill = []
        if plan.decodes:
            done.extend(self._decode_once(plan.decodes))
        self._step_tail(plan)
        return done

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

    # -- internals ------------------------------------------------------
    def _greedy(self, logits: torch.Tensor):
        """Per-row argmax and finiteness, brought to the host together."""
        both = torch.stack([torch.argmax(logits, dim=-1),
                            torch.isfinite(logits).all(dim=-1).long()])
        nxt, finite = both.cpu().numpy()
        return nxt, finite.astype(bool)

    def _fail_request(self, req: Request, msg: str, kind: str) -> Request:
        """Fail one request whose KV is suspect: quarantine the blocks it
        wrote, release its leases, stamp the typed error."""
        bs = self.page_size
        for slot, seq in list(self.scheduler.running.items()):
            if seq.req is req and self.paged:
                self.pager.quarantine(slot, seq.cached_len // bs)
        self.scheduler.fail_request(req)
        req.error, req.error_kind = msg, kind
        req.t_done = time.perf_counter()
        self.metrics["requests_failed"] += 1
        return req

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
        t0 = time.perf_counter()
        logits, self.cache = self.model.prefill_chunk_batch(
            self.params, toks, self.cache, slots, offs,
            page_table=self._host_pt, chunk_lens=lens)
        nxt, finite = self._greedy(logits)
        self.metrics["t_prefill"] += time.perf_counter() - t0
        self.metrics["chunk_batch_calls"] += 1
        for i, c in enumerate(chunks):
            seq = c.seq
            if self.scheduler.running.get(seq.slot) is not seq:
                continue
            if not finite[i]:
                self.metrics["nan_rows"] += 1
                failed.append(self._fail_request(
                    seq.req, "non-finite logits during prefill", ERR_NAN))
                continue
            self._register_blocks(seq)
            self._finish_chunk(c, int(nxt[i]))
        return failed

    def _run_dense_prefills(self, chunks: List[PrefillChunk]
                            ) -> List[Request]:
        failed: List[Request] = []
        for c in chunks:
            t0 = time.perf_counter()
            logits, pcache = self.model.prefill(
                self.params, {"tokens": c.seq.tokens[None, c.start:c.end]},
                max_seq=self.max_seq)
            self._merge_slot_cache(c.seq.slot, pcache, c.end)
            nxt, finite = self._greedy(logits)
            self.metrics["t_prefill"] += time.perf_counter() - t0
            if not finite[0]:
                self.metrics["nan_rows"] += 1
                failed.append(self._fail_request(
                    c.seq.req, "non-finite logits during prefill", ERR_NAN))
                continue
            self._finish_chunk(c, int(nxt[0]))
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

    def _finish_seq(self, seq) -> Request:
        req = seq.req
        self.scheduler.finish(seq.slot)
        req.t_done = time.perf_counter()
        if req.outputs is None:
            req.outputs = [seq.output]
        self.metrics["requests_done"] += 1
        return req

    def _finish_chunk(self, chunk: PrefillChunk, first: int) -> None:
        """Count the chunk; on the prompt's last chunk take the first output
        token (greedy) from its logits row."""
        seq, req = chunk.seq, chunk.seq.req
        self.metrics["prefill_chunks"] += 1
        if not chunk.last:
            return
        if seq.resuming:
            # recompute-on-resume: the next token was already sampled
            # before preemption; decode re-feeds it
            seq.resuming = False
            return
        seq.output.append(first)
        req.outputs = [seq.output]
        req.t_first_token = time.perf_counter()
        if self._stop_hit(seq, first):
            self._done_at_prefill.append(self._finish_seq(seq))

    def _register_blocks(self, seq) -> None:
        """Publish every freshly filled full block of ``seq`` into the
        allocator's prefix index, hash-chained on its whole token prefix."""
        if not self.paged:
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
        """One batched decode step over every slot row; rows outside
        ``slots`` are ignored and their lengths re-synced after."""
        tokens = np.zeros((self.max_slots,), np.int32)
        for i in slots:
            tokens[i] = self.scheduler.running[i].output[-1]
        t0 = time.perf_counter()
        logits, self.cache = self.model.decode_step(
            self.params, self.cache, self._put(tokens))
        nxt, finite = self._greedy(logits)
        self.metrics["t_decode"] += time.perf_counter() - t0
        self.metrics["decode_steps"] += 1
        self.metrics["seq_steps"] += len(slots)
        finished: List[Request] = []
        for i in slots:
            seq = self.scheduler.running.get(i)
            if seq is None or seq.req.error is not None:
                continue
            if not finite[i]:
                self.metrics["nan_rows"] += 1
                finished.append(self._fail_request(
                    seq.req, "non-finite logits during decode", ERR_NAN))
                continue
            tok = int(nxt[i])
            seq.output.append(tok)
            self.metrics["tokens_out"] += 1
            self._register_blocks(seq)
            if self._stop_hit(seq, tok):
                finished.append(self._finish_seq(seq))
        # the scheduler's lengths are authoritative: decoded rows advanced
        # at planning, finished/free rows drop to 0, a mid-prefill row gets
        # its prefill progress back
        self.cache["lens"] = self._put(self.scheduler.device_lens())
        return finished
