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
instead, and so does every model without a paged cache (the SSM and hybrid
families), whatever ``cache_kind`` asks, as in the reference: each admitted
prompt runs as one whole-prompt ``prefill`` whose (1, max_seq) cache is
copied into its slot (every leaf: K/V, conv rings, SSM states), then
decodes with the rest; there are no blocks, so no prefix reuse,
copy-on-write or preemption, and ``n_samples > 1`` and speculation are
rejected as in the reference.  The batched decode step advances every
row; a running row it does not decode (a prompt prefilled in the same
step) keeps its SSM state, which the step would otherwise advance by a
padding token for good (``_held_ssm_rows``; the reference's engine lets
it advance).

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

**Speculative decoding (``spec_tokens > 0``, paged pool).**  A host-side
proposer (``serving/spec_decode.py``: n-gram prompt lookup by default, or a
draft model) guesses up to ``spec_tokens`` next tokens per running
sequence, and the scheduler plans a ``SpecVerify`` in place of that slot's
decode.  All of a step's verifies run as one ``verify_chunk_batch`` call
(the chunk step with logits at every position) padded to the fixed
``(max_slots, spec_tokens + 1)`` extent, after the step's decodes.  Every
position ``j`` is sampled with the key plain decode would have used for
output position ``m + j``, so the drafts decide how many tokens commit per
step, never which.  A rejected tail is rolled back by
``BlockAllocator.truncate`` before the accepted blocks are registered in
the prefix index, so speculative K/V never reaches it.  ``metrics`` counts
``draft_tokens``, ``accepted_tokens``, ``accept_ratio``, ``verify_steps``,
``spec_rollbacks`` and ``verify_compiles``; ``steps_per_token`` falls
below 1 when speculation pays.

**Fault domain (``faults=``).**  A ``FaultPlan`` or ``FaultInjector``
(``serving/faults.py``) fires seeded faults through the engine's hooks.  An
injected step exception fires before the chunk, decode or verify dispatch,
is retried up to ``retry_limit`` times and then fails only the request it
targets (``ERR_FAULT``); a NaN logits row fails its request and quarantines
the blocks it wrote (``ERR_NAN``); every ``audit_interval`` steps the
allocator audits itself before scheduling, repairs what it finds and fails
the leaseholders of corrupted blocks (``ERR_AUDIT``); an idle plan with
work pending sheds the newest waiter, up to ``stall_shed_limit`` stalls in
a row with nothing to shed.  ``fault_log`` records each event; the
``StragglerDetector`` counts ``slow_steps``.  Steps with verifies, or with
a fault layer, run to their end in :meth:`Engine.step_async` too.

**Energy.**  Every device call is charged the roofline energy of the
weights it streams, the KV rows it touches and its operations
(``launch/roofline.step_joules``, H100 constants):
``metrics["energy_joules"]`` is a model, not a measurement.

**Tensor-parallel serving (``mesh=``, paged pool).**  A mesh of n
(``launch/mesh.make_serve_mesh``) is n processes, one a device, each
running this whole engine: the allocator, the scheduler and the sampler
are host code that never sees the mesh, so every rank keeps the same
leases, page tables and streams.  Each rank holds only its shard of the
weights (``sharding.param_specs`` in serve mode; replicated at model size
1, as the reference places them) and of the pool (its KV heads,
``sharding.cache_specs``) and computes replicated: the weights are
all-gathered whole at use, a layer at a time, both paged attentions run on
the rank's KV heads, their output is all-gathered along heads before wo,
and the logits are whole on every rank (``transformer._ServeMesh``).  The
only collectives are those all-gathers and the plan's broadcast: no float
is reduced across ranks, so the streams are the unsharded engine's, bit
for bit.  Deadlines read the clock, and two ranks' clocks differ: rank 0's
plan and its deadline verdicts reach the others by a broadcast each step,
the others check their own plan against it and take its verdicts
(``_agree``), so the ranks cannot part and then wait on each other in a
collective.  Every metric is each rank's own; they agree but for the
clock's (the times and ``slow_steps``).
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
from repro_torch.distribution import collectives as C
from repro_torch.distribution import sharding as sh
from repro_torch.launch.roofline import step_joules, tree_bytes
from repro_torch.models.model import Model, count_params, params_to
from repro_torch.runtime.health import StragglerDetector
from repro_torch.serving.faults import (ERR_AUDIT, ERR_DEADLINE, ERR_FAULT,
                                        ERR_NAN, ERR_SHED, SITE_DECODE,
                                        SITE_PREFILL, FaultInjector,
                                        InjectedFault, SchedulerStall)
from repro_torch.serving.paged_cache import (BlockAllocator, PagedConfig,
                                             chain_hash)
from repro_torch.serving.scheduler import (PrefillChunk, Scheduler,
                                           SpecVerify, StepPlan,
                                           validate_request)
from repro_torch.serving.spec_decode import build_proposer

def check_servable(cfg) -> None:
    """Raise ``NotImplementedError`` for a family the engine cannot serve:
    the audio family.  Its prefill encodes frames before the prompt, and
    the engine prefills tokens alone, as the reference's does (its
    ``Engine._run_chunks`` calls ``model.prefill`` with tokens only, which
    the encoder-decoder's prefill cannot take).  Serve it at the model
    level: ``Model.prefill`` with ``frames`` and ``tokens``, then
    ``Model.decode_step``."""
    if cfg.family == "audio":
        raise NotImplementedError(
            f"{cfg.arch_id}: the audio family is served at the model level "
            "only (Model.prefill with frames and tokens, then "
            "Model.decode_step): the engine prefills tokens alone, as the "
            "reference's engine does, and the encoder needs frames")


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
    ``draw`` holds them on their way to the host.  ``failed`` are the
    requests the fault layer isolated before the dispatch; with no slot
    left there is no draw."""

    slots: List[int]
    failed: List["Request"]
    draw: Optional[_Draw] = None
    t0: float = 0.0


@dataclasses.dataclass
class _PendingStep:
    """A step that :meth:`Engine.step_async` returned before its decode's
    tokens were read; :meth:`Engine.finish_step` completes it."""

    decode: _PendingDecode
    plan: StepPlan
    t_step: float


class Engine:
    """Single-device continuous-batching engine (plan executor).

    ``device`` is where the cache lives and the steps run (the card unless
    ``"cpu"`` is passed); ``params`` are moved there.  ``cache_kind`` is
    ``"paged"`` (the block pool) or ``"dense"`` (a contiguous
    ``max_seq`` reservation per slot); a model without a paged cache
    (``model.supports_paged_cache`` false) takes the dense one.
    ``n_pages`` sizes the pool (default: the full ``max_slots * max_seq``
    reservation);
    shrinking it oversubscribes, which the scheduler absorbs by deferring
    admission and preempting on mid-decode growth.  Requests that could
    never run come back from :meth:`run` with ``.error`` set.  ``seed``
    roots the keys of requests submitted without one.
    ``prefix_caching`` turns the allocator's prefix index on or off,
    ``preempt_limit`` is the scheduler's starvation bound and
    ``nan_guard`` fails a request whose logits row is not finite.
    ``clock`` is None (the wall clock), a callable or an object with
    ``now()`` such as :class:`~repro_torch.serving.faults.SimClock`: every
    time stamp and deadline reads it.  ``faults`` is a ``FaultPlan`` or
    ``FaultInjector``; ``retry_limit`` bounds the retries of a faulted
    dispatch, ``audit_interval`` (0 = never) spaces the allocator's
    self-audits and ``stall_shed_limit`` the stalls with nothing to shed.
    ``shed_after_preempts`` sheds the lowest-value waiter after that many
    preempting steps in a row.  ``spec_tokens`` turns speculation on, with
    ``draft_proposer`` an object with ``propose(prompt, output, k)`` or a
    name for :func:`~repro_torch.serving.spec_decode.build_proposer`
    (None: ``"ngram"``).  ``mesh`` (a ``launch/mesh.Mesh``) serves on this
    rank of a tensor-parallel mesh (module docstring); it needs the paged
    pool, and ``ValueError`` says so for the dense cache or a model
    without a pool.  ``device`` defaults to the mesh's.  The arguments the
    port shares with the reference come in its order."""

    def __init__(self, model: Model, params: Any, max_slots: int = 8,
                 max_seq: int = 1024, eos_id: int = 2, seed: int = 0,
                 cache_kind: str = "paged", page_size: int = 64,
                 n_pages: Optional[int] = None,
                 prefill_chunk_tokens: int = 512,
                 prefix_caching: bool = True, preempt_limit: int = 3,
                 faults: Any = None, clock: Any = None,
                 nan_guard: bool = True, retry_limit: int = 2,
                 audit_interval: int = 0,
                 shed_after_preempts: Optional[int] = None,
                 stall_shed_limit: int = 3,
                 spec_tokens: int = 0, draft_proposer: Any = None,
                 mesh: Any = None, device: Device = None):
        if cache_kind not in ("paged", "dense"):
            raise ValueError(f"cache_kind must be 'paged' or 'dense', got "
                             f"{cache_kind!r}")
        if mesh is not None and (cache_kind != "paged"
                                 or not model.supports_paged_cache):
            raise ValueError("mesh serving requires the paged cache")
        check_servable(model.cfg)
        self.mesh = mesh
        if mesh is not None:
            if device is not None and torch.device(device) not in (
                    mesh.device, torch.device(mesh.device.type)):
                raise ValueError(f"the engine's device {device} is not the "
                                 f"mesh's {mesh.device}")
            device = mesh.device
        self.device = resolve_device(device)
        self.spec_tokens = spec_tokens
        if spec_tokens > 0 and (draft_proposer is None
                                or isinstance(draft_proposer, str)):
            draft_proposer = build_proposer(draft_proposer or "ngram")
        self.draft_proposer = draft_proposer
        if clock is None:
            self._now: Callable[[], float] = time.perf_counter
        elif hasattr(clock, "now"):
            self._now = clock.now
        else:
            self._now = clock
        self._clock = clock
        if faults is not None and not isinstance(faults, FaultInjector):
            faults = FaultInjector(faults)       # a bare FaultPlan
        self.faults: Optional[FaultInjector] = faults
        self.retry_limit = retry_limit           # dispatch retries a step
        self.audit_interval = audit_interval     # 0 = no periodic audit
        self.shed_after_preempts = shed_after_preempts
        self.stall_shed_limit = stall_shed_limit
        self.fault_log: List[Dict[str, Any]] = []
        self.straggler = StragglerDetector(n_hosts=1)
        self.key = prng.prng_key(seed)
        self.model = model
        if mesh is not None and mesh.shape["model"] > 1:
            # held sharded by the serve-mode specs, cut where the tree lies
            # (the host's, from serve.py) before the shards alone move to
            # the device; at model size 1 a sharded placement is
            # replication, as the reference places it
            pspecs = sh.param_specs(model.cfg, params, mesh, mode="serve")
            self.params = sh.Sharded(
                params_to(sh.shard(params, pspecs, mesh), self.device),
                pspecs)
        else:
            self.params = params_to(params, self.device)
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.prefill_chunk_tokens = prefill_chunk_tokens
        self.nan_guard = nan_guard
        self.page_size = page_size
        self.paged = cache_kind == "paged" and model.supports_paged_cache
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
                max_blocks_per_seq=mb, device=self.device, mesh=mesh)
        else:
            self.cache = model.init_cache(max_slots, max_seq,
                                          device=self.device)
        self.scheduler = Scheduler(
            max_slots=max_slots, max_seq=max_seq, pager=self.pager,
            prefill_chunk_tokens=prefill_chunk_tokens,
            preempt_limit=preempt_limit, spec_tokens=spec_tokens,
            draft_proposer=self.draft_proposer)
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
                        "prefill_compiles": 0,
                        # speculation: drafts proposed and accepted, verify
                        # calls and their shape count, rollbacks; seq_steps
                        # counts per-sequence device steps, so
                        # steps_per_token is 1.0 for plain decode
                        "draft_tokens": 0, "accepted_tokens": 0,
                        "verify_steps": 0, "spec_rollbacks": 0,
                        "verify_compiles": 0, "seq_steps": 0,
                        "accept_ratio": 0.0, "steps_per_token": 0.0,
                        # uid -> {cached_tokens, cache_hit}
                        "requests": {},
                        # the fault domain
                        "step_retries": 0, "requests_failed": 0,
                        "requests_rejected": 0, "nan_rows": 0,
                        "deadline_misses": 0, "shed_requests": 0,
                        "stalls": 0, "audit_repairs": 0,
                        "audit_violations": 0, "slow_steps": 0,
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
        self._stall_streak = 0
        self._preempt_streak = 0
        if self.faults is not None:
            self.faults.bind(clock=self._clock, pager=self.pager)

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
        reference: its first tokens decide fanouts and stops.  A step with
        verifies (their truncation and registration follow the tokens
        within the step) or with a fault layer (its isolation reads each
        row's outcome before the step closes) runs to its end and returns
        ``pending=None``."""
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
        self._step_tail(pending.plan, pending.t_step)
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
        stalled = (self.faults is not None
                   and self.faults.pre_step(self._step, self.scheduler))
        if (self.paged and self.audit_interval
                and self._step % self.audit_interval == 0):
            # before schedule(): a corrupted block is quarantined before
            # the allocator can hand it out again
            done.extend(self._run_audit())
            if not self.scheduler.has_work():
                return done, None
        # an injected stall skips scheduling: the engine sees the idle
        # plan a wedged scheduler would give
        plan = StepPlan() if stalled else self.scheduler.schedule()
        now = self._now()
        for req in plan.rejected:
            req.t_done = now
            self.metrics["requests_rejected"] += 1
            done.append(req)
        expired = self._enforce_deadlines(plan, self._agree(
            plan, self._deadline_verdicts()))
        done.extend(expired)
        if not plan.made_progress() and not expired:
            done.extend(self._handle_stall(stalled))
            return done, None
        self._stall_streak = 0
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
        t_step = self._now()
        if plan.prefills:
            done.extend(self._run_chunks(plan.prefills))
            self.metrics["prefill_compiles"] = self.prefill_compile_count()
            self.plan_log[-1]["prefill_compiles"] = \
                self.metrics["prefill_compiles"]
        done.extend(self._done_at_prefill)
        self._done_at_prefill = []
        if plan.decodes:
            if sync or plan.verifies or self.faults is not None:
                done.extend(self._decode_once(plan.decodes))
            else:
                self._pending = _PendingStep(
                    self._decode_dispatch(plan.decodes), plan, t_step)
                return done, self._pending
        if plan.verifies:
            # after the decodes: a verify's truncation frees blocks that
            # re-enter circulation only at the next schedule()
            done.extend(self._run_verifies(plan.verifies))
            self.metrics["verify_compiles"] = self.verify_compile_count()
            self.plan_log[-1]["verify_compiles"] = \
                self.metrics["verify_compiles"]
        self._step_tail(plan, t_step)
        return done, None

    def _step_tail(self, plan: StepPlan, t_step: float) -> None:
        """Accounting after the step's tokens have landed: the speculation
        ratios read ``tokens_out``, the straggler detector the step's
        time, the sharing peaks the refcounts after releases."""
        drafted = self.metrics["draft_tokens"]
        self.metrics["accept_ratio"] = (
            self.metrics["accepted_tokens"] / drafted if drafted else 0.0)
        self.metrics["steps_per_token"] = (
            self.metrics["seq_steps"] / max(1, self.metrics["tokens_out"]))
        if plan.has_work() and self.straggler.record_slow(
                0, self._now() - t_step):
            self.metrics["slow_steps"] += 1
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
        model config on this engine's mesh shape (the counterpart of the
        reference's compile count: one per (pool key, mesh shape))."""
        return self.model.prefill_compile_count(mesh=self.mesh)

    def verify_compile_count(self) -> int:
        """The same count for the speculative verify step, a separate entry
        with its own one-per-pool-key bar."""
        return self.model.verify_compile_count(mesh=self.mesh)

    # -- the fault domain: deadlines, shedding, stalls, audits -----------------
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

    def _nan_row(self, site: str, req: Request) -> None:
        """Count and log one non-finite logits row of ``req``."""
        self.metrics["nan_rows"] += 1
        self.fault_log.append({"step": self._step, "kind": "nan",
                               "site": site, "uid": req.uid})

    def _survive_faults(self, site: str, items: List[Any], uid_of,
                        alive) -> tuple:
        """The fault gate in front of one device batch.  Injected step
        exceptions fire before the call writes the cache, so a retry is
        clean; a fault that outlasts ``retry_limit`` retries fails the
        request it targets, and the surviving rows dispatch without it.
        Returns (surviving items, failed requests)."""
        failed: List[Request] = []
        attempts = 0
        while items:
            try:
                self.faults.raise_if_armed(
                    site, self._step, [uid_of(x) for x in items])
                break
            except InjectedFault as exc:
                attempts += 1
                self.metrics["step_retries"] += 1
                self.fault_log.append(
                    {"step": self._step, "kind": "retry", "site": site,
                     "uid": exc.uid, "attempt": attempts})
                if attempts <= self.retry_limit:
                    continue
                if exc.uid is None:
                    raise    # untargeted and persistent: nothing to isolate
                req = next(s.req for s in self.scheduler.running.values()
                           if s.req.uid == exc.uid)
                failed.append(self._fail_request(
                    req, f"persistent {site}-step fault "
                         f"({attempts} attempts)", ERR_FAULT))
                self.fault_log.append(
                    {"step": self._step, "kind": "isolated", "site": site,
                     "uid": exc.uid, "attempts": attempts})
                items = [x for x in items if alive(x)]
                attempts = 0
        return items, failed

    def _in_flight(self) -> Dict[int, Request]:
        reqs: Dict[int, Request] = {}
        for seq in (list(self.scheduler.running.values())
                    + list(self.scheduler.waiting)):
            reqs.setdefault(seq.req.uid, seq.req)
        return reqs

    def _deadline_verdicts(self) -> List[tuple]:
        """(uid, "ttft" or "total", budget ms, age ms) of every request in
        flight past its TTFT or total deadline, charged from its arrival
        by this rank's clock."""
        out = []
        now = self._now()
        for req in self._in_flight().values():
            if req.error is not None:
                continue
            age_ms = (now - req.t_enqueue) * 1e3
            if (req.ttft_deadline_ms is not None
                    and req.t_first_token == 0.0
                    and age_ms > req.ttft_deadline_ms):
                out.append((req.uid, "ttft", req.ttft_deadline_ms, age_ms))
            elif req.deadline_ms is not None and age_ms > req.deadline_ms:
                out.append((req.uid, "total", req.deadline_ms, age_ms))
        return out

    def _agree(self, plan: StepPlan, verdicts: List[tuple]) -> List[tuple]:
        """On a mesh of more than one rank: broadcast rank 0's step plan
        and deadline verdicts, check this rank's plan against rank 0's
        (``RuntimeError`` where they part: the ranks would otherwise wait
        on each other in a collective) and return rank 0's verdicts.  Off
        a mesh, or on a mesh of one: ``verdicts`` as they are."""
        if self.mesh is None or self.mesh.size == 1:
            return verdicts
        mine = (self._step, plan.summary())
        theirs, verdicts = C.from_rank0((mine, verdicts), self.mesh)
        if theirs != mine:
            raise RuntimeError(
                f"rank {self.mesh.rank} planned step {mine[0]} as {mine[1]}; "
                f"rank 0 planned step {theirs[0]} as {theirs[1]}")
        return verdicts

    def _enforce_deadlines(self, plan: StepPlan,
                           verdicts: List[tuple]) -> List[Request]:
        """The per-step watchdog: fail every request the ``verdicts``
        (:meth:`_deadline_verdicts`) name, past its TTFT or total
        deadline (work it had planned this step retracts; the others'
        streams are unaffected, their sampling being keyed per row)."""
        failed: List[Request] = []
        reqs = self._in_flight()
        for uid, which, budget, age_ms in verdicts:
            req = reqs[uid]
            self.metrics["deadline_misses"] += 1
            self.fault_log.append({"step": self._step, "kind": "deadline",
                                   "uid": req.uid, "budget": which})
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
            self.fault_log.append({"step": self._step, "kind": "shed",
                                   "uid": req.uid})
            shed.append(req)
        return shed

    def _handle_stall(self, injected: bool) -> List[Request]:
        """An idle plan with work pending.  Without a fault layer it breaks
        the scheduler's contract (defer, preempt or reject): raise
        :class:`SchedulerStall` with the queue snapshot.  With one, shed
        the lowest-value waiter and serve on, until ``stall_shed_limit``
        stalls in a row found nothing to shed: then the wedge is real and
        raises too."""
        self.metrics["stalls"] += 1
        self._stall_streak += 1
        waiting, running = (len(self.scheduler.waiting),
                            len(self.scheduler.running))
        snapshot = {
            "step": self._step, "injected": injected,
            "waiting": [s.req.uid for s in self.scheduler.waiting],
            "running": {slot: seq.req.uid for slot, seq
                        in sorted(self.scheduler.running.items())}}
        if self.faults is None:
            raise SchedulerStall(
                "scheduler made no progress with work pending "
                f"(waiting={waiting}, running={running})", snapshot)
        shed = self._shed("scheduler stall with work pending")
        self.fault_log.append({"step": self._step, "kind": "stall",
                               "injected": injected,
                               "shed": [r.uid for r in shed]})
        if not shed and self._stall_streak > self.stall_shed_limit:
            raise SchedulerStall(
                f"scheduler stalled {self._stall_streak} consecutive "
                f"steps with nothing left to shed (waiting={waiting}, "
                f"running={running})", snapshot)
        return shed

    def _run_audit(self) -> List[Request]:
        """The allocator's periodic self-audit (every ``audit_interval``
        steps, before scheduling).  A dirty report is repaired in place --
        corrupted blocks quarantined, free list, LRU and refcounts rebuilt
        -- and exactly the requests leasing corrupted blocks fail."""
        report = self.pager.audit(repair=True)
        if report.clean:
            return []
        self.metrics["audit_repairs"] += 1
        self.metrics["audit_violations"] += len(report.violations)
        victims: Dict[int, Request] = {}
        for slot in report.victim_slots:
            seq = self.scheduler.running.get(slot)
            if seq is not None:
                victims.setdefault(seq.req.uid, seq.req)
        self.fault_log.append(
            {"step": self._step, "kind": "audit",
             "violations": list(report.violations),
             "corrupted_blocks": list(report.corrupted_blocks),
             "victims": sorted(victims)})
        return [self._fail_request(
                    req, "KV blocks quarantined by allocator audit "
                         f"({len(report.corrupted_blocks)} corrupted)",
                    ERR_AUDIT)
                for req in victims.values()]

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
        # a config without attention heads (mamba2-370m) has no pair term;
        # the reference's cfg.hd() divides by its zero heads there
        heads = cfg.n_heads * cfg.hd() if cfg.n_heads else 0
        flops = (2.0 * self._n_params * n_tokens
                 + 4.0 * heads * cfg.n_layers * attn_pairs)
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
        _, _, bs, _, hd = k.shape
        kvh = self.model.cfg.n_kv_heads     # every head, a rank's or not
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
        if self.faults is not None:
            chunks, failed = self._survive_faults(
                SITE_PREFILL, list(chunks),
                uid_of=lambda c: c.seq.req.uid,
                alive=lambda c:
                    self.scheduler.running.get(c.seq.slot) is c.seq)
            if not chunks:
                return failed
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
            page_table=self._host_pt, chunk_lens=lens, mesh=self.mesh)
        self.metrics["chunk_batch_calls"] += 1
        self._account_prefix_bytes(offs, lens)
        if self.faults is not None:
            logits = self.faults.corrupt_logits(
                SITE_PREFILL, self._step, logits,
                [c.seq.req.uid for c in chunks])
        first, finite = self._first_tokens(logits, chunks)
        self.metrics["t_prefill"] += self._now() - t0
        for i, c in enumerate(chunks):
            seq = c.seq
            if self.scheduler.running.get(seq.slot) is not seq:
                continue
            if not finite[i]:
                # the K/V this chunk wrote is suspect: quarantine before
                # anything registers, fail the request (its whole group)
                self._nan_row(SITE_PREFILL, seq.req)
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
        """Copy a (1, ...) prefill cache into slot ``slot`` of the dense
        cache: every leaf (tuples too), cast to the slot cache's dtype, its
        batch axis the first where the prefill leaf has 1 row and the slot
        cache ``max_slots`` (the layer axes come first), as the reference
        finds it; ``lens[slot] = plen``."""
        def merge(dst, src):
            if isinstance(dst, dict):
                for k in dst:
                    merge(dst[k], src[k])
            elif isinstance(dst, tuple):
                for d, s in zip(dst, src):
                    merge(d, s)
            else:
                for ax in range(dst.ndim):
                    if src.shape[ax] == 1 and dst.shape[ax] == self.max_slots:
                        dst.select(ax, slot).copy_(src.select(ax, 0))
                        return

        for key, tree in self.cache.items():
            if key != "lens":
                merge(tree, pcache[key])
        self.cache["lens"][slot] = plen

    def _held_ssm_rows(self, slots: List[int]):
        """The conv rings and SSM states of the running rows outside this
        decode's ``slots`` (a prompt prefilled in this step, a row whose
        dispatch faulted), copied before the batched ``decode_step``
        advances every row by its token.  A K/V row written for such a row
        is overwritten before it is read; a state advanced by a padding
        token is wrong for good, so ``_restore_rows`` writes these copies
        back after the step.  None without SSM state or such rows."""
        rows = [i for i in self.scheduler.running if i not in slots]
        leaves = [(t, t.ndim - (3 if j < 3 else 4))
                  for key, tree in self.cache.items() if key.startswith("ssm")
                  for j, t in enumerate((*tree["conv"], tree["state"]))]
        if not rows or not leaves:
            return None
        idx = self._put(rows, torch.long)
        return idx, [(t, ax, t.index_select(ax, idx)) for t, ax in leaves]

    @staticmethod
    def _restore_rows(held) -> None:
        if held is not None:
            idx, saved = held
            for t, ax, rows in saved:
                t.index_copy_(ax, idx, rows)

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
        failed: List[Request] = []
        if self.faults is not None:
            slots, failed = self._survive_faults(
                SITE_DECODE, list(slots),
                uid_of=lambda s: self.scheduler.running[s].req.uid,
                alive=lambda s: s in self.scheduler.running)
            if not slots:
                return _PendingDecode(slots=[], failed=failed)
        tokens = np.zeros((self.max_slots,), np.int32)
        seqs = [self.scheduler.running[i] for i in slots]
        row_uids: List[Optional[int]] = [None] * self.max_slots
        for i, seq in zip(slots, seqs):
            tokens[i] = seq.output[-1]
            row_uids[i] = seq.req.uid
        t0 = self._now()
        if self.faults is not None:
            self.faults.latency(self._step)    # a simulated slow step
        held = None if self.paged else self._held_ssm_rows(slots)
        logits, self.cache = self.model.decode_step(
            self.params, self.cache, self._put(tokens), mesh=self.mesh)
        self._restore_rows(held)
        if self.faults is not None:
            logits = self.faults.corrupt_logits(SITE_DECODE, self._step,
                                                logits, row_uids)
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
        return _PendingDecode(slots=slots, failed=failed, draw=draw, t0=t0)

    def _decode_complete(self, p: _PendingDecode) -> List[Request]:
        """The token-dependent half: wait for the tokens, append them,
        register filled blocks, retire stops, re-sync lengths.  ``t_decode``
        is charged from dispatch to here, the host's overlap window
        included, as in the reference."""
        if not p.slots:
            self.cache["lens"] = self._put(self.scheduler.device_lens())
            return p.failed
        drawn, finite = p.draw.wait()
        nxt = dict(zip(p.slots, drawn))
        self.metrics["t_decode"] += self._now() - p.t0
        finished: List[Request] = []
        for i in p.slots:
            seq = self.scheduler.running.get(i)
            if seq is None or seq.req.error is not None:
                continue
            if not finite[i]:
                # the row's token is garbage and the K/V row it wrote is
                # suspect: quarantine and fail the request (its group);
                # every other row's draw is its own
                self._nan_row(SITE_DECODE, seq.req)
                p.failed.append(self._fail_request(
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
        finished.extend(p.failed)
        # the scheduler's lengths are authoritative: decoded rows advanced
        # at planning, finished/free rows drop to 0, a mid-prefill row gets
        # its prefill progress back
        self.cache["lens"] = self._put(self.scheduler.device_lens())
        return finished

    def _run_verifies(self, verifies: List[SpecVerify]) -> List[Request]:
        """This step's speculative verifies as ONE ``verify_chunk_batch``
        call padded to the fixed ``(max_slots, spec_tokens + 1)`` extent
        (padding rows carry slot -1 and write nothing, as in the chunk
        step).

        Row ``i`` feeds ``[output[-1], drafts...]`` at positions ``start ..
        start + k`` and gets logits at all ``k + 1``; position ``j`` is
        sampled with ``fold_in(stream_key, m + j)`` (``m`` tokens emitted so
        far), the key plain decode would use, so the stream does not depend
        on the drafts.  The walk appends tokens while they agree with the
        drafts and always commits the first; on disagreement or a stop it
        rolls the slot's lease back to the accepted length with
        ``BlockAllocator.truncate`` before ``_register_blocks``, so the
        prefix index never serves speculative K/V.  The NaN guard reads a
        row's first ``k + 1`` positions only."""
        failed: List[Request] = []
        if self.faults is not None:
            verifies, failed = self._survive_faults(
                SITE_DECODE, list(verifies),
                uid_of=lambda v: v.seq.req.uid,
                alive=lambda v:
                    self.scheduler.running.get(v.seq.slot) is v.seq)
            if not verifies:
                self.cache["lens"] = self._put(self.scheduler.device_lens())
                return failed
        nrows, width = self.max_slots, self.spec_tokens + 1
        toks = np.zeros((nrows, width), np.int32)
        lens = np.zeros((nrows,), np.int32)
        offs = np.zeros((nrows,), np.int32)
        slots = np.full((nrows,), -1, np.int32)
        row_uids: List[Optional[int]] = [None] * nrows
        rows: List[int] = []            # logits rows to sample, flattened
        keys: List[torch.Tensor] = []
        positions: List[int] = []
        temps: List[float] = []
        top_ps: List[float] = []
        for i, v in enumerate(verifies):
            seq = v.seq
            k = len(v.drafts)
            lens[i] = k + 1
            toks[i, 0] = seq.output[-1]
            toks[i, 1:k + 1] = v.drafts
            offs[i] = v.start
            slots[i] = seq.slot
            row_uids[i] = seq.req.uid
            m = len(seq.output)
            rows += range(i * width, i * width + k + 1)
            keys += [self._seq_key(seq)] * (k + 1)
            positions += range(m, m + k + 1)
            temps += [seq.req.temperature] * (k + 1)
            top_ps += [seq.req.top_p] * (k + 1)

        t0 = self._now()
        if self.faults is not None:
            self.faults.latency(self._step)
        logits, self.cache = self.model.verify_chunk_batch(
            self.params, toks, self.cache, slots, offs,
            page_table=self._host_pt, chunk_lens=lens, mesh=self.mesh)
        if self.faults is not None:
            logits = self.faults.corrupt_logits(SITE_DECODE, self._step,
                                                logits, row_uids)
        emitted, finite = self._draw(
            logits.reshape(nrows * width, logits.shape[-1]), rows,
            lambda: prng.fold_in(torch.stack(keys), torch.tensor(positions)),
            temps, top_ps).wait()
        self.metrics["verify_steps"] += 1
        self.metrics["seq_steps"] += len(verifies)
        self.metrics["t_decode"] += self._now() - t0
        # the verify reads the prefix through the same paged path as a
        # chunk: its tile traffic and energy are charged the same way
        self._account_prefix_bytes(offs, lens)

        finished: List[Request] = []
        at = 0                          # row i's draws start at emitted[at]
        for i, v in enumerate(verifies):
            seq = v.seq
            k = len(v.drafts)
            drawn, at = emitted[at:at + k + 1], at + k + 1
            if self.scheduler.running.get(seq.slot) is not seq \
                    or seq.req.error is not None:
                continue         # torn down by an earlier row this step
            if not finite[i * width:i * width + k + 1].all():
                # a poisoned position taints the row's K/V writes:
                # quarantine and fail, as on the decode path
                self._nan_row(SITE_DECODE, seq.req)
                failed.append(self._fail_request(
                    seq.req, "non-finite logits during verify", ERR_NAN,
                    quarantine=True))
                continue
            appended = 0
            stop = False
            for j in range(k + 1):
                tok = int(drawn[j])
                seq.output.append(tok)
                appended += 1
                self.metrics["tokens_out"] += 1
                seq.kv_len = v.start + appended
                stop = self._stop_hit(seq, tok)
                if stop or j >= k or v.drafts[j] != tok:
                    break
            self.metrics["draft_tokens"] += k
            self.metrics["accepted_tokens"] += appended - 1
            if appended <= k:
                self.metrics["spec_rollbacks"] += 1
            # rollback by truncation first, then register: rejected rows
            # can neither stay leased nor reach the prefix index
            self.pager.truncate(seq.slot, seq.kv_len)
            self._register_blocks(seq)
            if stop:
                done = self._finish_seq(seq)
                if done is not None:
                    finished.append(done)
        finished.extend(failed)
        self.cache["lens"] = self._put(self.scheduler.device_lens())
        return finished
