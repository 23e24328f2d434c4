"""Paged KV cache: refcounted copy-on-write block pool + prefix index.

A fixed per-slot reservation (the engine's dense fallback) pins
``max_seq`` KV rows per slot — fine at small scale, but at 32k context ×
128 slots the reservation is ~100% waste for short requests.  Paged
attention (vLLM) fixes this: the cache is a pool of fixed-size *blocks*;
each sequence leases a block list; attention gathers its blocks through
a page table.

Design (jit-friendly — all shapes static):

  pool:        (n_layers, n_blocks, block_size, KVH, hd)  k and v
  page_table:  (max_slots, max_blocks_per_seq) int32 — block ids, -1 free
  lens:        (max_slots,) int32

The allocator is host-side Python (like vLLM's scheduler); device code
only sees dense gathers.  Append of one token touches one (layer, block)
row.  Supports the Q8_0-quantized pool like the contiguous cache
(``quantized=True`` adds per-(position, kv-head) f32 scale pools).

Ownership model (this is the part every caller must respect):

  * Blocks are **leased, not owned**.  Each block carries a refcount —
    the number of slot page tables it appears in.  ``ensure`` hands out
    exclusive (ref 1) writable blocks; ``acquire_cached`` and ``fork``
    map existing blocks into another slot read-only (ref++).
  * A **full, immutable** block may be registered in the prefix index
    under a chain hash ``H_j = hash((H_{j-1}, token_ids[block_j]))`` —
    content-addressed by the whole token prefix, so a lookup walks the
    chain and returns the longest cached run of full blocks.  Registered
    blocks are never written again (appends always land past them).
  * ``release`` only **decrements** refcounts.  A zero-ref registered
    block is not freed: it parks on an LRU list, its KV intact, and is
    reclaimable — ``n_free`` counts it, and allocation evicts the LRU
    (dropping its index entry) only after the true free list runs dry.
    Cached blocks are therefore reclaimable, never leaked.
  * Writing into a **shared** block (ref > 1 — only reachable for the
    partial tail block mapped by ``fork``) must copy-on-write first:
    ``copy_on_write`` re-points the writer's page-table entry at a fresh
    exclusive block and reports the (src, dst) pair so the engine can
    copy the device rows before the write lands.

The serving engine (engine.py) owns a :class:`BlockAllocator` host-side
and a device pool built by ``models.transformer.init_paged_cache``; decode
attention reads the pool through the page table (the
``paged_decode_attention`` CUDA kernel on the card) -- shared blocks need no
kernel changes, the page table indirection already handles many-to-one maps.

This is the port's copy of ``repro/serving/paged_cache.py``: the allocator
is host Python and numpy; the pool helpers (``init_pool``, ``append_token``,
``gather_view`` and the ``PagedKVCache`` facade) are plain PyTorch, on the
card unless ``device="cpu"``.  The engine keeps its pool in
``models/transformer.py`` (``init_paged_cache``); these are the reference's
standalone helpers, with its numerics: quantized pools write through
``quantize_rows``, the dense cache's quantizer.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.device import Device, resolve_device
from repro_torch.core.quantization import quantize_rows



class OutOfBlocks(RuntimeError):
    pass


@dataclasses.dataclass
class AuditReport:
    """Result of :meth:`BlockAllocator.audit`.

    ``violations`` are human-readable invariant breaks; ``corrupted_blocks``
    are block ids whose *content* can no longer be trusted (wrong
    refcount, multiple ownership states while leased); ``victim_slots``
    are the slots leasing a corrupted block — the engine fails exactly
    those leaseholders.  ``repaired`` flips when the allocator rebuilt
    itself back to a coherent state."""

    violations: List[str] = dataclasses.field(default_factory=list)
    corrupted_blocks: List[int] = dataclasses.field(default_factory=list)
    victim_slots: List[int] = dataclasses.field(default_factory=list)
    repaired: bool = False

    @property
    def clean(self) -> bool:
        return not self.violations


def chain_hash(parent: Optional[int], tokens) -> int:
    """Content hash of one full block given its prefix chain.

    Keyed on (parent hash, token ids) so equal hashes mean equal whole
    prefixes — a block is only reusable together with everything before
    it.  Python's tuple hash is stable within a process, which is the
    allocator's lifetime."""
    return hash((parent, tuple(int(t) for t in tokens)))


def prefix_block_hashes(tokens, block_size: int) -> List[int]:
    """Chain hashes for every *full* block of ``tokens`` (partial tail
    excluded — only immutable, completely-filled blocks are cacheable)."""
    out: List[int] = []
    h: Optional[int] = None
    for j in range(len(tokens) // block_size):
        h = chain_hash(h, tokens[j * block_size:(j + 1) * block_size])
        out.append(h)
    return out


@dataclasses.dataclass
class PagedConfig:
    n_layers: int
    n_kv_heads: int
    head_dim: int
    block_size: int = 64
    n_blocks: int = 256
    max_slots: int = 8
    max_blocks_per_seq: int = 64
    dtype: str = "float32"
    quantized: bool = False     # int8 codes + f32 per-(pos, kv-head) scales


class BlockAllocator:
    """Host-side refcounted allocator with per-slot block *leases*.

    ``owned[slot]`` is the slot's page-table prefix — a list of block ids
    it leases.  The same id may appear in several slots' lists (shared
    prefix / fork); ``refcount[id]`` counts those appearances.  Zero-ref
    blocks live either on ``free`` (content dead) or ``lru`` (registered
    in the prefix index, content intact, reclaimable in LRU order).
    """

    def __init__(self, cfg: PagedConfig, enable_prefix_cache: bool = True):
        self.cfg = cfg
        self.enable_prefix_cache = enable_prefix_cache
        self.free: List[int] = list(range(cfg.n_blocks))[::-1]
        self.owned: List[List[int]] = [[] for _ in range(cfg.max_slots)]
        self.refcount: List[int] = [0] * cfg.n_blocks
        # content hash of a registered full block (None = mutable/partial)
        self.block_hash: List[Optional[int]] = [None] * cfg.n_blocks
        # registered block's actual token ids — lookup verifies these, so
        # a chain_hash collision degrades to a miss, never to serving
        # another prefix's KV
        self.block_tokens: Dict[int, Tuple[int, ...]] = {}
        # chain hash -> canonical block id holding that whole prefix
        self.index: Dict[int, int] = {}
        # zero-ref registered blocks, least-recently-released first
        self.lru: "OrderedDict[int, None]" = OrderedDict()
        self.stats = {"lookups": 0, "hit_blocks": 0, "evictions": 0,
                      "cow_copies": 0}

    def blocks_needed(self, length: int) -> int:
        return -(-length // self.cfg.block_size)

    def can_allocate(self, slot: int, length: int) -> bool:
        """True iff :meth:`ensure`\\ (slot, length) would succeed right now.

        The scheduler uses this to decide between admitting a prefill
        chunk, deferring it, and preempting a victim — without ever
        tripping :class:`OutOfBlocks` on the serving path."""
        need = self.blocks_needed(length) - len(self.owned[slot])
        return need <= self.n_free()

    def n_free(self) -> int:
        """Reclaimable blocks: truly free + zero-ref cached (LRU)."""
        return len(self.free) + len(self.lru)

    def n_cached(self) -> int:
        """Zero-ref blocks currently held for prefix reuse."""
        return len(self.lru)

    def _pop_block(self) -> int:
        """Take a writable block: free list first, then evict the LRU
        zero-ref cached block (dropping its prefix-index entry)."""
        if self.free:
            return self.free.pop()
        if self.lru:
            bid, _ = self.lru.popitem(last=False)
            h = self.block_hash[bid]
            if h is not None and self.index.get(h) == bid:
                del self.index[h]
            self.block_hash[bid] = None
            self.block_tokens.pop(bid, None)
            self.stats["evictions"] += 1
            return bid
        raise OutOfBlocks(f"pool exhausted ({self.cfg.n_blocks} blocks)")

    def ensure(self, slot: int, length: int) -> List[int]:
        """Grow slot's lease list with fresh exclusive blocks to cover
        ``length`` tokens (cached prefix blocks must already have been
        mapped via :meth:`acquire_cached`)."""
        need = self.blocks_needed(length)
        cur = self.owned[slot]
        while len(cur) < need:
            bid = self._pop_block()
            assert self.refcount[bid] == 0
            self.refcount[bid] = 1
            cur.append(bid)
        return cur

    def _deref(self, bid: int) -> None:
        self.refcount[bid] -= 1
        assert self.refcount[bid] >= 0, f"double-free of block {bid}"
        if self.refcount[bid]:
            return
        h = self.block_hash[bid]
        if h is not None and self.index.get(h) == bid:
            self.lru[bid] = None          # newest end; content stays valid
        else:
            self.block_hash[bid] = None
            self.block_tokens.pop(bid, None)
            self.free.append(bid)

    def release(self, slot: int) -> None:
        """Drop every lease ``slot`` holds (finish or preemption).

        This only *decrements* refcounts: blocks shared with other slots
        stay live, and zero-ref registered blocks park on the LRU with
        their KV intact so a later request (or this one resuming after
        preemption) can remap them instead of recomputing."""
        blocks, self.owned[slot] = self.owned[slot], []
        for bid in reversed(blocks):
            self._deref(bid)

    def truncate(self, slot: int, length: int) -> int:
        """Shrink ``slot``'s lease list to cover exactly ``length`` tokens
        — speculative-decode rollback as *truncation*: rejected tail
        tokens are un-appended and their blocks flow back through the
        ordinary release paths (no new reclaim machinery).

        A dropped block that this slot holds exclusively is
        **unregistered** before deref — if the engine registered it while
        its content was still speculative, parking it on the LRU would
        let the prefix index serve rejected KV.  A dropped block with
        other leaseholders is merely deref'd: shared content predates the
        speculation (fork/prefix sharing) and stays valid for its other
        holders.  Returns the number of blocks dropped."""
        keep = self.blocks_needed(length)
        cur = self.owned[slot]
        dropped = 0
        while len(cur) > keep:
            bid = cur.pop()
            if self.refcount[bid] == 1:
                self._unregister(bid)
            self._deref(bid)
            dropped += 1
        return dropped

    # -- prefix cache -----------------------------------------------------
    def prefix_hashes(self, tokens) -> List[int]:
        """Chain hashes of ``tokens``' full blocks, counted as ONE lookup.

        The hashes depend only on the tokens, not on allocator state —
        the scheduler computes them once per sequence and re-walks the
        index for free on every deferred-admission retry."""
        self.stats["lookups"] += 1
        return prefix_block_hashes(tokens, self.cfg.block_size)

    def lookup_prefix(self, tokens, hashes: Optional[List[int]] = None
                      ) -> Tuple[List[int], List[int]]:
        """Longest cached run of full blocks matching ``tokens``.

        Returns (block ids, chain hashes), both possibly empty.  Walks the
        hash chain from the root; the first miss ends the run, so the
        result is always a contiguous prefix whose every block is either
        leased (live) or parked on the LRU (content intact) — eviction
        removes index entries, so presence in the index implies validity.
        Each hit's stored token ids are compared against the query
        (``hash()`` is not collision-free); because the walk verifies
        every block from the root, a match means the whole prefix's
        tokens are identical, never just hash-equal.  Pass precomputed
        ``hashes`` (:meth:`prefix_hashes`) to skip re-hashing the prompt
        on retries."""
        if not self.enable_prefix_cache:
            return [], []
        if hashes is None:
            hashes = self.prefix_hashes(tokens)
        bs = self.cfg.block_size
        bids: List[int] = []
        out: List[int] = []
        for j, h in enumerate(hashes):
            bid = self.index.get(h)
            if bid is None:
                break
            block = tuple(int(t) for t in tokens[j * bs:(j + 1) * bs])
            if self.block_tokens.get(bid) != block:
                break
            bids.append(bid)
            out.append(h)
        return bids, out

    def reusable_free_count(self, bids: Sequence[int]) -> int:
        """``n_free()`` minus the blocks in ``bids`` that are currently
        zero-ref (i.e. would come off the LRU if acquired) — the headroom
        left for *new* allocations after mapping that cached prefix."""
        return self.n_free() - sum(1 for b in set(bids)
                                   if self.refcount[b] == 0)

    def acquire_cached(self, slot: int, bids: Sequence[int]) -> None:
        """Map a looked-up cached prefix into ``slot`` read-only (ref++).

        Must be the slot's first mapping (admission) so the blocks form
        the page-table prefix that positions 0..k*bs-1 read through."""
        assert not self.owned[slot], "cached prefix must be mapped first"
        for bid in bids:
            if self.refcount[bid] == 0:
                self.lru.pop(bid)
            self.refcount[bid] += 1
            self.owned[slot].append(bid)
        self.stats["hit_blocks"] += len(bids)

    def register_block(self, slot: int, block_index: int, h: int,
                       tokens) -> None:
        """Publish a freshly-filled *full* block into the prefix index.

        The caller (engine) computes ``h`` over ``tokens`` — the block's
        token ids — chained on its parent; the ids are stored so lookups
        can verify them against the query.  If another block already
        canonically holds this prefix the index keeps it (no dedupe of
        duplicate content — this block still records its hash and simply
        frees on zero-ref instead of parking)."""
        if not self.enable_prefix_cache:
            return
        bid = self.owned[slot][block_index]
        if self.block_hash[bid] is not None:
            return                        # already registered (cached hit)
        self.block_hash[bid] = h
        self.block_tokens[bid] = tuple(int(t) for t in tokens)
        self.index.setdefault(h, bid)

    # -- fork / copy-on-write ---------------------------------------------
    def fork(self, src_slot: int, dst_slot: int) -> List[int]:
        """Lease every block of ``src_slot`` to ``dst_slot`` too (ref++).

        Both slots now read the same pool rows; the first append either
        side makes into the shared partial tail must go through
        :meth:`copy_on_write` first."""
        assert not self.owned[dst_slot], "fork target must be empty"
        for bid in self.owned[src_slot]:
            self.refcount[bid] += 1
        self.owned[dst_slot] = list(self.owned[src_slot])
        return self.owned[dst_slot]

    def copy_on_write(self, slot: int,
                      block_index: int) -> Optional[Tuple[int, int]]:
        """Make ``owned[slot][block_index]`` exclusively writable.

        Returns (src, dst) block ids when a copy is needed — the caller
        must copy the device rows src -> dst before writing — or None if
        the block is already exclusive and unregistered (mutable)."""
        bid = self.owned[slot][block_index]
        if self.refcount[bid] == 1 and self.block_hash[bid] is None:
            return None
        new = self._pop_block()
        assert self.refcount[new] == 0
        self.refcount[new] = 1
        self.owned[slot][block_index] = new
        self._deref(bid)
        self.stats["cow_copies"] += 1
        return bid, new

    def fork_cost(self, length: int, n: int) -> int:
        """Fresh blocks the first divergent token of every sibling needs
        after fanning a ``length``-token sequence out into ``n`` forks.

        Fork itself allocates nothing (ref++ only); the cost lands when
        each sibling writes its first own token:

          * ``length`` block-aligned — the shared tail is full (and
            registered, hence immutable), so *every* sibling opens a
            fresh block: ``n``.
          * partial tail — ``n - 1`` copy-on-write blocks (the last
            writer keeps the original once its refcount drops to 1).

        Admission prices a sampling group as ``blocks_needed(prompt) +
        fork_cost`` so the fanout's first decode step never finds the
        pool so tight that every sibling must immediately preempt."""
        if n <= 1:
            return 0
        return n if length % self.cfg.block_size == 0 else n - 1

    def append_cost(self, slot: int, pos: int, n: int = 1) -> int:
        """New blocks an ``n``-row append at ``pos..pos+n-1`` would take:
        the grown blocks (any the extension opens) plus a COW copy (if
        ``pos`` lands in a block this slot cannot write — shared or
        registered; only the *first* position can, every later one lands
        in a freshly grown exclusive block).  ``n > 1`` prices a
        speculative verify step's k+1 rows."""
        need = max(0, self.blocks_needed(pos + n) - len(self.owned[slot]))
        bi = pos // self.cfg.block_size
        if pos % self.cfg.block_size and bi < len(self.owned[slot]):
            bid = self.owned[slot][bi]
            if self.refcount[bid] > 1 or self.block_hash[bid] is not None:
                need += 1
        return need

    def cow_for_append(self, slot: int,
                       pos: int) -> Optional[Tuple[int, int]]:
        """COW (if required) the block a one-row append at ``pos`` will
        write into; None when the write target is already exclusive."""
        if pos % self.cfg.block_size == 0:
            return None                   # lands in a brand-new block
        bi = pos // self.cfg.block_size
        if bi >= len(self.owned[slot]):
            return None
        return self.copy_on_write(slot, bi)

    # -- accounting --------------------------------------------------------
    def utilization(self) -> float:
        """Fraction of the pool pinned by live leases (reclaimable cached
        blocks count as free — they are capacity, not occupancy)."""
        return (self.cfg.n_blocks - self.n_free()) / self.cfg.n_blocks

    def page_table(self) -> np.ndarray:
        pt = np.full((self.cfg.max_slots, self.cfg.max_blocks_per_seq),
                     -1, np.int32)
        for s, blocks in enumerate(self.owned):
            pt[s, : len(blocks)] = blocks
        return pt

    def audit(self, repair: bool = False) -> AuditReport:
        """Check (and with ``repair=True`` restore) the global
        invariants: every block in exactly one of {free, LRU, leased};
        refcounts equal lease multiplicity; prefix-index entries
        coherent.

        Detection never mutates.  Repair treats the page tables
        (``owned``) as the ground truth — they are what the device
        actually reads through — and rebuilds everything else around
        them: corrupted blocks are quarantined (prefix-index entry
        dropped, registration cleared — their KV is never served to a
        future prefix lookup), refcounts are reset to lease
        multiplicity, stale index entries are deleted, and the free
        list / LRU are rebuilt (order-preserving, deduplicated).  The
        caller decides what to do about ``victim_slots`` — the engine
        fails exactly those leaseholders and releases their leases,
        after which the pool is coherent again."""
        rep = AuditReport()
        n = self.cfg.n_blocks
        lease_count = [0] * n
        holders: Dict[int, List[int]] = {}
        for s, blocks in enumerate(self.owned):
            for bid in blocks:
                lease_count[bid] += 1
                holders.setdefault(bid, []).append(s)
        corrupted = set()
        free_set = set()
        for bid in self.free:
            if bid in free_set:
                rep.violations.append(
                    f"block {bid} duplicated on the free list")
            free_set.add(bid)
        for bid in range(n):
            states = (int(bid in free_set) + int(bid in self.lru)
                      + int(lease_count[bid] > 0))
            if states != 1:
                rep.violations.append(
                    f"block {bid} in {states} ownership states "
                    f"(free={bid in free_set}, cached={bid in self.lru}, "
                    f"leases={lease_count[bid]})")
                if lease_count[bid] > 0:
                    corrupted.add(bid)
            if self.refcount[bid] != lease_count[bid]:
                rep.violations.append(
                    f"block {bid}: refcount {self.refcount[bid]} != "
                    f"{lease_count[bid]} leases")
                corrupted.add(bid)
            if bid in free_set and self.block_hash[bid] is not None:
                rep.violations.append(f"free block {bid} still registered")
            if bid in self.lru:
                h = self.block_hash[bid]
                if h is None or self.index.get(h) != bid:
                    rep.violations.append(
                        f"cached block {bid} lost its index entry")
            if (self.block_hash[bid] is not None) != \
                    (bid in self.block_tokens):
                rep.violations.append(
                    f"block {bid}: hash/token-id records out of sync")
        for h, bid in self.index.items():
            if not (0 <= bid < n) or self.block_hash[bid] != h:
                rep.violations.append(
                    f"index entry {h} -> block {bid} is stale")
        rep.corrupted_blocks = sorted(corrupted)
        rep.victim_slots = sorted(
            {s for bid in corrupted for s in holders.get(bid, [])})
        if repair and rep.violations:
            self._repair(lease_count, corrupted)
            rep.repaired = True
        return rep

    def _unregister(self, bid: int) -> None:
        """Drop a block's prefix-index presence and registration."""
        h = self.block_hash[bid]
        if h is not None and self.index.get(h) == bid:
            del self.index[h]
        self.block_hash[bid] = None
        self.block_tokens.pop(bid, None)

    def _repair(self, lease_count: List[int], corrupted) -> None:
        """Rebuild derived state around the page tables (see audit())."""
        n = self.cfg.n_blocks
        for bid in corrupted:
            self._unregister(bid)
        # stale / dangling index entries
        for h, bid in list(self.index.items()):
            if not (0 <= bid < n) or self.block_hash[bid] != h:
                del self.index[h]
        # hash-without-tokens (or the reverse) is unverifiable by
        # lookup_prefix: drop the registration
        for bid in range(n):
            if (self.block_hash[bid] is not None) != \
                    (bid in self.block_tokens):
                self._unregister(bid)
        self.refcount = list(lease_count)

        def parked(bid: int) -> bool:
            h = self.block_hash[bid]
            return (lease_count[bid] == 0 and h is not None
                    and self.index.get(h) == bid)

        # LRU keeps its eviction order for still-valid entries; zero-ref
        # registered blocks found elsewhere (e.g. wrongly freed) park at
        # the newest end instead of losing their cached KV
        new_lru = OrderedDict(
            (bid, None) for bid in self.lru if parked(bid))
        placed = set(new_lru)
        new_free: List[int] = []
        for bid in list(self.free) + list(range(n)):
            if bid in placed or lease_count[bid] > 0:
                continue
            placed.add(bid)
            if parked(bid):
                new_lru[bid] = None
            else:
                self._unregister(bid)
                new_free.append(bid)
        self.lru = new_lru
        self.free = new_free

    def quarantine(self, slot: int, start_block: int = 0) -> None:
        """Mark ``slot``'s leased blocks from ``start_block`` on as
        suspect (e.g. the sequence produced non-finite logits, so the KV
        it wrote cannot be trusted): their prefix-index entries drop and
        their registrations clear, so ``release`` frees them instead of
        parking them on the LRU — poisoned KV never survives to back a
        later prefix hit.  Blocks below ``start_block`` (a mapped cached
        prefix that predates the fault) stay registered."""
        for bid in self.owned[slot][start_block:]:
            self._unregister(bid)

    def debug_check(self) -> None:
        """Assert the global invariants (tests call this after every
        op); the detection half of :meth:`audit`, kept assert-style for
        test ergonomics."""
        rep = self.audit(repair=False)
        assert rep.clean, ("allocator invariants violated: "
                           + "; ".join(rep.violations))


def init_pool(cfg: PagedConfig, device: Device = None) -> Dict[str, torch.Tensor]:
    """Zeroed K/V pools (n_layers, n_blocks, block_size, KVH, hd) in
    ``cfg.dtype``, or int8 codes with f32 scale pools ``ks`` / ``vs``
    (n_layers, n_blocks, block_size, KVH) for a quantized pool."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, cfg.n_blocks, cfg.block_size, cfg.n_kv_heads,
             cfg.head_dim)
    dt = torch.int8 if cfg.quantized else getattr(torch, cfg.dtype)
    pool = {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}
    if cfg.quantized:
        pool["ks"] = torch.zeros(shape[:-1], dtype=torch.float32, device=dev)
        pool["vs"] = torch.zeros_like(pool["ks"])
    return pool


def append_token(pool, page_table: torch.Tensor, lens: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor):
    """Write one token's K/V for every layer at each slot's current (block,
    offset): k_new / v_new (L, B, KVH, hd), ``page_table`` (B, MB), ``lens``
    (B,) the lengths before the append.  Slots are written in order, and a
    -1 block id indexes from the end, as the reference's scatter does.
    Quantized pools quantize the new rows (``quantize_rows``).  The pool is
    written in place, as the port's caches are (the reference returns a
    new one); returns it and ``lens + 1``."""
    bs = pool["k"].shape[2]
    lens = lens.long()
    blk_id = torch.gather(page_table.long(), 1, (lens // bs)[:, None])[:, 0]
    blk_off = lens % bs
    if "ks" in pool:
        kq, ks = quantize_rows(k_new)
        vq, vs = quantize_rows(v_new)
        upd = {"k": kq, "v": vq, "ks": ks, "vs": vs}
    else:
        upd = {"k": k_new, "v": v_new}
    for name, new in upd.items():
        buf = pool[name]
        for b in range(new.shape[1]):
            buf[:, int(blk_id[b]), int(blk_off[b])] = new[:, b].to(buf.dtype)
    return pool, (lens + 1).to(torch.int32)


def gather_view(pool, page_table: torch.Tensor, lens: torch.Tensor):
    """Each slot's contiguous (L, B, MB * block_size, KVH, hd) view through
    the page table (-1 entries read block 0; ``lens`` masks them for the
    reader), with the gathered (L, B, MB * block_size, KVH) scales of a
    quantized pool: (k, v) or (k, v, ks, vs)."""
    l, _, bs, kvh, hd = pool["k"].shape
    b, mb = page_table.shape
    safe = torch.clamp(page_table.long(), min=0)
    k = pool["k"][:, safe].reshape(l, b, mb * bs, kvh, hd)
    v = pool["v"][:, safe].reshape(l, b, mb * bs, kvh, hd)
    if "ks" in pool:
        ks = pool["ks"][:, safe].reshape(l, b, mb * bs, kvh)
        vs = pool["vs"][:, safe].reshape(l, b, mb * bs, kvh)
        return k, v, ks, vs
    return k, v


class PagedKVCache:
    """The allocator and a pool glued together, as the reference's facade:
    ``admit`` a prefill's K/V into a slot, ``append`` a token for the
    active slots, ``release`` a slot, and ``view`` every slot's contiguous
    K/V."""

    def __init__(self, cfg: PagedConfig, device: Device = None):
        self.cfg = cfg
        self.alloc = BlockAllocator(cfg)
        self.pool = init_pool(cfg, device)
        self.device = self.pool["k"].device
        self.lens = np.zeros(cfg.max_slots, np.int32)

    def admit(self, slot: int, k_prompt: torch.Tensor,
              v_prompt: torch.Tensor) -> None:
        """k / v_prompt (L, S_p, KVH, hd) of a prefill, written into the
        blocks ``slot`` leases for its S_p rows (quantized on the way in
        for a quantized pool)."""
        s_p = k_prompt.shape[1]
        blocks = self.alloc.ensure(slot, s_p)
        bs = self.cfg.block_size
        if "ks" in self.pool:
            kq, ks = quantize_rows(k_prompt)
            vq, vs = quantize_rows(v_prompt)
            src = {"k": kq, "v": vq, "ks": ks, "vs": vs}
        else:
            src = {"k": k_prompt, "v": v_prompt}
        for i, blk in enumerate(blocks):
            lo, hi = i * bs, min((i + 1) * bs, s_p)
            if lo >= s_p:
                break
            for name, full in src.items():
                buf = self.pool[name]
                buf[:, blk, :hi - lo] = full[:, lo:hi].to(buf.dtype)
        self.lens[slot] = s_p

    def release(self, slot: int) -> None:
        self.alloc.release(slot)
        self.lens[slot] = 0

    def append(self, k_new: torch.Tensor, v_new: torch.Tensor,
               active: np.ndarray) -> None:
        """k / v_new (L, B, KVH, hd): one token for every ACTIVE slot; the
        lengths of the others stay."""
        for s in np.nonzero(active)[0]:
            self.alloc.ensure(int(s), int(self.lens[s]) + 1)
        pt = torch.as_tensor(self.alloc.page_table(), device=self.device)
        lens = torch.as_tensor(self.lens, device=self.device)
        _, new_lens = append_token(self.pool, pt, lens, k_new, v_new)
        self.lens = np.where(active, new_lens.cpu().numpy(), self.lens)

    def view(self):
        pt = torch.as_tensor(self.alloc.page_table(), device=self.device)
        return gather_view(self.pool, pt,
                           torch.as_tensor(self.lens, device=self.device))
