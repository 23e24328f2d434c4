"""The port's block allocator against the JAX package's, op by op.

One seeded sequence of allocator operations (grow, release, prefix lookup
and acquire, block registration, fork, copy-on-write, truncate) drives both
allocators; leases, refcounts, the free list, the LRU, the prefix index,
the stats and ``audit()`` must be equal after every operation, and both must
raise ``OutOfBlocks`` at the same operations.
"""

import numpy as np
import pytest

from repro.serving import paged_cache as jpc
from repro_torch.serving import paged_cache as tpc


def _state(a):
    return (a.owned, a.refcount, a.free, list(a.lru), a.index, a.block_hash,
            a.block_tokens, a.stats, a.audit().violations, a.n_free(),
            a.page_table().tolist())


def _apply(alloc, mod, op, args):
    try:
        if op == "ensure":
            return alloc.ensure(*args)
        if op == "release":
            return alloc.release(*args)
        if op == "truncate":
            return alloc.truncate(*args)
        if op == "cached":
            slot, tokens = args
            bids, _ = alloc.lookup_prefix(tokens)
            alloc.acquire_cached(slot, bids)
            return bids
        if op == "register":
            slot, j, tokens = args
            parent = None
            for i in range(j + 1):
                block = tokens[i * 4:(i + 1) * 4]
                parent = mod.chain_hash(parent, block)
            return alloc.register_block(slot, j, parent, block)
        if op == "fork":
            return alloc.fork(*args)
        if op == "cow":
            return alloc.cow_for_append(*args)
    except mod.OutOfBlocks:
        return "out-of-blocks"


@pytest.mark.parametrize("seed", range(6))
def test_allocators_agree_op_by_op(seed):
    rng = np.random.default_rng(seed)
    cfg = dict(n_layers=1, n_kv_heads=1, head_dim=8, block_size=4,
               n_blocks=12, max_slots=4, max_blocks_per_seq=6)
    ja = jpc.BlockAllocator(jpc.PagedConfig(**cfg))
    ta = tpc.BlockAllocator(tpc.PagedConfig(**cfg))
    prompts = [rng.integers(0, 5, size=24).tolist() for _ in range(3)]
    for step in range(300):
        slot = int(rng.integers(0, 4))
        held = len(ja.owned[slot])
        kind = rng.choice(["ensure", "release", "truncate", "cached",
                           "register", "fork", "cow"])
        if kind == "ensure":
            args = (slot, int(rng.integers(1, 25)))
        elif kind in ("release",):
            args = (slot,)
        elif kind == "truncate":
            args = (slot, int(rng.integers(0, 4 * held + 1)))
        elif kind == "cached":
            if held:
                continue
            args = (slot, prompts[int(rng.integers(0, 3))])
        elif kind == "register":
            if not held:
                continue
            args = (slot, int(rng.integers(0, held)),
                    prompts[slot % 3])
        elif kind == "fork":
            dst = int(rng.integers(0, 4))
            if dst == slot or ja.owned[dst]:
                continue
            args = (slot, dst)
        else:
            if not held:
                continue
            args = (slot, int(rng.integers(0, 4 * held)))
        want = _apply(ja, jpc, kind, args)
        got = _apply(ta, tpc, kind, args)
        assert got == want, (step, kind, args)
        assert _state(ta) == _state(ja), (step, kind, args)
    assert ja.stats["hit_blocks"] + ja.stats["cow_copies"] > 0


def test_prefix_block_hashes_equal():
    toks = list(range(37))
    assert tpc.prefix_block_hashes(toks, 8) == jpc.prefix_block_hashes(toks, 8)
