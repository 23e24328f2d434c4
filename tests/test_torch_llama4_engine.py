"""llama4-maverick-400b-a17b's engine through the port against the JAX
engine, on the CPU (the model, its tree and its tolerances:
``tests/test_torch_llama4.py``).

The reduced config (one pattern of a dense and an MoE layer, top 1) has no
paged pool: the port's ``Engine`` falls back to the dense per-slot cache,
as the JAX engine does.  Here: both engines on the same weights and
prompts (f32, bf16 and Q4_0 weights), and ``_merge_slot_cache`` against
JAX's at 1 and 3 slots, where a size-1 pattern axis sits before the batch
axis of both attention banks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving.engine import Engine as JaxEngine
from repro_torch.serving.engine import Engine

from test_torch_llama4 import (DENSE_LAYER_WORTH, F32, Q4, U, _ran,  # noqa
                               bridged, pinned)

torch.set_num_threads(2)

ENGINE = dict(max_slots=2, max_seq=96, prefill_chunk_tokens=32)


def _top2_gaps(tm, tparams, prompt, out):
    """Top-2 logit gap and logits' scale of every greedy step of one
    stream, recomputed by the port's one-shot prefill of the sequence."""
    gaps = []
    for j in range(len(out)):
        seq = np.concatenate([prompt, np.asarray(out[:j], np.int32)])
        logits, _ = tm.prefill(tparams, {"tokens": seq[None]})
        top = torch.topk(logits[0], 2).values
        gaps.append((float(top[0] - top[1]), float(logits.abs().max())))
    return gaps


def _hold_streams(tm, tparams, prompts, got, want):
    """Equal streams with f32 compute; in bf16 a stream may part only at a
    step whose top-2 gap is below twice the logits' bound."""
    assert len(got) == len(want) == len(prompts)
    for prompt, g, w in zip(prompts, got, want):
        if tm.cfg.compute_dtype == "float32":
            assert g == w
            continue
        part = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b),
                    None)
        if part is None:
            assert g == w
            continue
        gap, scale = _top2_gaps(tm, tparams, prompt, w)[part]
        assert gap < 2 * DENSE_LAYER_WORTH * _ran(tm.cfg) * U * scale, \
            (part, gap, scale)


ENGINES = {"f32": (F32, None), "bf16": ({}, None), "q4_0-f32": (F32, Q4)}


@pytest.mark.parametrize("case", list(ENGINES))
def test_engine_matches_jax_engine_on_the_dense_fallback(case, pinned):
    """The port's ``Engine`` with the default ``cache_kind`` falls back to
    the dense per-slot cache, as the JAX engine does; 4 prompts of 40
    tokens (the one-shot prefill's grouped dispatch, one compile of JAX's
    prefill) behind 2 slots, 8 greedy tokens (the decode step's dense
    dispatch): equal plan logs, and streams equal with f32 compute (Q8_0
    and Q4_0 weights) or parting only at a bf16 logit near-tie."""
    over, policy = ENGINES[case]
    jm, jp, tm, tp = bridged(f"engine-{case}", policy=policy, **over)
    rng = np.random.default_rng(32)
    prompts = [rng.integers(4, 500, size=40).astype(np.int32)
               for _ in range(4)]

    def run(eng):
        for p in prompts:
            eng.submit(p, max_new_tokens=8, temperature=0.0)
        done = sorted(eng.run(), key=lambda r: r.uid)
        assert all(r.error is None for r in done)
        return [list(r.output) for r in done], eng.plan_log

    teng = Engine(tm, tp, **ENGINE, device="cpu")
    assert not teng.paged and set(teng.cache) == {"lens", "attn_dense",
                                                  "attn_moe"}
    jeng = JaxEngine(jm, jp, **ENGINE)
    assert not jeng.paged
    got, got_log = run(teng)
    want, want_log = run(jeng)
    assert got_log == want_log
    _hold_streams(tm, tp, prompts, got, want)
    if policy is not None:
        assert tp["blocks_moe"]["moe"]["w1"].bits == 4
        assert tp["blocks_dense"]["mlp"]["w13"].bits == 4


def _jax_path(keys) -> str:
    return "".join(f"/{getattr(k, 'key', getattr(k, 'idx', k))}"
                   for k in keys)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if tree.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(tree.astype(jnp.float32))
                                ).bfloat16()
    return torch.from_numpy(np.array(tree))


@pytest.mark.parametrize("slots", [1, 3])
def test_merge_slot_cache_matches_jax(slots, pinned):
    """JAX's one-prompt prefill cache (bf16 K/V; the reduced config's one
    pattern puts a size-1 axis before the batch axis in both banks)
    merged into slot ``slots - 1`` of a dense cache holding random values,
    by the JAX engine and, carried across, by the port's: every leaf
    equal, cast to the slot cache's dtype; ``lens`` of that slot the
    prompt's length."""
    jm, jp, tm, tp = bridged(f"merge-{slots}")
    toks = np.random.default_rng(slots).integers(4, 500, size=(1, 11))
    _, jpc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_seq=32)
    tpc = _to_torch(jpc)
    kw = dict(max_slots=slots, max_seq=32)
    jeng, teng = JaxEngine(jm, jp, **kw), Engine(tm, tp, **kw, device="cpu")
    rng = np.random.default_rng(7)
    start = {}
    for path, leaf in _leaves(teng.cache):
        start[path] = rng.standard_normal(tuple(leaf.shape)).astype(
            np.float32)
        leaf.copy_(torch.from_numpy(start[path]))
    jeng.cache = jax.tree_util.tree_map_with_path(
        lambda keys, leaf: jnp.asarray(start[_jax_path(keys)]).astype(
            leaf.dtype), jeng.cache)
    jeng._merge_slot_cache(slots - 1, jpc, 11)
    teng._merge_slot_cache(slots - 1, tpc, 11)
    got, want = dict(_leaves(teng.cache)), dict(_leaves(jeng.cache))
    assert set(got) == set(want)
    assert want["/attn_dense/k"].shape[:3] == (1, 1, slots)
    assert want["/attn_moe/k"].shape[:2] == (1, slots)
    for path in want:
        w = np.asarray(jnp.asarray(want[path]).astype(jnp.float32))
        np.testing.assert_array_equal(got[path].float().numpy(), w,
                                      err_msg=path)
        assert str(got[path].dtype).split(".")[-1] == str(want[path].dtype)
    assert int(teng.cache["lens"][slots - 1]) == 11
