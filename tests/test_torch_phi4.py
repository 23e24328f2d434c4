"""phi4-mini-3.8b through the port against the JAX package, on the CPU.

llama3.2-3b's family and head layout at 32 layers, vocab 200064 and rope
theta 1e4.  The reduced config (2 layers, d_model 128, 4 query heads over 2
KV heads of 32, bfloat16 compute and KV pool, rope theta 1e4) with the same
weights (JAX ``init`` + ``Model.quantize``, bridged) and the same inputs;
the JAX side runs its prefix attention as its own tests run it
(``REPRO_FUSED_PREFILL=interpret``), both sides on ``dequant``.  The
tolerances are ``tests/test_torch_llama3.py``'s: logits within ``2 *
n_layers * u * max |logit|`` (u = 2^-8), pools' bf16 rows within two ulps,
greedy streams equal up to a near-tie.
"""

from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import build_model as jax_build_model
from repro.serving.engine import Engine as JaxEngine
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax
from repro_torch.models.model import build_model
from repro_torch.serving.engine import Engine

from test_torch_llama3 import U, _f32, _top2_gaps, pinned  # noqa: F401

torch.set_num_threads(2)

ARCH = "phi4-mini-3.8b"


def _models(tag, **over):
    tag = f"{ARCH}-torch-parity-{tag}"
    jcfg = reduced(get_config(ARCH)).with_(arch_id=tag, **over)
    tcfg = tconfigs.reduced(tconfigs.get_config(ARCH)).with_(arch_id=tag,
                                                            **over)
    jm = jax_build_model(jcfg)
    jparams = jm.quantize(jm.init(jax.random.PRNGKey(0)))
    tm = build_model(tcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return jm, jparams, tm, tparams


def test_config_is_the_reference_config():
    """The port's phi4-mini-3.8b and its reduced form equal the JAX
    package's field for field; it differs from llama3.2-3b only in depth,
    vocabulary and rope theta."""
    full = tconfigs.get_config(ARCH)
    assert asdict(full) == asdict(get_config(ARCH))
    assert asdict(tconfigs.reduced(full)) == asdict(reduced(get_config(ARCH)))
    l3 = tconfigs.get_config("llama3.2-3b")
    differ = {k for k, v in asdict(full).items() if asdict(l3)[k] != v}
    assert differ == {"arch_id", "n_layers", "vocab_size", "rope_theta"}
    assert (full.n_layers, full.vocab_size, full.padded_vocab(),
            full.rope_theta, full.tie_embeddings) == (32, 200064, 200192,
                                                      1e4, True)


def test_bridge_carries_the_params_unchanged():
    """Every leaf of the JAX parameter tree (the fused decode operands
    included) reaches the port, the per-projection codes and scales with
    their bytes."""
    jm, jparams, tm, tparams = _models("bridge")
    jnp_tree = jax.tree_util.tree_map(np.asarray, jparams)
    jattn = jnp_tree["blocks"]["attn"]
    tattn = tparams["blocks"]["attn"]
    for name in ("wq", "wk", "wv", "wo"):
        assert tattn[name].q.numpy().tobytes() == jattn[name].q.tobytes()
        assert tattn[name].scale.numpy().tobytes() == \
            jattn[name].scale.tobytes()
    assert tparams["embed"].q.shape == (512, 128)
    assert tattn["wqkv"].q.shape == (2, (4 + 2 * 2) * 32, 128)
    n = sum(a.size for a in jax.tree_util.tree_leaves(jnp_tree))

    def count(tree):
        if isinstance(tree, dict):
            return sum(count(v) for v in tree.values())
        if isinstance(tree, torch.Tensor):
            return tree.numel()
        return tree.q.numel() + tree.scale.numel()
    assert count(tparams) == n


@pytest.mark.parametrize("over", [dict(), dict(kv_cache_dtype="int8")],
                         ids=["bf16", "int8-pool"])
def test_chunked_prefill_then_decode_matches_jax(over, pinned):
    """Two chunk steps (the second over a prefix of whole and partial
    pages) then four decode steps on the paged pool: logits within the
    bf16 bound; int8 codes within 2; a bf16 V row within two ulps of its
    largest value, 4u (``test_torch_llama3.py``'s: one flip in the row, one
    in its input).  A K row is that, rotated: each of the two values rope
    mixes carries up to 4u of the unrotated row's largest value, which is
    at most sqrt(2) times the rotated row's (a pair keeps its norm), the
    mix weighs them by |cos| + |sin| <= sqrt(2), and rope rounds once more
    (2u): within (4 * 2 + 2) u = 10u of the rotated row's largest
    value."""
    jm, jparams, tm, tparams = _models("model-" + ("-".join(over.values())
                                                   or "bf16"), **over)
    cfg = tm.cfg
    b, bs, nb, mb = 3, 8, 24, 8
    jcache = jm.init_paged_cache(b, block_size=bs, n_blocks=nb,
                                 max_blocks_per_seq=mb)
    tcache = tm.init_paged_cache(b, block_size=bs, n_blocks=nb,
                                 max_blocks_per_seq=mb, device="cpu")
    pt = np.full((b, mb), -1, np.int32)
    pt[0, :5] = [3, 5, 1, 0, 9]
    pt[1, :6] = [2, 7, 4, 11, 12, 13]
    pt[2, :2] = [6, 8]
    jcache["page_table"] = jnp.asarray(pt)
    tcache["page_table"] = torch.from_numpy(pt.copy())
    rng = np.random.default_rng(0)

    def close(got, want):
        np.testing.assert_allclose(
            got, want, rtol=0, atol=2 * cfg.n_layers * U * np.abs(want).max())

    for offs, lens in (([0, 0, 0], [16, 13, 9]), ([16, 13, 9], [16, 16, 5])):
        toks = rng.integers(4, 500, size=(b, 16)).astype(np.int32)
        jl, jcache = jm.prefill_chunk_batch(
            jparams, jnp.asarray(toks), jcache, jnp.asarray([0, 1, 2]),
            jnp.asarray(offs, jnp.int32),
            chunk_lens=jnp.asarray(lens, jnp.int32))
        tl, tcache = tm.prefill_chunk_batch(tparams, toks, tcache, [0, 1, 2],
                                            offs, chunk_lens=lens)
        close(_f32(tl), _f32(jl))
    for _ in range(4):
        toks = rng.integers(4, 500, size=(b,)).astype(np.int32)
        jl, jcache = jm.decode_step(jparams, jcache, jnp.asarray(toks))
        tl, tcache = tm.decode_step(tparams, tcache, torch.from_numpy(toks))
        close(_f32(tl), _f32(jl))
    for key, ulps in (("k", 10), ("v", 4)):
        got, want = _f32(tcache["attn"][key]), _f32(jcache["attn"][key])
        if cfg.kv_cache_dtype == "int8":
            assert np.abs(got - want).max() <= 2, key
        else:
            scale = np.abs(want).max(axis=-1, keepdims=True)
            assert (np.abs(got - want) <= ulps * U * scale).all(), key
    np.testing.assert_array_equal(_f32(tcache["lens"]), _f32(jcache["lens"]))


def test_engine_matches_jax_engine(pinned):
    """The paged Engine on chunked traffic (prompts past the 16-token
    chunk, three queued behind two slots): equal plan logs, greedy streams
    equal up to a near-tie (a top-2 gap below twice the logits' bound)."""
    jm, jparams, tm, tparams = _models("engine")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(4, 500, size=n).astype(np.int32)
               for n in (21, 3, 17, 40, 9)]
    kw = dict(max_slots=2, max_seq=64, page_size=8, prefill_chunk_tokens=16)

    def serve(eng):
        for p in prompts:
            eng.submit(p, max_new_tokens=6, temperature=0.0)
        done = sorted(eng.run(), key=lambda r: r.uid)
        assert all(r.error is None for r in done)
        return [list(r.output) for r in done], eng.plan_log

    want, want_log = serve(JaxEngine(jm, jparams, **kw))
    got, got_log = serve(Engine(tm, tparams, **kw, device="cpu"))
    assert got_log == want_log
    for prompt, g, w in zip(prompts, got, want):
        part = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b),
                    None)
        if part is not None:
            gap, scale = _top2_gaps(tm, tparams, prompt, w)[part]
            assert gap < 2 * 2 * tm.cfg.n_layers * U * scale, (part, gap)
