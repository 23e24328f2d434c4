"""llama3.2-3b on the dense cache and with Q4_0 weights, through the port
against the JAX package on the CPU.

The reduced config (2 layers, d_model 128, 4 query heads over 2 KV heads of
32, bfloat16 compute, bfloat16 or int8 cache) with the same weights (JAX
``init`` + ``Model.quantize``, bridged) and the same inputs; both sides on
the ``dequant`` strategy.

Tolerances.  ``tests/test_torch_llama3.py`` states the bf16 bound: every
value is rounded to 8 significant bits (u = 2^-8) after each op; a rounding
that flips by one ulp in the residual stream reaches the logits through a
layer's two residual adds, each worth at most u of the logits' scale:
logits within ``2 * n_layers * u * max |logit|``.  The one-shot prefill adds
one rounding the port does not make: the reference rounds the normalized
probabilities P to bf16 before P.V (``layers.attention_scores_blockwise``),
which a flash kernel cannot reproduce (it normalizes at the end), so the
port keeps P in f32.  Rounding P moves the attention output by at most
2^-9 of max |V| (sum_i |dp_i| |v_i| <= 2^-9 sum_i p_i max|v|), half of u,
and it feeds one residual add a layer: the dense logits are held within
``(2 + 1/2) * n_layers * u * max |logit|``.  With ``compute_dtype =
"float32"`` the packages differ only by f32 summation order (1e-5) and the
streams are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.core.policy import QuantPolicy as JQuantPolicy
from repro.models import build_model as jax_build_model
from repro.models import layers as JL
from repro.serving.engine import Engine as JaxEngine
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax
from repro_torch.core import qlinear as tqlinear
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.quantization import quantize_rows
from repro_torch.kernels import ops, ref
from repro_torch.models import transformer as TT
from repro_torch.models.model import build_model
from repro_torch.serving.engine import Engine

from test_torch_llama3 import U, _f32, _top2_gaps, pinned  # noqa: F401

torch.set_num_threads(2)

ARCH = "llama3.2-3b"
Q4 = dict(bits=4, min_size=512)          # launch/serve.py --bits 4
# the dense path's logits bound, in units of n_layers * u * max |logit|
DENSE_LAYER_WORTH = 2 + 1 / 2


def _models(tag, bits=8, **over):
    tag = f"{ARCH}-torch-dense-{tag}"
    jcfg = reduced(get_config(ARCH)).with_(arch_id=tag, **over)
    tcfg = tconfigs.reduced(tconfigs.get_config(ARCH)).with_(arch_id=tag,
                                                            **over)
    jm = jax_build_model(jcfg)
    policy = JQuantPolicy(**Q4) if bits == 4 else None
    jparams = jm.quantize(jm.init(jax.random.PRNGKey(0)), policy)
    tm = build_model(tcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return jm, jparams, tm, tparams


def _bf16(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.normal(size=shape) * scale).astype(
        np.float32)).bfloat16()


def _jnp(x):
    return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)


def test_plain_flash_prefill_matches_jax_at_bf16():
    """The port's one-shot attention (``ops.flash_prefill``'s plain
    version) on a bf16 q pre-scaled in bf16 (``scale=1``), bf16 K/V and GQA
    heads (4 over 2, D = 32), against the JAX jnp twin
    ``attention_scores_blockwise``.  Both take scores and the softmax in
    f32; the reference rounds P to bf16 (at most 2^-9 of max |V| on the
    output) and both round the output to bf16 (half an ulp each, 2^-9 of
    the value): within 2^-8 of the largest |V|, as
    ``test_plain_paged_prefill_attention_matches_jax`` holds the chunk
    attention."""
    rng = np.random.default_rng(5)
    b, s, h, kvh, d = 2, 24, 4, 2, 32
    scale = torch.tensor(d ** -0.5).bfloat16().item()
    q = _bf16(rng, b, s, h, d) * scale
    k, v = _bf16(rng, b, s, kvh, d), _bf16(rng, b, s, kvh, d)
    got = ops.flash_prefill(q, k, v, causal=True, scale=1.0)
    want = JL.attention_scores_blockwise(
        _jnp(q), _jnp(k), _jnp(v), JL.AttnConfig(h, kvh, d, q_chunk=8))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    diff = np.abs(_f32(got) - _f32(want))
    assert diff.max() <= 2 * U * np.abs(_f32(v)).max(), diff.max()
    assert diff.max() > 0          # the P rounding is real, and stated


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_plain_decode_attention_matches_jax_at_bf16(int8):
    """The port's dense decode attention on the CPU (its plain version) on
    a bf16 query against a bf16 cache, or int8 codes with their f32
    scales, against the JAX ``attention_decode``: both compute in f32 and
    round the output to q's dtype once: within one bf16 ulp, 2^-7 of the
    value.  A length-0 row is 0."""
    rng = np.random.default_rng(6)
    b, s, kvh, hq, d = 3, 40, 2, 2, 32
    k32 = torch.from_numpy(rng.normal(size=(b, s, kvh, d)).astype(
        np.float32))
    v32 = torch.from_numpy(rng.normal(size=(b, s, kvh, d)).astype(
        np.float32))
    if int8:
        (k, ks), (v, vs) = quantize_rows(k32), quantize_rows(v32)
        jk, jv = jnp.asarray(k.numpy()), jnp.asarray(v.numpy())
        jks, jvs = jnp.asarray(ks.numpy()), jnp.asarray(vs.numpy())
    else:
        k, v, ks, vs = k32.bfloat16(), v32.bfloat16(), None, None
        jk, jv, jks, jvs = _jnp(k), _jnp(v), None, None
    lens = np.array([40, 17, 0], np.int32)
    q = _bf16(rng, b, kvh * hq, d, scale=d ** -0.5)
    got = ops.decode_attention(q, k, v, torch.from_numpy(lens), ks, vs)
    want = JL.attention_decode(_jnp(q), jk, jv, jnp.asarray(lens),
                               JL.AttnConfig(kvh * hq, kvh, d), jks, jvs)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2 * U, atol=1e-6)
    assert not _f32(got)[2].any()


def test_f32_flash_prefill_is_unchanged():
    """On f32 inputs the plain ``flash_prefill`` gives the bits it gave
    before the bf16 path came: q unscaled, scaled by D^-1/2 inside (the
    parent tree's formula, copied here), f32 out; and the f32 model calls it
    so (no ``scale``), while a bf16 model pre-scales q and passes 1."""
    rng = np.random.default_rng(7)
    b, s, h, kvh, d = 2, 20, 4, 2, 32
    q = torch.from_numpy(rng.normal(size=(b, s, h, d)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(b, s, kvh, d)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(b, s, kvh, d)).astype(np.float32))
    got = ops.flash_prefill(q, k, v)
    kr = torch.repeat_interleave(k, h // kvh, dim=2)
    vr = torch.repeat_interleave(v, h // kvh, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q * (d ** -0.5), kr)
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool))[None, None]
    scores = torch.where(mask, scores, torch.full_like(scores, ref.NEG_INF))
    m = torch.amax(scores, dim=-1, keepdim=True)
    e = torch.where(mask, torch.exp(scores - m), torch.zeros_like(scores))
    l = torch.sum(e, dim=-1, keepdim=True)
    want = torch.einsum("bhqk,bkhd->bqhd", e / l, vr)
    assert got.dtype == torch.float32 and torch.equal(got, want)

    seen = []
    real = ops.flash_prefill

    def spy(q, k, v, **kw):
        seen.append((q.dtype, kw.get("scale")))
        return real(q, k, v, **kw)
    for compute, want_call in (("float32", (torch.float32, None)),
                               ("bfloat16", (torch.bfloat16, 1.0))):
        cfg = tconfigs.reduced(tconfigs.get_config(ARCH)).with_(
            compute_dtype=compute)
        tm = build_model(cfg)
        params = tm.init(0, device="cpu")
        seen.clear()
        ops.flash_prefill = spy
        try:
            tm.prefill(params, {"tokens": np.arange(5, 12)[None]})
        finally:
            ops.flash_prefill = real
        assert seen == [want_call] * cfg.n_layers, seen
    assert TT._q_scale(cfg) == torch.tensor(32 ** -0.5).bfloat16().item()


def _logit_tol(cfg, want):
    if cfg.compute_dtype == "float32":
        return 1e-5
    return DENSE_LAYER_WORTH * cfg.n_layers * U * np.abs(want).max()


@pytest.mark.parametrize("over", [dict(), dict(kv_cache_dtype="int8"),
                                  dict(compute_dtype="float32",
                                       kv_cache_dtype="float32")],
                         ids=["bf16", "bf16-int8-cache", "f32"])
def test_prefill_then_decode_matches_jax(over, pinned):
    """The one-shot prefill of two prompts into a dense cache, then three
    dense decode steps (the last with a row at the end of its
    reservation, which writes at the last position): logits within the
    dense bound, the caches' rows as ``test_torch_llama3.py`` holds the
    pools'."""
    tag = "model-" + ("-".join(f"{v}" for v in over.values()) or "bf16")
    jm, jparams, tm, tparams = _models(tag, **over)
    cfg = tm.cfg
    f32 = cfg.compute_dtype == "float32"
    rng = np.random.default_rng(0)
    toks = rng.integers(4, 500, size=(2, 11)).astype(np.int32)
    jl, jcache = jm.prefill(jparams, {"tokens": jnp.asarray(toks)},
                            max_seq=24)
    tl, tcache = tm.prefill(tparams, {"tokens": toks}, max_seq=24)
    np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=0,
                               atol=_logit_tol(cfg, _f32(jl)))
    jdecode = jax.jit(jm.decode_step)
    for step in range(3):
        if step == 2:
            jcache["lens"] = jnp.asarray([13, 24], jnp.int32)
            tcache["lens"] = torch.tensor([13, 24], dtype=torch.int32)
        t = rng.integers(4, 500, size=(2,)).astype(np.int32)
        jl, jcache = jdecode(jparams, jcache, jnp.asarray(t))
        tl, tcache = tm.decode_step(tparams, tcache, torch.from_numpy(t))
        np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=0,
                                   atol=_logit_tol(cfg, _f32(jl)))
    for key in jcache["attn"]:
        got, want = tcache["attn"][key], jcache["attn"][key]
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        got, want = _f32(got), _f32(want)
        if key in ("k", "v") and cfg.kv_cache_dtype == "int8":
            assert np.abs(got - want).max() <= 2, key
        elif key in ("k", "v") and not f32:
            scale = np.abs(want).max(axis=-1, keepdims=True)
            assert (np.abs(got - want) <= 4 * U * scale).all(), key
        else:
            np.testing.assert_allclose(got, want, atol=1e-5 if f32 else
                                       4 * U * np.abs(want).max(), rtol=0,
                                       err_msg=key)
    assert _f32(tcache["lens"]).tolist() == [14, 25]


ENGINE = dict(max_slots=2, max_seq=64, page_size=8,
              prefill_chunk_tokens=16)


def _serve(eng, prompts, max_new=6):
    for p in prompts:
        eng.submit(p, max_new_tokens=max_new, temperature=0.0)
    done = sorted(eng.run(), key=lambda r: r.uid)
    assert all(r.error is None for r in done), [r.error for r in done]
    return [list(r.output) for r in done], eng.plan_log


def _prompts(seed=1, lens=(17, 3, 17, 21, 3)):
    rng = np.random.default_rng(seed)
    return [rng.integers(4, 500, size=n).astype(np.int32) for n in lens]


def _hold_streams(tm, tparams, prompts, got, want, worth):
    """Equal streams with f32 compute; in bf16 a parting only at a step
    whose top-2 gap is below twice the logits' bound (two logits, each
    moved by up to ``worth * n_layers * u`` of the scale)."""
    if tm.cfg.compute_dtype == "float32":
        for prompt, w in zip(prompts, want):
            assert min(g for g, _ in _top2_gaps(tm, tparams, prompt, w)) \
                > 10 * 1e-5
        assert got == want
        return
    for prompt, g, w in zip(prompts, got, want):
        part = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b),
                    None)
        if part is not None:
            gap, scale = _top2_gaps(tm, tparams, prompt, w)[part]
            assert gap < 2 * worth * tm.cfg.n_layers * U * scale, \
                (part, gap, scale)


@pytest.mark.parametrize("over", [dict(kv_cache_dtype="bfloat16"),
                                  dict(kv_cache_dtype="int8"),
                                  dict(compute_dtype="float32",
                                       kv_cache_dtype="float32")],
                         ids=["bf16", "int8", "f32"])
def test_dense_engine_matches_jax_dense_engine(over, pinned):
    """The dense Engine on prompts of few distinct lengths (the JAX
    one-shot prefill compiles once a length), three queued behind two
    slots: equal plan logs, streams equal up to a near-tie under the dense
    bound in bf16, exactly equal with f32 compute."""
    jm, jparams, tm, tparams = _models("engine-" + "-".join(over.values()),
                                       **over)
    prompts = _prompts()
    kw = dict(ENGINE, cache_kind="dense")
    want, want_log = _serve(JaxEngine(jm, jparams, **kw), prompts)
    eng = Engine(tm, tparams, **kw, device="cpu")
    got, got_log = _serve(eng, prompts)
    assert got_log == want_log
    _hold_streams(tm, tparams, prompts, got, want, DENSE_LAYER_WORTH)
    assert eng.cache_utilization() == 0.0


@pytest.mark.parametrize("strategy", ["dequant", "kernel"])
@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_dense_streams_equal_paged(kv, strategy):
    """Inside the port, the dense cache gives the paged pool's greedy
    streams up to a near-tie: the two paths round differently (the paged
    chunk merges its own keys with P.V summed from bf16 products, the
    one-shot prefill keeps P in f32), each within its bound of the
    reference, so a parting needs a top-2 gap below twice the sum of the
    two bounds.  Both drain to an empty cache."""
    old = tqlinear.default_strategy()
    tqlinear.set_default_strategy(strategy)
    try:
        tm = build_model(tconfigs.reduced(tconfigs.get_config(ARCH)).with_(
            kv_cache_dtype=kv))
        params = tm.quantize(tm.init(0, device="cpu"))
        prompts = _prompts(0, (8, 3, 17, 5))
        outs = {}
        for kind in ("paged", "dense"):
            eng = Engine(tm, params, **ENGINE, cache_kind=kind,
                         device="cpu")
            outs[kind], _ = _serve(eng, prompts, max_new=5)
            assert eng.cache_utilization() == 0.0
        _hold_streams(tm, params, prompts, outs["dense"], outs["paged"],
                      2 + DENSE_LAYER_WORTH)
    finally:
        tqlinear.set_default_strategy(old)


@pytest.mark.parametrize("cache_kind", ["paged", "dense"])
def test_q4_engine_matches_jax_engine(cache_kind, pinned):
    """Q4_0 weights (``QuantPolicy(bits=4, min_size=512)``, what
    ``serve.py --bits 4`` builds) for the bf16 config, on both caches,
    against the JAX Engine: the codes and scales are bitwise the
    reference's, the plan logs equal, the streams equal up to a near-tie
    under the path's bound (the paged one's, 2, or the dense one's)."""
    jm, jparams, tm, tparams = _models("q4-" + cache_kind, bits=4)
    w = tparams["blocks"]["mlp"]["w13"]
    assert w.bits == 4 and w.q.shape[-1] * 2 == tm.cfg.d_model
    jw = jparams["blocks"]["mlp"]["w13"]
    assert w.q.numpy().tobytes() == np.asarray(jw.q).tobytes()
    assert w.scale.numpy().tobytes() == np.asarray(jw.scale).tobytes()
    prompts = _prompts(2)
    kw = dict(ENGINE, cache_kind=cache_kind)
    want, want_log = _serve(JaxEngine(jm, jparams, **kw), prompts)
    got, got_log = _serve(Engine(tm, tparams, **kw, device="cpu"), prompts)
    assert got_log == want_log
    _hold_streams(tm, tparams, prompts, got, want,
                  DENSE_LAYER_WORTH if cache_kind == "dense" else 2)


def test_q4_operands_fit_the_kernel_at_full_width():
    """Q4_0 for the bf16 config: ``fuse_decode_weights`` builds wqkv, w13
    and wo_f from the Q4 projections (packed K/2 bytes a row) on the
    reduced model; at llama3.2-3b's full widths every GEMV operand's group
    (``choose_group_size``, the reference's rule) is one ``q4_matvec``
    takes, and every row and every layer's slice starts 16 bytes aligned,
    so the served products take the tensor-core path (no dp4a)."""
    from repro_torch.core.quantization import choose_group_size
    tm = build_model(tconfigs.reduced(tconfigs.get_config(ARCH)))
    params = tm.quantize(tm.init(0, device="cpu"), QuantPolicy(**Q4))
    attn, mlp = params["blocks"]["attn"], params["blocks"]["mlp"]
    for w in (attn["wqkv"], attn["wo_f"], mlp["w13"], mlp["w2"],
              params["embed"]):
        assert w.bits == 4 and w.q.shape[-1] * 2 == w.orig_dim
    full = tconfigs.get_config(ARCH)
    hd = full.hd()
    shapes = {"wqkv": ((full.n_heads + 2 * full.n_kv_heads) * hd,
                       full.d_model, full.d_model),
              "wo_f": (full.d_model, full.n_heads * hd, hd),
              "w13": (2 * full.d_ff, full.d_model, full.d_model),
              "w2": (full.d_model, full.d_ff, full.d_ff),
              "head": (full.padded_vocab(), full.d_model, full.d_model)}
    for name, (n, k, grouped) in shapes.items():
        g = choose_group_size(grouped, 64)
        assert g == 64 and k % g == 0 and k % 32 == 0, name
        assert (k // 2) % 16 == 0 and (n * k // 2) % 16 == 0, name
