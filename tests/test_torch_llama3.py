"""llama3.2-3b through the port against the JAX package, on the CPU.

The reduced config (2 layers, d_model 128, 4 query heads over 2 KV heads of
32, bfloat16 compute and KV pool, rope theta 5e5) with the same weights
(JAX ``init`` + ``Model.quantize``, bridged) and the same inputs.  The JAX
side runs as its own tests run it, with ``REPRO_FUSED_PREFILL=interpret``:
the prefix-attention Pallas kernel, whose f32 flash state the port's
``paged_prefill_attention`` returns too.  Both sides use the ``dequant``
strategy.

Tolerances.  With ``compute_dtype="float32"`` the packages differ only by
f32 summation order: 1e-5, as ``tests/test_models.py`` holds glm4-9b.  In
bfloat16 every value is rounded to 8 significant bits (unit roundoff u =
2^-8) after each op, as both packages round it; where the two f32 sums
before a rounding part in the last place, the rounding can flip by one
bfloat16 ulp.  Such flips in the residual stream reach the logits
through each layer's two residual adds, each worth at most u of the
logits' scale: logits within ``2 * n_layers * u * max |logit|``.  The
pools' bfloat16 rows within two ulps (one flip in the row, one in its
input), 2^-6 of a row's largest value.
"""

from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.core import qlinear as jqlinear
from repro.models import build_model as jax_build_model
from repro.models import layers as JL
from repro.serving.engine import Engine as JaxEngine
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax
from repro_torch.core import qlinear as tqlinear
from repro_torch.kernels import build, ops
from repro_torch.models import layers as TL
from repro_torch.models.model import build_model
from repro_torch.serving.engine import Engine

torch.set_num_threads(2)

ARCH = "llama3.2-3b"
U = 2.0 ** -8                     # bfloat16 unit roundoff


@pytest.fixture
def pinned(monkeypatch):
    """Both packages on ``dequant``, the JAX prefix attention in interpret
    mode; no CPU tensor reached a CUDA kernel."""
    monkeypatch.setenv("REPRO_FUSED_PREFILL", "interpret")
    old_j, old_t = jqlinear.default_strategy(), tqlinear.default_strategy()
    jqlinear.set_default_strategy("dequant")
    tqlinear.set_default_strategy("dequant")
    build.reset_launches()
    yield
    jqlinear.set_default_strategy(old_j)
    tqlinear.set_default_strategy(old_t)
    assert all(v == 0 for v in build.LAUNCHES.values())


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


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def test_config_is_the_reference_config():
    """The port's llama3.2-3b and its reduced form equal the JAX package's
    field for field: GQA 24/8 (reduced 4/2), head_dim 128 (32), bf16."""
    full = tconfigs.get_config(ARCH)
    assert asdict(full) == asdict(get_config(ARCH))
    assert asdict(tconfigs.reduced(full)) == asdict(reduced(get_config(ARCH)))
    r = tconfigs.reduced(full)
    assert (r.n_heads, r.n_kv_heads, r.hd(), r.compute_dtype,
            r.kv_cache_dtype) == (4, 2, 32, "bfloat16", "bfloat16")
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.hd(), full.d_ff, full.vocab_size) == (28, 3072, 24, 8, 128,
                                                       8192, 128256)


def test_bridge_carries_the_gqa_params_unchanged():
    jm, jparams, tm, tparams = _models("bridge")
    jleaves = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(np.asarray, jparams))
    assert tparams["blocks"]["attn"]["wk"].q.shape == (2, 2, 32, 128)
    assert tparams["blocks"]["attn"]["wqkv"].q.shape == (2, (4 + 4) * 32,
                                                         128)
    n = sum(a.size for a in jleaves)
    assert n == sum(t.numel() for t in _tensors(tparams))


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree
    else:
        yield tree.q
        yield tree.scale


@pytest.mark.parametrize("over", [dict(), dict(kv_cache_dtype="int8"),
                                  dict(compute_dtype="float32",
                                       kv_cache_dtype="float32")],
                         ids=["bf16", "bf16-int8-pool", "f32"])
def test_chunked_prefill_then_decode_matches_jax(over, pinned):
    """Two chunk steps (the second over a prefix of whole and partial
    pages, a -1 entry past each row) then four decode steps: logits and
    pools."""
    tag = "-".join(f"{v}" for v in over.values()) or "bf16"
    jm, jparams, tm, tparams = _models("model-" + tag, **over)
    cfg = tm.cfg
    f32 = cfg.compute_dtype == "float32"
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
        tol = 1e-5 if f32 else 2 * cfg.n_layers * U * np.abs(want).max()
        np.testing.assert_allclose(got, want, atol=tol, rtol=0)

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
    for key in jcache["attn"]:
        got, want = tcache["attn"][key], jcache["attn"][key]
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        got, want = _f32(got), _f32(want)
        if key in ("k", "v") and cfg.kv_cache_dtype == "int8":
            # a code is round(127 * row / max|row|): rows within the bound
            # below move it by at most 2 (the row and its max)
            assert np.abs(got - want).max() <= 2, key
        elif key in ("k", "v") and not f32:
            scale = np.abs(want).max(axis=-1, keepdims=True)
            assert (np.abs(got - want) <= 4 * U * scale).all(), key
        else:
            np.testing.assert_allclose(got, want, atol=1e-5 if f32 else
                                       4 * U * np.abs(want).max(), rtol=0,
                                       err_msg=key)
    np.testing.assert_array_equal(_f32(tcache["lens"]), _f32(jcache["lens"]))


def _bf16_pools(rng, nb, bs, kvh, d, int8):
    k = rng.normal(size=(nb, bs, kvh, d)).astype(np.float32)
    v = rng.normal(size=(nb, bs, kvh, d)).astype(np.float32)
    if int8:
        from repro_torch.core.quantization import quantize_rows
        kq, ks = quantize_rows(torch.from_numpy(k))
        vq, vs = quantize_rows(torch.from_numpy(v))
        return [x.numpy() for x in (kq, vq, ks, vs)]
    kb = torch.from_numpy(k).bfloat16()
    vb = torch.from_numpy(v).bfloat16()
    return kb, vb, None, None


def _jnp(x):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(x)


def _torch(x):
    if x is None or isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_plain_paged_decode_attention_matches_jax(int8):
    """The port's paged decode attention on the CPU (its plain version)
    against the JAX ``layers.paged_attention_decode`` at HQ = 2, D = 32,
    a bf16 query, on a bf16 pool and an int8 pool, with a -1 entry inside a
    row's length (it reads block 0).  Both compute in f32 and round the
    output to bf16 once: within one bf16 ulp, 2^-7 of the value."""
    rng = np.random.default_rng(3)
    b, kvh, hq, d, bs, mb, nb = 4, 2, 2, 32, 8, 6, 24
    pools = _bf16_pools(rng, nb, bs, kvh, d, int8)
    pt = rng.permutation(nb)[:b * mb].reshape(b, mb).astype(np.int32)
    pt[1, 2] = -1                          # inside row 1's length
    pt[3] = -1                             # a released slot, length 5
    lens = np.array([40, 33, 1, 5], np.int32)
    q = torch.from_numpy(rng.normal(size=(b, kvh * hq, d)).astype(
        np.float32) * d ** -0.5).bfloat16()
    got = ops.paged_decode_attention(q, *map(_torch, pools[:2]),
                                     torch.from_numpy(pt),
                                     torch.from_numpy(lens),
                                     *map(_torch, pools[2:]))
    want = JL.paged_attention_decode(
        _jnp(q), *map(_jnp, pools[:2]), jnp.asarray(pt), jnp.asarray(lens),
        JL.AttnConfig(kvh * hq, kvh, d), *map(_jnp, pools[2:]))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2 * U, atol=1e-6)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_plain_paged_prefill_attention_matches_jax(int8):
    """The port's chunk attention (``ops.paged_prefill_attention``'s plain
    version, merged by ``layers.attention_chunk_merge``) against the JAX
    jnp path (the gathered prefix through ``attention_chunk_merge``) at HQ
    = 2, D = 32, bf16 queries and chunk keys, bf16 and int8 pools, with a
    -1 entry inside a row's prefix.  The reference rounds the prefix
    segment's probabilities and output to bf16, the port keeps them in f32
    (as the reference's Pallas kernel does): two roundings of at most
    2^-9 each, so within 2^-8 of the largest value."""
    rng = np.random.default_rng(4)
    b, c, kvh, hq, d, bs, mb, nb = 3, 8, 2, 2, 32, 8, 6, 24
    h = kvh * hq
    kp, vp, ks, vs = _bf16_pools(rng, nb, bs, kvh, d, int8)
    pt = rng.permutation(nb)[:b * mb].reshape(b, mb).astype(np.int32)
    pt[0, 1] = -1                          # inside row 0's prefix
    offs = np.array([20, 0, 41], np.int32)
    clens = np.array([8, 8, 3], np.int32)
    q_pos = offs[:, None] + np.arange(c, dtype=np.int32)[None]
    chunk_valid = np.arange(c)[None] < clens[:, None]
    q = torch.from_numpy(rng.normal(size=(b, c, h, d)).astype(
        np.float32) * d ** -0.5).bfloat16()
    kc = torch.from_numpy(rng.normal(size=(b, c, kvh, d)).astype(
        np.float32)).bfloat16()
    vc = torch.from_numpy(rng.normal(size=(b, c, kvh, d)).astype(
        np.float32)).bfloat16()
    state = ops.paged_prefill_attention(
        q, _torch(kp), _torch(vp), torch.from_numpy(np.maximum(pt, 0)),
        torch.from_numpy(offs), torch.from_numpy(clens), _torch(ks),
        _torch(vs))
    acfg_t = TL.AttnConfig(h, kvh, d, q_chunk=8)
    got = TL.attention_chunk_merge(q, None, None, kc, vc, acfg_t,
                                   torch.from_numpy(q_pos), None,
                                   torch.from_numpy(chunk_valid),
                                   pfx_state=state)
    # the reference's gather: each row's page-table row, -1 reads block 0
    safe = np.maximum(pt, 0)
    jk, jv = _jnp(kp), _jnp(vp)
    kg = jk[safe].reshape(b, mb * bs, kvh, d)
    vg = jv[safe].reshape(b, mb * bs, kvh, d)
    if int8:
        kg = kg.astype(jnp.float32) * jnp.asarray(ks)[safe].reshape(
            b, mb * bs, kvh)[..., None]
        vg = vg.astype(jnp.float32) * jnp.asarray(vs)[safe].reshape(
            b, mb * bs, kvh)[..., None]
    pfx_valid = np.arange(mb * bs)[None] < offs[:, None]
    want = JL.attention_chunk_merge(
        _jnp(q), kg.astype(jnp.bfloat16), vg.astype(jnp.bfloat16), _jnp(kc),
        _jnp(vc), JL.AttnConfig(h, kvh, d, q_chunk=8), jnp.asarray(q_pos),
        jnp.asarray(pfx_valid), jnp.asarray(chunk_valid))
    live = chunk_valid[:, :, None, None]
    vmax = max(np.abs(_f32(vc)).max(), np.abs(_f32(want)).max())
    diff = np.abs(_f32(got) - _f32(want)) * live
    assert diff.max() <= 2 * U * vmax, diff.max()


ENGINE = dict(max_slots=2, max_seq=64, page_size=8,
              prefill_chunk_tokens=16)


def _top2_gaps(tm, tparams, prompt, out):
    """Top-2 logit gap of every greedy step of one stream, recomputed by
    the port as one whole-sequence chunk per step (under its own config,
    so these shapes stay out of the engine's chunk-shape count)."""
    tm = build_model(tm.cfg.with_(arch_id=tm.cfg.arch_id + "-gaps"))
    gaps = []
    for j in range(len(out)):
        seq = np.concatenate([prompt, np.asarray(out[:j], np.int32)])
        cache = tm.init_paged_cache(1, block_size=8, n_blocks=8,
                                    max_blocks_per_seq=8, device="cpu")
        cache["page_table"] = torch.arange(8, dtype=torch.int32)[None]
        logits, _ = tm.prefill_chunk_batch(tparams, seq[None], cache, [0],
                                           [0], chunk_lens=[len(seq)])
        top = torch.topk(logits[0], 2).values
        gaps.append((float(top[0] - top[1]), float(logits.abs().max())))
    return gaps


@pytest.mark.parametrize("over", [dict(kv_cache_dtype="bfloat16"),
                                  dict(kv_cache_dtype="int8"),
                                  dict(compute_dtype="float32",
                                       kv_cache_dtype="float32")],
                         ids=["bf16", "int8", "f32"])
def test_engine_matches_jax_engine(over, pinned):
    """Chunked traffic (prompts longer than the 16-token chunk, three
    queued behind two slots): equal plan logs, and equal greedy streams
    up to a near-tie.  In bf16 a greedy step whose top-2 gap is below
    twice the logits' tolerance (two logits, each moved by up to it) may
    go either way: there the streams may part (on the reduced config's
    random weights, gaps of ~1e-3 are common).  With f32 compute no step
    is a near-tie (every gap above 10 x 1e-5) and the streams are
    equal."""
    tag = "-".join(over.values())
    jm, jparams, tm, tparams = _models(f"engine-{tag}", **over)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(4, 500, size=n).astype(np.int32)
               for n in (21, 3, 17, 40, 9)]

    def serve(eng):
        for p in prompts:
            eng.submit(p, max_new_tokens=6, temperature=0.0)
        done = sorted(eng.run(), key=lambda r: r.uid)
        assert all(r.error is None for r in done)
        return [list(r.output) for r in done], eng.plan_log

    want, want_log = serve(JaxEngine(jm, jparams, **ENGINE))
    got, got_log = serve(Engine(tm, tparams, **ENGINE, device="cpu"))
    assert got_log == want_log
    f32 = tm.cfg.compute_dtype == "float32"
    for prompt, g, w in zip(prompts, got, want):
        gaps = _top2_gaps(tm, tparams, prompt, w)
        if f32:
            assert min(gap for gap, _ in gaps) > 10 * 1e-5, gaps
            assert g == w
            continue
        part = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b),
                    None)
        if part is not None:
            gap, scale = gaps[part]
            assert gap < 2 * 2 * tm.cfg.n_layers * U * scale, (part, gaps)


def test_fused_norm_on_bf16_is_the_unfused_pair():
    """Under the kernel strategy a bf16 row's norm and quantization are
    one ``rmsnorm_quant`` call (its plain version on the CPU), equal to
    the norm rounded to bf16 and then quantized."""
    tm = build_model(tconfigs.reduced(tconfigs.get_config(ARCH)))
    params = tm.quantize(tm.init(0, device="cpu"))
    w = params["blocks"]["attn"]["wqkv"]
    w = type(w)(q=w.q[0], scale=w.scale[0], group_size=w.group_size,
                bits=w.bits, orig_dim=w.orig_dim)
    x = torch.randn((5, 128), generator=torch.Generator().manual_seed(0))
    x = x.bfloat16()
    gamma = torch.rand(128, generator=torch.Generator().manual_seed(1))
    old = tqlinear.default_strategy()
    tqlinear.set_default_strategy("kernel")
    try:
        fused = tqlinear.norm_qdot(x, gamma, 1e-5, w)
        pair = tqlinear.qdot(TL.apply_norm(x, {"gamma": gamma}, "rmsnorm"),
                             w)
    finally:
        tqlinear.set_default_strategy(old)
    assert torch.equal(fused, pair)


def test_launch_plans_state_the_real_limits():
    """llama3.2-3b's widths fit the row kernels' plans (w2's K = 8192 at
    64 threads a row for ``quantize``); a row too wide for the kernel's
    registers is refused with the limit in the message."""
    assert ops.quantize_width(768) == 32 and ops.quantize_width(8192) == 64
    width, factor = ops._torch_row_mean_order(8, 3072)
    assert ops.rmsnorm_quant_plan(8, 3072, width)[2] <= ops.Q8_ROWS_VECS[-1]
    assert ops.rmsnorm_quant_plan(2048, 8192, ops.quantize_width(8192)) \
        == (64, 4, 32)
    with pytest.raises(ValueError, match="holds at most 40"):
        ops.rmsnorm_quant_plan(2048, 8192, 32)
    assert 24 // 8 * 128 <= ops.DECODE_MAX_HQ_D < 16 * 128
