"""qwen3-moe-30b-a3b through the port against the JAX package, on the CPU.

The JAX package's config: 48 layers, d_model 2048, 32 query heads over 4
KV heads of 64, 128 experts of d_ff 768, top 8, vocab 151936, rope theta
1e6, bfloat16 params, compute and KV pool; the MoE in every layer, its
router f32 and its expert banks quantized.  Reduced: 2 layers, d_model
128, 4 query heads over 2 KV heads of 32, 8 experts of d_ff 256, top 2,
groups of 64 tokens.

Here: the config and its reduced form field for field; ``moe_mlp`` alone
against JAX's at both dispatches, with pairs dropped at a tight capacity
and a token count no multiple of the group; the routing's tie order
(``lax.top_k``'s); the reduced engine against the JAX engine on the paged
bf16 and int8 pools and the dense bf16 cache, and on an f32 paged pool
with f32 compute; the n-gram speculative engine (f32) against the JAX
engine; the port's decode logits against its own
one-shot prefill; the init that quantizes as it draws; the llama4
interleave built beside it; ``serve.py --arch qwen3-moe-30b-a3b`` on the
CPU.
Both packages run the ``dequant`` strategy; the JAX chunk step reads its
prefix through its plain reference, as its own tests run it.

Tolerances.  ``moe_mlp`` alone: both sides route on the same f32 logits
and multiply the same dequantized f32 weights, so they part only by f32
summation order (1e-5 of the output's largest magnitude); in bfloat16 the
output's rounding can flip by one ulp, at most 2^-7 of the largest
magnitude.  The engines: with f32 compute, on every pool and cache, equal
streams.  In bf16, as ``tests/test_torch_llama3.py`` holds them, logits
within ``2 * n_layers * u * max |logit|`` (dense cache: ``2 + 1/2`` units
a layer, ``tests/test_torch_llama3_dense.py``), so a stream may part only
at a step whose top-2 logit gap is below twice that.  A bf16 rounding can
also flip a router near-tie, which moves a token by a whole expert's
share; on these prompts none parts a stream, and a parting that is not a
logit near-tie fails the test, to be read, not allowed.
"""

import functools
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
from repro_torch.configs import ModelConfig
from repro_torch.core import qlinear as tqlinear
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.quantization import QuantizedTensor, tree_differs
from repro_torch.kernels import build
from repro_torch.launch import serve
from repro_torch.models import layers as TL
from repro_torch.models import transformer
from repro_torch.models.model import build_model
from repro_torch.serving.engine import Engine

from test_torch_llama3 import ENGINE, U, _top2_gaps

torch.set_num_threads(2)

ARCH = "qwen3-moe-30b-a3b"
F32 = dict(compute_dtype="float32", kv_cache_dtype="float32")
# the dense path's logits bound, in units of n_layers * u * max |logit|
# (tests/test_torch_llama3_dense.py)
DENSE_LAYER_WORTH = 2 + 1 / 2


@pytest.fixture
def pinned(monkeypatch):
    """Both packages on ``dequant``, the JAX chunk step's prefix read on
    its plain reference (its own tests' default on the CPU); no CPU tensor
    reached a CUDA kernel."""
    monkeypatch.setenv("REPRO_FUSED_PREFILL", "oracle")
    old_j, old_t = jqlinear.default_strategy(), tqlinear.default_strategy()
    jqlinear.set_default_strategy("dequant")
    tqlinear.set_default_strategy("dequant")
    build.reset_launches()
    yield
    jqlinear.set_default_strategy(old_j)
    tqlinear.set_default_strategy(old_t)
    assert all(v == 0 for v in build.LAUNCHES.values())


def test_config_is_the_reference_config():
    """The port's qwen3-moe-30b-a3b and its reduced form equal the JAX
    package's field for field."""
    full = tconfigs.get_config(ARCH)
    assert asdict(full) == asdict(get_config(ARCH))
    assert asdict(tconfigs.reduced(full)) == asdict(reduced(get_config(ARCH)))
    assert (full.family, full.n_layers, full.d_model, full.n_heads,
            full.n_kv_heads, full.hd(), full.d_ff, full.vocab_size,
            full.padded_vocab(), full.n_experts, full.top_k, full.moe_every,
            full.moe_group, full.capacity_factor, full.rope_theta,
            full.param_dtype, full.compute_dtype, full.kv_cache_dtype,
            full.moe_shard) == (
        "moe", 48, 2048, 32, 4, 64, 768, 151936, 152064, 128, 8, 1, 512,
        1.25, 1e6, "bfloat16", "bfloat16", "bfloat16", "ep_data")
    r = tconfigs.reduced(full)
    assert (r.n_layers, r.d_model, r.n_heads, r.n_kv_heads, r.hd(),
            r.d_ff, r.n_experts, r.top_k, r.moe_group) == (
        2, 128, 4, 2, 32, 256, 8, 2, 64)


def _bridged(tag, **over):
    """(JAX model, its Q8_0 params, port model, the bridged params) at the
    reduced config under an arch id of their own (each engine counts its
    compiled shapes per config)."""
    tag = f"{ARCH}-torch-parity-{tag}"
    jcfg = reduced(get_config(ARCH)).with_(arch_id=tag, **over)
    tcfg = tconfigs.reduced(tconfigs.get_config(ARCH)).with_(arch_id=tag,
                                                            **over)
    jm = jax_build_model(jcfg)
    jparams = jm.quantize(jm.init(jax.random.PRNGKey(0)))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return jm, jparams, build_model(tcfg), tparams


@functools.lru_cache(maxsize=None)
def _bridged_once():
    return _bridged("tree")


def test_bridged_tree_keeps_the_router_f32_and_no_w13():
    """The quantized tree as the reference builds it: the router f32 and
    unquantized, the three banks Q8_0, the fused attention operands and no
    fused ``w13`` (``fuse_decode_weights`` leaves MoE banks unfused)."""
    _, _, tm, tparams = _bridged_once()
    moe = tparams["blocks"]["moe"]
    assert moe["router"].dtype == torch.float32
    assert tuple(moe["router"].shape) == (2, 8, 128)
    for name, shape in (("w1", (2, 8, 256, 128)), ("w3", (2, 8, 256, 128)),
                        ("w2", (2, 8, 128, 256))):
        assert isinstance(moe[name], QuantizedTensor)
        assert moe[name].bits == 8 and tuple(moe[name].q.shape) == shape
    assert "w13" not in moe and "mlp" not in tparams["blocks"]
    assert {"wqkv", "wo_f"} <= set(tparams["blocks"]["attn"])


def _layer0_moe():
    """Layer 0's MoE weights of the reduced config, quantized by JAX and
    bridged: (JAX tree, port tree)."""
    _, jparams, _, tparams = _bridged_once()
    jp = jax.tree_util.tree_map(lambda x: x[0], jparams["blocks"]["moe"])
    return jp, transformer._layer(tparams["blocks"]["moe"], 0)


def _dropped(idx, s, group, cap_factor, e, k):
    """(token, choice) pairs past their expert's capacity in the grouped
    dispatch, counted in numpy from the chosen experts (B, S, K)."""
    g_sz = min(group, s)
    while s % g_sz:
        g_sz -= 1
    cap = max(int(cap_factor * g_sz * k / e), 1)
    cap = (cap + 3) & ~3
    n = 0
    for grp in idx.reshape(-1, g_sz * k):
        n += sum(max(0, np.sum(grp == x) - cap) for x in range(e))
    return n


MOE_CASES = {"grouped-cap-1.25": (False, 1.25, 64),
             "grouped-cap-0.25": (False, 0.25, 64),
             "grouped-s100-group64": (False, 1.25, 100),
             "dense-s100": (True, 1.25, 100)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_mlp_matches_jax(case, dtype):
    """``moe_mlp`` on the same numpy input (2 rows of S tokens) and the same
    Q8_0 weights as JAX's ``L.moe_mlp``, at both dispatches: the same
    chosen experts, and the outputs within 1e-5 (f32) or one bf16 ulp
    (2^-7) of the largest magnitude.  At capacity 0.25 pairs are in fact
    dropped; 100 tokens at groups of 64 cut groups of 50 (the dense
    dispatch has no capacity and no groups)."""
    dense, cap, s = MOE_CASES[case]
    jp, tp = _layer0_moe()
    rng = np.random.default_rng(int(cap * 100) + s)
    x = rng.standard_normal((2, s, 128)).astype(np.float32)
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    kw = dict(n_experts=8, top_k=2, group_size=64, capacity_factor=cap,
              dense_dispatch=dense)
    want = np.asarray(JL.moe_mlp(jp, xj, **kw).astype(jnp.float32))
    got = TL.moe_mlp(tp, xt, **kw).float().numpy()
    logits = jnp.einsum("bsd,ed->bse", xj.astype(jnp.float32), jp["router"])
    _, jidx = jax.lax.top_k(logits, 2)
    _, tidx = TL.moe_route(xt, tp["router"], 2)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    if cap < 1:
        assert _dropped(np.asarray(jidx), s, 64, cap, 8, 2) > 0
    tol = (1e-5 if dtype == "float32" else 2.0 ** -7) * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


@pytest.mark.parametrize("ones", [(), (5, 70, 90)], ids=["zeros", "three"])
def test_routing_breaks_ties_as_lax_top_k(ones):
    """On a row of 128 equal logits, and on a row of three ones among
    zeros, the port picks what ``lax.top_k`` picks: the largest logits
    first, ties to the lower expert index (experts 0-7; 5, 70, 90, then
    0-4)."""
    e = 128
    router = torch.zeros((e, 16))
    router[list(ones), 0] = 1.0
    x = torch.zeros((1, 1, 16))
    x[..., 0] = 1.0
    gates, idx = TL.moe_route(x, router, 8)
    logits = jnp.einsum("bsd,ed->bse", jnp.asarray(x.numpy()),
                        jnp.asarray(router.numpy()))
    jvals, jidx = jax.lax.top_k(logits, 8)
    assert idx[0, 0].tolist() == np.asarray(jidx)[0, 0].tolist() \
        == list(ones) + [i for i in range(8) if i not in ones][:8 - len(ones)]
    np.testing.assert_allclose(gates.numpy(),
                               np.asarray(jax.nn.softmax(jvals, -1)),
                               atol=1e-7, rtol=0)


def _hold_streams(tm, tparams, prompts, got, want, worth):
    """Equal streams with f32 compute.  In bf16 a stream may part only at a
    step whose top-2 logit gap is below twice the logits' bound (``worth *
    n_layers * u`` of their scale)."""
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
        assert gap < 2 * worth * tm.cfg.n_layers * U * scale, \
            (part, gap, scale)


ENGINES = {"paged-bf16": ("paged", dict()),
           "paged-int8": ("paged", dict(kv_cache_dtype="int8")),
           "dense-bf16": ("dense", dict()),
           "paged-f32": ("paged", F32),
           "paged-int8-f32": ("paged", dict(compute_dtype="float32",
                                            kv_cache_dtype="int8")),
           "dense-f32": ("dense", F32)}


@pytest.mark.parametrize("case", list(ENGINES))
def test_engine_matches_jax_engine(case, pinned):
    """The paged Engine on chunked traffic (prompts past the 16-token
    chunk, three queued behind two slots: the chunk step's grouped
    dispatch, the decode step's dense one) and the dense cache (the
    one-shot prefill's grouped dispatch; two prompt lengths, as the JAX
    one-shot prefill compiles once a length), with the same weights as
    the JAX engine: equal plan logs; greedy streams exactly equal with f32
    compute (the paged f32 and int8 pools and the dense cache), parting
    only at a logit near-tie in bf16 (``_hold_streams``)."""
    kind, over = ENGINES[case]
    jm, jparams, tm, tparams = _bridged(f"engine-{case}", **over)
    rng = np.random.default_rng(29)
    prompts = [rng.integers(4, 500, size=n).astype(np.int32)
               for n in ((21, 3, 17, 40, 9) if kind == "paged"
                         else (17, 3, 17, 3, 17))]
    kw = dict(ENGINE, cache_kind=kind)

    def run(eng):
        for p in prompts:
            eng.submit(p, max_new_tokens=6, temperature=0.0)
        done = sorted(eng.run(), key=lambda r: r.uid)
        assert all(r.error is None for r in done)
        return [list(r.output) for r in done], eng.plan_log

    want, want_log = run(JaxEngine(jm, jparams, **kw))
    got, got_log = run(Engine(tm, tparams, **kw, device="cpu"))
    assert got_log == want_log
    _hold_streams(tm, tparams, prompts, got, want,
                  DENSE_LAYER_WORTH if kind == "dense" else 2)


def test_speculative_engine_matches_jax(pinned):
    """n-gram speculation (k = 4) on a random and a repetitive prompt, f32
    compute and pool: the verify step runs the grouped dispatch at 5
    tokens a row.  Streams, plan logs (verifies included) and the
    speculation counters equal the JAX engine's."""
    jm, jparams, tm, tparams = _bridged("spec", **F32)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(4, 500, size=11).astype(np.int32),
               np.tile(np.asarray([7, 11, 13, 17], np.int32), 4)]
    kw = dict(max_slots=2, max_seq=96, page_size=8, spec_tokens=4)

    def run(eng):
        uids = [eng.submit(p, max_new_tokens=20, temperature=0.0)
                for p in prompts]
        done = {r.uid: r for r in eng.run()}
        assert all(done[u].error is None for u in uids)
        return [list(done[u].output) for u in uids]

    jeng = JaxEngine(jm, jparams, **kw)
    want = run(jeng)
    eng = Engine(tm, tparams, **kw, device="cpu")
    assert run(eng) == want
    assert eng.plan_log == jeng.plan_log
    assert eng.metrics["verify_steps"] == jeng.metrics["verify_steps"] > 0
    assert eng.metrics["accepted_tokens"] == jeng.metrics["accepted_tokens"]


def test_decode_matches_prefill():
    """As ``tests/test_models.py`` holds the JAX model: at capacity 8.0 (no
    pair dropped) and f32 compute, the decode step's logits (the dense
    dispatch) against a one-shot prefill of the sequence one token longer
    (the grouped dispatch): the same sums in other orders, within 1e-4."""
    cfg = tconfigs.reduced(tconfigs.get_config(ARCH)).with_(
        capacity_factor=8.0, compute_dtype="float32")
    m = build_model(cfg)
    params = m.quantize(m.init(2, device="cpu"))
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(4, 500, size=(2, 24)))
    logits, cache = m.prefill(params, {"tokens": toks}, max_seq=26)
    tok = torch.argmax(logits, -1)
    l_dec, _ = m.decode_step(params, cache, tok)
    l_ref, _ = m.prefill(params, {"tokens": torch.cat([toks, tok[:, None]],
                                                      1)}, max_seq=26)
    assert torch.isfinite(l_dec).all()
    np.testing.assert_allclose(l_dec.numpy(), l_ref.numpy(), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("policy", [None, dict(bits=4, min_size=512)],
                         ids=["q8_0", "q4_0"])
def test_init_quantized_is_quantize_of_init_bitwise(policy, monkeypatch):
    """``Model.init_quantized`` (the expert banks drawn a layer at a time,
    each weight quantized by slices as it is drawn) against
    ``Model.quantize(Model.init(seed))``: the same tree, every code and
    scale equal; the router f32 and unquantized in both, no ``w13``.
    Slices of 4096 values make every weight several slices."""
    monkeypatch.setattr(transformer, "_INIT_SLICE", 4096)
    m = build_model(tconfigs.reduced(tconfigs.get_config(ARCH)))
    pol = None if policy is None else QuantPolicy(**policy)
    got = m.init_quantized(5, pol, device="cpu")
    want = m.quantize(m.init(5, device="cpu"), pol)
    assert not tree_differs(got, want)
    moe = got["blocks"]["moe"]
    assert moe["router"].dtype == torch.float32 and "w13" not in moe
    assert moe["w2"].bits == (8 if policy is None else 4)
    assert m.init(5, device="cpu")["blocks"]["moe"]["w1"].dtype \
        == torch.bfloat16


def test_llama4_interleave_is_taken():
    """The llama4 interleave (``moe_every`` 2: dense layers between MoE
    ones) builds, initialises and draws as the MoE family does: the
    reference's ``blocks_dense`` (n_pat, moe_every - 1, ...) with a dense
    MLP and ``blocks_moe`` (n_pat, ...) with the router and expert banks,
    no ``blocks``; ``tests/test_torch_llama4.py`` holds it against JAX."""
    cfg = ModelConfig(**asdict(reduced(get_config(
        "llama4-maverick-400b-a17b"))))
    assert cfg.family == "moe" and cfg.moe_every == 2
    assert build_model(cfg).cfg == cfg
    for init in (transformer.init_params, transformer.init_quantized):
        tree = init(cfg, 0, device="cpu")
        assert set(tree) == {"embed", "final_norm", "blocks_dense",
                             "blocks_moe"}
        assert "mlp" in tree["blocks_dense"] and "moe" in tree["blocks_moe"]
        assert tree["blocks_moe"]["moe"]["router"].shape == (1, 8, 128)


def test_serve_cli_serves_qwen3_moe_on_the_cpu(capsys):
    """``serve.py --arch qwen3-moe-30b-a3b --device cpu``: the reduced
    config, quantized as it is drawn, serves every request at the
    reference's sampling; its parameters are ``quantize(init(seed))`` bit
    for bit."""
    serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                "--max-new", "4", "--slots", "2", "--max-seq", "64"])
    out = capsys.readouterr().out
    assert f"[serve] {ARCH} (2 layers, d_model 128) on cpu" in out
    assert "[serve] 3/3 requests" in out
    eng, done = serve.run(ARCH, requests=2, max_new=3, slots=2, max_seq=64,
                          seed=1, device="cpu")
    assert len(done) == 2 and all(1 <= len(r.output) <= 3 for r in done)
    assert all(0 <= t < eng.model.cfg.vocab_size for r in done
               for t in r.output)
    m = build_model(tconfigs.reduced(tconfigs.get_config(ARCH)))
    assert not tree_differs(eng.params, m.quantize(
        m.init(1, device="cpu"), QuantPolicy(bits=8, min_size=512)))
