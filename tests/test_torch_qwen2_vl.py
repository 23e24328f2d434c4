"""qwen2-vl-7b through the port against the JAX package, on the CPU.

The JAX package's config: the vlm family's language backbone, 28 layers,
d_model 3584, 28 query heads over 4 KV heads of 128 (7 a KV head), d_ff
18944, vocab 152064, rope theta 1e6, multimodal rope (``mrope``: the 64
rotation pairs of a head cut 16 / 24 / 24 between the temporal, height and
width position streams), bfloat16 compute.  Reduced: 2 layers, d_model 128,
4 query heads over 2 KV heads of 32, sections (4, 6, 6).  The vision
frontend is a stub in both packages: ``prefill`` takes precomputed patch
embeddings (B, S, D) and (3, B, S) positions.

Here: the config field for field; ``mrope_angles`` against JAX's at three
distinct streams, and bitwise ``rope_angles`` at three equal ones (text
tokens); the one-shot prefill on embeddings at three distinct streams
against JAX's; the paged engine (bf16 and int8 pools) and the dense engine
against the JAX engine on text tokens; the init that quantizes as it
draws; ``serve.py --arch qwen2-vl-7b`` on the CPU.  Both packages run the
``dequant`` strategy, the JAX prefix read on its plain reference.

Tolerances are ``tests/test_torch_llama3.py``'s: 1e-5 with f32 compute
(the packages part only by f32 summation order); in bfloat16 the logits
within ``2 * n_layers * u * max |logit|`` (u = 2^-8: one bfloat16 flip at
each of a layer's two residual adds), a greedy stream parting only at a
step whose top-2 gap is below twice that (the dense cache's one-shot
prefill ``2 + 1/2`` units a layer, ``tests/test_torch_llama3_dense.py``).
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
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.quantization import tree_differs
from repro_torch.kernels import build, ops
from repro_torch.launch import serve
from repro_torch.models import layers as TL
from repro_torch.models import transformer
from repro_torch.models.model import build_model
from repro_torch.serving.engine import Engine

from test_torch_llama3 import ENGINE, U, _top2_gaps

torch.set_num_threads(2)

ARCH = "qwen2-vl-7b"
F32 = dict(compute_dtype="float32", kv_cache_dtype="float32")
DENSE_LAYER_WORTH = 2 + 1 / 2


@pytest.fixture
def pinned(monkeypatch):
    """Both packages on ``dequant``, the JAX chunk step's prefix read on
    its plain reference; no CPU tensor reached a CUDA kernel."""
    monkeypatch.setenv("REPRO_FUSED_PREFILL", "oracle")
    old_j, old_t = jqlinear.default_strategy(), tqlinear.default_strategy()
    jqlinear.set_default_strategy("dequant")
    tqlinear.set_default_strategy("dequant")
    build.reset_launches()
    yield
    jqlinear.set_default_strategy(old_j)
    tqlinear.set_default_strategy(old_t)
    assert all(v == 0 for v in build.LAUNCHES.values())


def _bridged(tag, **over):
    """(JAX model, its Q8_0 params, port model, the bridged params) at the
    reduced config under an arch id of their own."""
    tag = f"{ARCH}-torch-parity-{tag}"
    jcfg = reduced(get_config(ARCH)).with_(arch_id=tag, **over)
    tcfg = tconfigs.reduced(tconfigs.get_config(ARCH)).with_(arch_id=tag,
                                                            **over)
    jm = jax_build_model(jcfg)
    jparams = jm.quantize(jm.init(jax.random.PRNGKey(0)))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return jm, jparams, build_model(tcfg), tparams


def test_config_is_the_reference_config():
    """The port's qwen2-vl-7b and its reduced form equal the JAX package's
    field for field; 7 query heads a KV head of 128 make one decode head
    group; the family has the paged pool."""
    full = tconfigs.get_config(ARCH)
    assert asdict(full) == asdict(get_config(ARCH))
    assert asdict(tconfigs.reduced(full)) == asdict(reduced(get_config(ARCH)))
    assert (full.family, full.n_layers, full.d_model, full.n_heads,
            full.n_kv_heads, full.hd(), full.d_ff, full.vocab_size,
            full.padded_vocab(), full.rope_theta, full.rope_type,
            full.mrope_sections, full.compute_dtype, full.tie_embeddings) \
        == ("vlm", 28, 3584, 28, 4, 128, 18944, 152064, 152064, 1e6,
            "mrope", (16, 24, 24), "bfloat16", True)
    assert tconfigs.reduced(full).mrope_sections == (4, 6, 6)
    assert ops.decode_head_groups(7, 128) == 1
    assert build_model(full).supports_paged_cache


@pytest.mark.parametrize("hd,sections,theta",
                         [(128, (16, 24, 24), 1e6), (32, (4, 6, 6), 1e6)],
                         ids=["full", "reduced"])
def test_mrope_angles_match_jax(hd, sections, theta):
    """cos / sin at three distinct position streams (temporal, height,
    width, below 1024) against JAX's within ``tests/test_torch_model.py``'s
    2e-5 for ``rope_angles`` (XLA's CPU cos and sin part from float64's by
    up to ~1e-5 at these angles), and within one f32 ulp (2^-23) of
    float64 cos / sin of the port's own f32 angles; at three equal streams
    bitwise the port's ``rope_angles``, so text tokens rotate as under
    plain rope."""
    rng = np.random.default_rng(hd)
    pos = rng.integers(0, 1024, size=(3, 2, 40)).astype(np.int32)
    jc, js = JL.mrope_angles(jnp.asarray(pos), hd, theta, sections)
    tc, ts = TL.mrope_angles(torch.from_numpy(pos), hd, theta, sections)
    assert tc.shape == (2, 40, hd)
    for got, want in ((tc, jc), (ts, js)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=2e-5, rtol=0)
    half = hd // 2
    freqs = (theta ** (-torch.arange(0, half, dtype=torch.float32)
                       / half)).numpy()
    ang = np.moveaxis(pos.astype(np.float32)[np.repeat(np.arange(3),
                                                       sections)], 0, -1)
    ang = np.concatenate([ang * freqs] * 2, -1).astype(np.float64)
    for got, fn in ((tc, np.cos), (ts, np.sin)):
        np.testing.assert_allclose(got.numpy(), fn(ang), atol=2.0 ** -23,
                                   rtol=0)
    # each band reads its own stream: bands of the height stream move with it
    moved = pos.copy()
    moved[1] += 1
    mc, _ = TL.mrope_angles(torch.from_numpy(moved), hd, theta, sections)
    band = (mc != tc)[..., :hd // 2].any(dim=(0, 1)).numpy()
    want_band = np.repeat(np.arange(3), sections) == 1
    assert (band == want_band).all()
    text = np.broadcast_to(pos[0], (3, 2, 40))
    ec, es = TL.mrope_angles(torch.from_numpy(text.copy()), hd, theta,
                             sections)
    rc, rs = TL.rope_angles(torch.from_numpy(pos[0]), hd, theta)
    assert torch.equal(ec, rc) and torch.equal(es, rs)
    with pytest.raises(ValueError, match="sum"):
        TL.mrope_angles(torch.from_numpy(pos), hd, theta, (1, 2, 3))


@pytest.mark.parametrize("over", [F32, dict()], ids=["f32", "bf16"])
def test_prefill_on_embeds_at_three_streams_matches_jax(over, pinned):
    """``Model.prefill`` on stub patch embeddings (B, S, D) at three
    distinct (3, B, S) position streams (a 4 x 5 patch grid after 6 text
    tokens, as Qwen2-VL numbers them), against JAX's ``prefill`` on the
    same inputs: last-position logits and the dense cache's K/V within the
    stated tolerance.  Text tokens at default positions equal the same
    tokens' embeddings at three explicit equal streams, bitwise."""
    tag = "f32" if over else "bf16"
    jm, jparams, tm, tparams = _bridged(f"prefill-{tag}", **over)
    cfg = tm.cfg
    f32 = cfg.compute_dtype == "float32"
    b, s = 2, 26
    rng = np.random.default_rng(31)
    emb = (rng.standard_normal((b, s, cfg.d_model)) * 0.5).astype(np.float32)
    t = np.r_[np.arange(6), np.full(20, 6)]
    h = np.r_[np.arange(6), 6 + np.repeat(np.arange(4), 5)]
    w = np.r_[np.arange(6), 6 + np.tile(np.arange(5), 4)]
    pos = np.broadcast_to(np.stack([t, h, w])[:, None], (3, b, s))
    pos = np.ascontiguousarray(pos, dtype=np.int32)
    jl, jc = jax.jit(jm.prefill, static_argnames="max_seq")(
        jparams, {"embeds": jnp.asarray(emb), "positions": jnp.asarray(pos)},
        max_seq=32)
    tl, tc = tm.prefill(tparams, {"embeds": torch.from_numpy(emb),
                                  "positions": torch.from_numpy(pos)},
                        max_seq=32)
    want = np.asarray(jnp.asarray(jl, jnp.float32))
    tol = 1e-5 if f32 else 2 * cfg.n_layers * U * np.abs(want).max()
    np.testing.assert_allclose(tl.numpy(), want, atol=tol, rtol=0)
    for key in ("k", "v"):
        got = tc["attn"][key].float().numpy()
        ref = np.asarray(jnp.asarray(jc["attn"][key], jnp.float32))
        np.testing.assert_allclose(got, ref, atol=1e-5 if f32 else
                                   4 * U * np.abs(ref).max(), rtol=0,
                                   err_msg=key)
    # the streams matter: the same embeddings at text positions part
    tl_text, _ = tm.prefill(tparams, {"embeds": torch.from_numpy(emb)},
                            max_seq=32)
    assert (tl_text - tl).abs().max() > 10 * tol
    toks = torch.from_numpy(rng.integers(4, 500, size=(b, 9)))
    plain, _ = tm.prefill(tparams, {"tokens": toks})
    equal = torch.arange(9, dtype=torch.int32).expand(3, b, 9)
    explicit, _ = tm.prefill(tparams, {"tokens": toks, "positions": equal})
    assert torch.equal(plain, explicit)


ENGINES = {"paged-bf16": ("paged", dict()),
           "paged-int8": ("paged", dict(kv_cache_dtype="int8")),
           "dense-bf16": ("dense", dict()),
           "paged-f32": ("paged", F32),
           "dense-f32": ("dense", F32)}


@pytest.mark.parametrize("case", list(ENGINES))
def test_engine_matches_jax_engine(case, pinned):
    """The paged Engine on chunked traffic (prompts past the 16-token
    chunk, three queued behind two slots) and the dense cache, on text
    tokens (three equal position streams), with the same weights as the
    JAX engine: equal plan logs; greedy streams exactly equal with f32
    compute, parting only at a logit near-tie in bf16."""
    kind, over = ENGINES[case]
    jm, jparams, tm, tparams = _bridged(f"engine-{case}", **over)
    rng = np.random.default_rng(24)
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
    worth = DENSE_LAYER_WORTH if kind == "dense" else 2
    for prompt, g, w in zip(prompts, got, want):
        if tm.cfg.compute_dtype == "float32":
            assert g == w
            continue
        part = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b),
                    None)
        if part is not None:
            gap, scale = _top2_gaps(tm, tparams, prompt, w)[part]
            assert gap < 2 * worth * tm.cfg.n_layers * U * scale, (part, gap)


def test_rmsnorm_quant_plan_at_k3584():
    """At qwen2-vl-7b's K 3584 (7 x 512: 896 float4s, a ragged last sweep
    at every width) PyTorch's row mean takes 512 / 256 / 128 / 64 / 32 x
    threads at M = 1 / 2 / 4 / 8 / 16+ and never splits a row across
    warp-rows; the register kernel's plan holds a row in 2 / 4 / 8 / 16 /
    32 float4s a thread, rows sharing blocks of 256 threads at M 2048.
    ``quantize`` at K 3584 and 18944 takes 32 and 256 threads a row."""
    k = 3584
    seen = {}
    for m in range(1, 2049):
        width, _ = ops._torch_row_mean_order(m, k)
        assert ops._torch_row_split(m, k) == 1
        seen.setdefault(width, m)
        threads, _, vecs = ops.rmsnorm_quant_plan(m, k, width)
        assert threads == width and vecs * 4 * width >= k
    assert seen == {512: 1, 256: 2, 128: 4, 64: 8, 32: 16}
    assert ops.rmsnorm_quant_plan(2048, k, 32) == (32, 8, 32)
    assert (ops.quantize_width(3584), ops.quantize_width(18944)) == (32, 256)


@pytest.mark.parametrize("m", [8, 2048])
def test_plain_rmsnorm_quant_at_k3584_matches_jax(m):
    """The port's ``rmsnorm_quant`` on the CPU (its plain version) at K
    3584 with one all-zero group and one row at 1e4, against the JAX plain
    version and, at M 8, the Pallas kernel in interpret mode: scales
    within ``tests/test_torch_kernels.py``'s 4e-7 relative, codes within
    one step where the two f32 means of 3584 squares part by an ulp, the
    zero group exact."""
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    k = 3584
    rng = np.random.default_rng(m)
    x = (rng.standard_normal((m, k)) * 3.0).astype(np.float32)
    x[0, 64:128] = 0.0
    x[-1] *= 1e4
    g = rng.standard_normal(k).astype(np.float32)
    tq, ts = ops.rmsnorm_quant(torch.from_numpy(x), torch.from_numpy(g))
    want = [jref.ref_rmsnorm_quant(jnp.asarray(x), jnp.asarray(g))]
    if m == 8:
        want.append(jops.rmsnorm_quant(jnp.asarray(x), jnp.asarray(g),
                                       interpret=True))
    for wq, ws in want:
        diff = np.abs(tq.numpy().astype(np.int32)
                      - np.asarray(wq).astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-5
        np.testing.assert_allclose(ts.numpy(), np.asarray(ws), rtol=4e-7,
                                   atol=0)
    assert (tq[0, 64:128] == 0).all() and ts[0, 1] == 0


def test_init_quantized_is_quantize_of_init_bitwise(monkeypatch):
    """``Model.init_quantized`` against ``Model.quantize(Model.init(5))``
    with the fused operands: the same tree, every code and scale equal.
    Slices of 4096 values make every weight several slices."""
    monkeypatch.setattr(transformer, "_INIT_SLICE", 4096)
    m = build_model(tconfigs.reduced(tconfigs.get_config(ARCH)))
    got = m.init_quantized(5, device="cpu")
    assert not tree_differs(got, m.quantize(m.init(5, device="cpu")))
    assert "wqkv" in got["blocks"]["attn"] and "w13" in got["blocks"]["mlp"]


def test_serve_cli_serves_qwen2_vl_on_the_cpu(capsys):
    """``serve.py --arch qwen2-vl-7b --device cpu``: the reduced config,
    quantized as it is drawn, serves every request at the reference's
    sampling; its parameters are ``quantize(init(seed))`` bit for bit."""
    serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                "--max-new", "4", "--slots", "2", "--max-seq", "64"])
    out = capsys.readouterr().out
    assert f"[serve] {ARCH} (2 layers, d_model 128) on cpu" in out
    assert "[serve] 3/3 requests" in out
    eng, done = serve.run(ARCH, requests=2, max_new=3, slots=2, max_seq=64,
                          seed=1, device="cpu")
    assert eng.paged and len(done) == 2
    assert all(1 <= len(r.output) <= 3 for r in done)
    m = build_model(tconfigs.reduced(tconfigs.get_config(ARCH)))
    assert not tree_differs(eng.params, m.quantize(
        m.init(1, device="cpu"), QuantPolicy(bits=8, min_size=512)))
