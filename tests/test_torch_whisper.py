"""whisper-small through the port against the JAX package, on the CPU.

The JAX package's config: the audio family's encoder-decoder, 12 encoder
and 12 decoder layers, d_model 768, 12 heads of 64, d_ff 3072, vocab 51865
(head 51968 rows), LayerNorm, a GELU MLP, learned positions, 1504 encoder
frames, bfloat16 compute.  Reduced: 2 + 2 layers, d_model 128, 4 heads of
32, d_ff 256, vocab 512, 64 encoder frames.  The conv frontend is a stub in
both packages: the encoder takes frame embeddings (B, enc_seq, D), made
here from a seed.

Here: the config field for field; ``layer_norm`` and ``gelu_mlp`` against
JAX's, and the exact GELU parting from the tanh form beyond the tolerance
(PyTorch's default is the exact form, ``jax.nn.gelu``'s the tanh one);
``encode``; ``prefill``'s logits and both caches (bf16 and int8); a
16-step greedy ``decode_step`` loop; ``Model.quantize`` of the bridged
init and the bridge of the quantized tree, both bitwise the reference's;
``init_quantized``; the refusal of the engine and of ``serve.py``.  The
reference is served at the model level (its engine prefills tokens alone,
and the encoder needs frames): so is the port.  Both packages run the
``dequant`` strategy.

Tolerances.  With f32 compute the packages part only by f32 summation
order: 1e-5 (``tests/test_torch_llama3.py``), greedy tokens equal.  In
bfloat16, as ``tests/test_torch_llama3.py`` counts a decoder layer: one
unit u = 2^-8 of the logits' scale for each residual add a bfloat16 flip
can reach them through, a decoder layer's three (self-attention,
cross-attention, MLP) and an encoder layer's two, which reach them through
the cross K/V: logits within ``(3 * n_layers + 2 * n_enc_layers) * u *
max |logit|``.  A bfloat16 row (the encoder's output, a K/V row) within
those units and two ulps of its own (its norm's and its product's
roundings, 2^-6) of its largest value; an int8 code within 2.
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
from repro.models import encdec as JE
from repro.models import layers as JL
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax
from repro_torch.core import qlinear as tqlinear
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.quantization import QuantizedTensor, tree_differs
from repro_torch.kernels import build
from repro_torch.launch import serve
from repro_torch.models import encdec as TE
from repro_torch.models import layers as TL
from repro_torch.models import transformer
from repro_torch.models.model import build_model
from repro_torch.serving.engine import Engine

torch.set_num_threads(2)

ARCH = "whisper-small"
U = 2.0 ** -8                     # bfloat16 unit roundoff
F32 = dict(compute_dtype="float32", kv_cache_dtype="float32")
B, S = 2, 7                       # prompts of 7 tokens in 2 rows
MAX_SEQ = S + 16


@pytest.fixture
def pinned():
    """Both packages on ``dequant``; no CPU tensor reached a CUDA kernel."""
    old_j, old_t = jqlinear.default_strategy(), tqlinear.default_strategy()
    jqlinear.set_default_strategy("dequant")
    tqlinear.set_default_strategy("dequant")
    build.reset_launches()
    yield
    jqlinear.set_default_strategy(old_j)
    tqlinear.set_default_strategy(old_t)
    assert all(v == 0 for v in build.LAUNCHES.values())


def _cfgs(tag, **over):
    tag = f"{ARCH}-torch-parity-{tag}"
    return (reduced(get_config(ARCH)).with_(arch_id=tag, **over),
            tconfigs.reduced(tconfigs.get_config(ARCH)).with_(arch_id=tag,
                                                             **over))


def _bridged(tag, **over):
    """(JAX model, its Q8_0 params, port model, the bridged params) at the
    reduced config; the JAX prefill and decode step jitted (eager, each
    op compiles alone)."""
    jcfg, tcfg = _cfgs(tag, **over)
    jm = jax_build_model(jcfg)
    jparams = jm.quantize(jm.init(jax.random.PRNGKey(0)))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return jm, jparams, build_model(tcfg), tparams


def _inputs(cfg, seed=3):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, cfg.enc_seq, cfg.d_model)).astype(
        np.float32)
    tokens = rng.integers(4, cfg.vocab_size, size=(B, S)).astype(np.int32)
    return frames, tokens


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _units(cfg):
    """bfloat16 sites whose flips reach the logits: three residual adds a
    decoder layer, two an encoder layer."""
    return 3 * cfg.n_layers + 2 * cfg.n_enc_layers


def _logit_tol(cfg, want):
    if cfg.compute_dtype == "float32":
        return 1e-5
    return _units(cfg) * U * np.abs(want).max()


def _rows_close(cfg, got, want, what):
    """bf16 rows within ``_units + 4`` units of their largest values."""
    row = np.abs(want).max(axis=-1, keepdims=True)
    assert (np.abs(got - want) <= (_units(cfg) + 4) * U * row).all(), what


def test_config_is_the_reference_config():
    """The port's whisper-small and its reduced form equal the JAX
    package's field for field; the family builds, has no paged pool, and
    its fused decode operands are none."""
    full = tconfigs.get_config(ARCH)
    assert asdict(full) == asdict(get_config(ARCH))
    assert asdict(tconfigs.reduced(full)) == asdict(reduced(get_config(ARCH)))
    assert (full.family, full.n_enc_layers, full.n_layers, full.d_model,
            full.n_heads, full.n_kv_heads, full.hd(), full.d_ff,
            full.vocab_size, full.padded_vocab(), full.enc_seq,
            full.norm_type, full.mlp_type, full.rope_type,
            full.compute_dtype) == (
        "audio", 12, 12, 768, 12, 12, 64, 3072, 51865, 51968, 1504,
        "layernorm", "gelu", "none", "bfloat16")
    r = tconfigs.reduced(full)
    assert (r.n_enc_layers, r.enc_seq) == (2, 64)
    assert not build_model(full).supports_paged_cache


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_and_gelu_mlp_match_jax(dtype):
    """``layer_norm`` (f32 mean, biased variance) on rows with an offset
    and a spread, and ``gelu_mlp`` on Q8_0 weights (dequant), against
    JAX's: f32 within 1e-5 of the output's scale, bf16 within one ulp of
    it.  The exact GELU in the tanh form's place parts from JAX by more
    than 10 times the f32 tolerance (``test_exact_gelu_parts_from_jax``
    holds the model's logits)."""
    dt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((5, 128)) * 3 + 2).astype(np.float32)
    g = rng.standard_normal(128).astype(np.float32)
    be = rng.standard_normal(128).astype(np.float32)
    want = _f32(JL.layer_norm(jnp.asarray(x).astype(jdt), jnp.asarray(g),
                              jnp.asarray(be)))
    got = _f32(TL.layer_norm(torch.from_numpy(x).to(dt), torch.from_numpy(g),
                             torch.from_numpy(be)))
    tol = (1e-5 if dtype == "float32" else 2 * U) * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    assert TL.apply_norm(torch.from_numpy(x), {"gamma": torch.from_numpy(g),
                                               "beta": torch.from_numpy(be)},
                         "layernorm").shape == (5, 128)
    with pytest.raises(ValueError, match="fused"):
        TL.norm_gamma({"gamma": torch.from_numpy(g)}, "layernorm")

    jm, jparams, tm, tparams = _bridged("mlp")
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["dec_blocks"]["mlp"])
    tp = transformer._layer(tparams["dec_blocks"]["mlp"], 0)
    h = (rng.standard_normal((3, 9, 128))).astype(np.float32)
    old = jqlinear.default_strategy(), tqlinear.default_strategy()
    jqlinear.set_default_strategy("dequant")
    tqlinear.set_default_strategy("dequant")
    try:
        want = _f32(JL.gelu_mlp(jp, jnp.asarray(h).astype(jdt)))
        got = _f32(TL.gelu_mlp(tp, torch.from_numpy(h).to(dt)))
        tol = (1e-5 if dtype == "float32" else 2 * U) * np.abs(want).max()
        np.testing.assert_allclose(got, want, atol=tol, rtol=0)
        if dtype == "float32":
            wrong = _f32(_exact_gelu_mlp(tp, torch.from_numpy(h)))
            assert np.abs(wrong - want).max() > 10 * tol
    finally:
        jqlinear.set_default_strategy(old[0])
        tqlinear.set_default_strategy(old[1])


def _exact_gelu_mlp(p, x):
    """``gelu_mlp`` with PyTorch's default, the exact erf GELU: the trap."""
    h = torch.nn.functional.gelu(tqlinear.qdot(x, p["w1"]))
    return tqlinear.qdot(h.to(x.dtype), p["w2"]).to(x.dtype)


def test_exact_gelu_parts_from_jax(pinned, monkeypatch):
    """With the exact GELU in the tanh form's place, the f32 prefill's
    logits part from JAX's by more than 10 times the 1e-5 the port holds
    (``test_prefill_and_greedy_decode_match_jax``): the tolerance sees the
    trap."""
    jm, jparams, tm, tparams = _bridged("exact-gelu", **F32)
    frames, tokens = _inputs(tm.cfg)
    jl, _ = jax.jit(lambda p, b: jm.prefill(p, b))(
        jparams, {"frames": jnp.asarray(frames),
                  "tokens": jnp.asarray(tokens)})
    batch = {"frames": torch.from_numpy(frames),
             "tokens": torch.from_numpy(tokens)}
    tl, _ = tm.prefill(tparams, batch)
    assert np.abs(_f32(tl) - _f32(jl)).max() <= 1e-5
    monkeypatch.setattr(TL, "gelu_mlp", _exact_gelu_mlp)
    wrong, _ = tm.prefill(tparams, batch)
    assert np.abs(_f32(wrong) - _f32(jl)).max() > 10 * 1e-5


@pytest.mark.parametrize("over", [F32, dict()], ids=["f32", "bf16"])
def test_encode_matches_jax(over, pinned):
    """The encoder (non-causal attention over its 64 frames, two layers,
    the final norm) on seeded frames: within 1e-5 of the output's scale in
    f32, two bfloat16 ulps of each row's largest value in bf16."""
    tag = "f32" if over else "bf16"
    jm, jparams, tm, tparams = _bridged(f"encode-{tag}", **over)
    frames, _ = _inputs(tm.cfg)
    want = _f32(jax.jit(JE.encode, static_argnums=1)(
        jparams, jm.cfg, jnp.asarray(frames)))
    got = _f32(TE.encode(tparams, tm.cfg, torch.from_numpy(frames)))
    assert got.shape == (B, tm.cfg.enc_seq, tm.cfg.d_model)
    if over:
        np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(),
                                   rtol=0)
    else:
        _rows_close(tm.cfg, got, want, "encoder output")


CASES = {"f32": F32, "bf16": dict(), "bf16-int8": dict(kv_cache_dtype="int8"),
         "f32-int8": dict(compute_dtype="float32", kv_cache_dtype="int8")}


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_greedy_decode_match_jax(case, pinned):
    """``prefill`` on seeded frames and 7-token prompts (2 rows), then a
    16-step greedy ``decode_step`` loop fed the JAX side's tokens: the
    prefill's logits and both caches (self at 23 positions, cross at the
    64 frames; bf16 or int8 codes with their scales), and every step's
    logits, against JAX's within the stated tolerance; with f32 compute
    the port's own greedy tokens equal JAX's at every step; ``lens`` equal
    after each step."""
    over = CASES[case]
    jm, jparams, tm, tparams = _bridged(f"serve-{case}", **over)
    cfg = tm.cfg
    frames, tokens = _inputs(cfg)
    jprefill = jax.jit(lambda p, b: jm.prefill(p, b, max_seq=MAX_SEQ))
    jdecode = jax.jit(jm.decode_step)
    jl, jc = jprefill(jparams, {"frames": jnp.asarray(frames),
                                "tokens": jnp.asarray(tokens)})
    tl, tc = tm.prefill(tparams, {"frames": torch.from_numpy(frames),
                                  "tokens": torch.from_numpy(tokens)},
                        max_seq=MAX_SEQ)
    want = _f32(jl)
    np.testing.assert_allclose(_f32(tl), want, atol=_logit_tol(cfg, want),
                               rtol=0)
    assert tc["self"]["k"].shape == (cfg.n_layers, B, MAX_SEQ,
                                     cfg.n_kv_heads, cfg.hd())
    assert tc["cross"]["k"].shape[2] == cfg.enc_seq
    f32 = cfg.compute_dtype == "float32"
    int8 = cfg.kv_cache_dtype == "int8"
    for part in ("self", "cross"):
        assert set(tc[part]) == set(jc[part])
        for key in jc[part]:
            got, ref = _f32(tc[part][key]), _f32(jc[part][key])
            if key in ("k", "v") and int8:
                assert np.abs(got - ref).max() <= 2, (part, key)
            elif key in ("k", "v") and not f32:
                _rows_close(cfg, got, ref, (part, key))
            else:
                np.testing.assert_allclose(
                    got, ref, atol=(1e-5 if f32 else 4 * U)
                    * max(np.abs(ref).max(), 1e-30), rtol=0,
                    err_msg=f"{part}/{key}")
    jtok = jnp.argmax(jl, -1)
    for step in range(16):
        if f32:
            assert (torch.argmax(tl, -1).numpy() == np.asarray(jtok)).all(), \
                step
        jl, jc = jdecode(jparams, jc, jtok)
        tl, tc = tm.decode_step(tparams, tc, torch.from_numpy(
            np.array(jtok, np.int64)))
        want = _f32(jl)
        np.testing.assert_allclose(_f32(tl), want,
                                   atol=_logit_tol(cfg, want), rtol=0,
                                   err_msg=f"step {step}")
        np.testing.assert_array_equal(tc["lens"].numpy(),
                                      np.asarray(jc["lens"]))
        jtok = jnp.argmax(jl, -1)
    assert tc["lens"].tolist() == [S + 16] * B


def test_quantize_and_bridge_are_the_references_bitwise():
    """The JAX init bridged as floats, then the port's ``Model.quantize``,
    against JAX's ``Model.quantize`` of the same init bridged: the same
    tree (two stacks, the cross-attention, the layer norms' gamma and
    beta), the same leaves quantized (the positions and norms float, no
    fused operand), every code and scale equal; the bridge keeps every
    leaf's dtype and shape."""
    jcfg, tcfg = _cfgs("quantize")
    jm = jax_build_model(jcfg)
    jinit = jm.init(jax.random.PRNGKey(1))
    tm = build_model(tcfg)
    tinit = params_from_jax(jax.tree_util.tree_map(np.asarray, jinit),
                            device="cpu")
    want = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jm.quantize(jinit)), device="cpu")
    got = tm.quantize(tinit)
    assert not tree_differs(got, want)
    assert set(got) == {"embed", "enc_pos", "dec_pos", "enc_blocks",
                        "dec_blocks", "enc_final_norm", "final_norm"}
    dec = got["dec_blocks"]
    assert set(dec) == {"norm1", "attn", "norm_x", "cross", "norm2", "mlp"}
    assert set(dec["attn"]) == {"wq", "wk", "wv", "wo"}
    assert set(dec["mlp"]) == {"w1", "w2"}
    for leaf in (got["embed"], dec["cross"]["wk"], dec["mlp"]["w2"],
                 got["enc_blocks"]["attn"]["wo"]):
        assert isinstance(leaf, QuantizedTensor) and leaf.bits == 8
    for leaf in (got["enc_pos"], got["dec_pos"], dec["norm_x"]["beta"],
                 got["final_norm"]["gamma"]):
        assert isinstance(leaf, torch.Tensor) and leaf.dtype == torch.float32
    assert tinit["dec_blocks"]["cross"]["wq"].shape == (2, 4, 32, 128)


def test_init_quantized_is_quantize_of_init_bitwise(monkeypatch):
    """``Model.init_quantized`` against ``Model.quantize(Model.init(5))``:
    the same tree, every code and scale equal, no fused operand; slices of
    4096 values make every weight several slices."""
    monkeypatch.setattr(transformer, "_INIT_SLICE", 4096)
    m = build_model(tconfigs.reduced(tconfigs.get_config(ARCH)))
    got = m.init_quantized(5, device="cpu")
    assert not tree_differs(got, m.quantize(m.init(5, device="cpu")))
    assert "wqkv" not in got["dec_blocks"]["attn"]


def test_engine_and_serve_refuse_the_audio_family():
    """The port's engine and ``serve.py`` refuse whisper-small with a
    ``NotImplementedError`` naming the reason (the engine prefills tokens
    alone, and the encoder needs frames), before drawing any weight."""
    cfg = tconfigs.reduced(tconfigs.get_config(ARCH))
    m = build_model(cfg)
    params = m.init_quantized(0, device="cpu")
    with pytest.raises(NotImplementedError, match="model level.*frames"):
        Engine(m, params, max_slots=2, max_seq=32, device="cpu")
    with pytest.raises(NotImplementedError, match="model level.*frames"):
        serve.run(ARCH, requests=1, device="cpu")
    with pytest.raises(NotImplementedError, match="model level"):
        serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "1"])
