"""command-r-35b through the port against the JAX package, on the CPU.

The JAX package's config (not Hugging Face's): the dense SwiGLU family with
RMSNorm and tied embeddings, bfloat16 compute and KV pool, at 40 layers,
d_model 8192, 64 query heads over 8 KV heads of 128, d_ff 22528, vocab
256000 and rope theta 8e6.

Here: the config and its reduced form field for field; ``rope_angles`` at
theta 8e6 against JAX's; the reduced engine (2 layers, d_model 128, 4
query heads over 2 KV heads of 32), and a variant keeping command-r-35b's
8-to-1 head ratio (16 query heads over 2 KV heads of 32), with the same
weights (JAX ``init`` + ``Model.quantize``, bridged) against the JAX
engine; the init that quantizes as it draws, bitwise the port's
``quantize(init)`` with the fused operands; ``rmsnorm_quant``'s launch
plan at K 8192 (PyTorch's row mean splits a row across 512 threads there)
and its plain version against the JAX reference and the Pallas kernel;
``serve.py --arch command-r-35b`` on the CPU.  Tolerances are
``tests/test_torch_llama3.py``'s.
"""

from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as JL
from repro.serving.engine import Engine as JaxEngine
from repro_torch import configs as tconfigs
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.quantization import QuantizedTensor, tree_differs
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import layers as TL
from repro_torch.models.model import build_model
from repro_torch.serving.engine import Engine

from test_torch_llama3 import ENGINE, U, _top2_gaps, pinned  # noqa: F401

torch.set_num_threads(2)

ARCH = "command-r-35b"


def test_config_is_the_reference_config():
    """The port's command-r-35b and its reduced form equal the JAX
    package's field for field; it differs from glm4-9b only in fields the
    reference's own file sets."""
    full = tconfigs.get_config(ARCH)
    assert asdict(full) == asdict(get_config(ARCH))
    assert asdict(tconfigs.reduced(full)) == asdict(reduced(get_config(ARCH)))
    g4 = tconfigs.get_config("glm4-9b")
    differ = {k for k, v in asdict(full).items() if asdict(g4)[k] != v}
    assert differ == {"arch_id", "d_model", "n_heads", "n_kv_heads", "d_ff",
                      "vocab_size", "rope_theta"}
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.hd(), full.d_ff, full.vocab_size, full.padded_vocab(),
            full.rope_theta, full.compute_dtype, full.kv_cache_dtype,
            full.norm_type, full.mlp_type, full.tie_embeddings) == (
        40, 8192, 64, 8, 128, 22528, 256000, 256000, 8e6, "bfloat16",
        "bfloat16", "rmsnorm", "swiglu", True)
    # the head's codes: 2.3% under 2^31
    assert full.padded_vocab() * full.d_model < 2 ** 31
    assert ops.decode_head_groups(full.n_heads // full.n_kv_heads,
                                  full.hd()) == 1


def test_rope_angles_at_theta_8e6_match_jax():
    """cos / sin at head_dim 128 and theta 8e6 for positions 0..1023
    against JAX's, within test_torch_model.py's 2e-5."""
    pos = np.arange(1024, dtype=np.int32)
    jc, js = JL.rope_angles(jnp.asarray(pos), 128, 8e6)
    tc, ts = TL.rope_angles(torch.from_numpy(pos), 128, 8e6)
    assert tc.shape == (1024, 128)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-5, rtol=0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=2e-5, rtol=0)


def _bridged(tag, **over):
    from repro.models import build_model as jax_build_model
    from repro_torch.bridge import params_from_jax
    tag = f"{ARCH}-torch-parity-{tag}"
    jcfg = reduced(get_config(ARCH)).with_(arch_id=tag, **over)
    tcfg = tconfigs.reduced(tconfigs.get_config(ARCH)).with_(arch_id=tag,
                                                            **over)
    jm = jax_build_model(jcfg)
    jparams = jm.quantize(jm.init(jax.random.PRNGKey(0)))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return jm, jparams, build_model(tcfg), tparams


# command-r-35b's head ratio (8 query heads a KV head) at the reduced width
HEADS = dict(n_heads=16, n_kv_heads=2, head_dim=32)
F32 = dict(compute_dtype="float32", kv_cache_dtype="float32")


@pytest.mark.parametrize("over", [dict(), F32, HEADS, {**HEADS, **F32}],
                         ids=["bf16", "f32", "heads-16-2-bf16",
                              "heads-16-2-f32"])
def test_engine_matches_jax_engine(over, pinned):
    """The paged Engine on chunked traffic (prompts past the 16-token
    chunk, three queued behind two slots), at the reduced config and at a
    variant with command-r-35b's 8 query heads a KV head: equal plan logs;
    greedy streams equal up to a near-tie in bf16 (a top-2 gap below twice
    the logits' bound ``2 * n_layers * u * max |logit|``), exactly equal
    with f32 compute."""
    tag = "-".join(str(v) for v in over.values()) or "bf16"
    jm, jparams, tm, tparams = _bridged(f"engine-{tag}", **over)
    assert (tm.cfg.n_heads, tm.cfg.n_kv_heads) == (
        (16, 2) if "n_heads" in over else (4, 2))
    rng = np.random.default_rng(28)
    prompts = [rng.integers(4, 500, size=n).astype(np.int32)
               for n in (21, 3, 17, 40, 9)]

    def run(eng):
        for p in prompts:
            eng.submit(p, max_new_tokens=6, temperature=0.0)
        done = sorted(eng.run(), key=lambda r: r.uid)
        assert all(r.error is None for r in done)
        return [list(r.output) for r in done], eng.plan_log

    want, want_log = run(JaxEngine(jm, jparams, **ENGINE))
    got, got_log = run(Engine(tm, tparams, **ENGINE, device="cpu"))
    assert got_log == want_log
    f32 = tm.cfg.compute_dtype == "float32"
    for prompt, g, w in zip(prompts, got, want):
        if f32:
            assert g == w
            continue
        part = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b),
                    None)
        if part is not None:
            gap, scale = _top2_gaps(tm, tparams, prompt, w)[part]
            assert gap < 2 * 2 * tm.cfg.n_layers * U * scale, (part, gap)


@pytest.mark.parametrize("policy", [None, dict(bits=4, min_size=512)],
                         ids=["q8_0", "q4_0"])
@pytest.mark.parametrize("over", [dict(), dict(n_layers=4, d_model=256)],
                         ids=["reduced", "4-layers-d256"])
def test_init_quantized_is_quantize_of_init_bitwise(over, policy,
                                                    monkeypatch):
    """``Model.init_quantized`` (each weight quantized by slices as it is
    drawn, scaled in place) against ``Model.quantize(Model.init(seed))``
    with the fused operands: the same tree, every code and scale equal.
    Slices of 4096 values make every weight several slices."""
    from repro_torch.models import transformer
    monkeypatch.setattr(transformer, "_INIT_SLICE", 4096)
    cfg = tconfigs.reduced(tconfigs.get_config(ARCH)).with_(**over)
    m = build_model(cfg)
    pol = None if policy is None else QuantPolicy(**policy)
    got = m.init_quantized(5, pol, device="cpu")
    want = m.quantize(m.init(5, device="cpu"), pol)
    assert not tree_differs(got, want)
    assert "wqkv" in got["blocks"]["attn"] and "w13" in got["blocks"]["mlp"]
    w2 = got["blocks"]["mlp"]["w2"]
    assert isinstance(w2, QuantizedTensor) and w2.bits == (
        8 if policy is None else 4)


def test_rmsnorm_quant_plan_at_k8192_takes_torchs_split():
    """At command-r-35b's K 8192 PyTorch's row mean splits each row across
    its block's warp-rows from M = 2 on (each x thread would sum at least
    min(16 * height, 256) values): 512 threads a row, x threads 256 / 128 /
    64 / 32 at M = 2 / 4 / 8 / 16+, 4 float4s each, the register kernel's
    plan for every M of 1..2048.  At glm4-9b's K 4096 (and every K served
    before) no M splits: the launches of the shapes served before keep
    their plans."""
    k = 8192
    seen = {}
    for m in range(1, 2049):
        width, _ = ops._torch_row_mean_order(m, k)
        split = ops._torch_row_split(m, k)
        plan = ops.rmsnorm_quant_plan(m, k, width, split)
        assert plan == (width * split, 1, 4 if width * split == 512 else 8)
        seen.setdefault((width, split), m)
    assert seen == {(512, 1): 1, (256, 2): 2, (128, 4): 4, (64, 8): 8,
                    (32, 16): 16}
    for k in (128, 768, 2048, 3072, 4096):
        assert all(ops._torch_row_split(m, k) == 1 for m in range(1, 2049))
    # a row PyTorch would also split across blocks is refused
    with pytest.raises(ValueError, match="across blocks"):
        ops._torch_row_split(2048, 1 << 17)


@pytest.mark.parametrize("m", [16, 2048])
def test_plain_rmsnorm_quant_at_k8192_matches_jax(m):
    """The port's ``rmsnorm_quant`` on the CPU (its plain version) at K
    8192, M 16 (the verify step's rows) and 2048 (a chunk step's), with
    one all-zero group and one row at 1e4, against the JAX plain version
    (``kernels/ref.py``) and, at M 16, the Pallas kernel in interpret mode:
    scales within test_torch_kernels.py's 4e-7 relative; codes within one
    step, where the two f32 means of 8192 squares (PyTorch's and XLA's CPU
    sums, in other orders) part by an ulp and a rounding flips (none at M
    16, 10 of 16.8M codes at M 2048); the zero group exact."""
    k = 8192
    rng = np.random.default_rng(m)
    x = (rng.standard_normal((m, k)) * 3.0).astype(np.float32)
    x[0, 64:128] = 0.0
    x[-1] *= 1e4
    g = rng.standard_normal(k).astype(np.float32)
    tq, ts = ops.rmsnorm_quant(torch.from_numpy(x), torch.from_numpy(g))
    want = [jref.ref_rmsnorm_quant(jnp.asarray(x), jnp.asarray(g))]
    if m == 16:
        want.append(jops.rmsnorm_quant(jnp.asarray(x), jnp.asarray(g),
                                       interpret=True))
    for wq, ws in want:
        diff = np.abs(tq.numpy().astype(np.int32)
                      - np.asarray(wq).astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-5
        np.testing.assert_allclose(ts.numpy(), np.asarray(ws), rtol=4e-7,
                                   atol=0)
    assert (tq[0, 64:128] == 0).all() and ts[0, 1] == 0


def test_serve_cli_serves_command_r_on_the_cpu(capsys):
    """``serve.py --arch command-r-35b --device cpu``: the reduced config,
    quantized as it is drawn, serves every request at the reference's
    sampling; its parameters are ``quantize(init(seed))`` bit for bit."""
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
