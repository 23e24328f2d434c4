"""glm4-9b through the port against the JAX package, on the CPU.

llama3.2-3b's family (dense SwiGLU, bfloat16 compute and KV pool) at 40
layers, d_model 4096, 32 query heads over 2 KV heads of 128 (16 query heads
a KV head: HQ*D = 2048, which the decode attentions serve in two head
groups), d_ff 13696, vocab 151552 and rope theta 1e4.

The decode attentions' plain versions at glm4-9b's head layout (B 2, KVH 2,
HQ 16, D 128) against the JAX plain versions, the Pallas kernels in
interpret mode and the jnp paths the JAX model runs; the group rule of
``ops.decode_head_groups``; then the reduced config (2 layers, d_model 128,
4 query heads over 2 KV heads of 32), and a variant of it that keeps
glm4-9b's head ratio (32 query heads over 2 KV heads of 16), each with the
same weights (JAX ``init`` + ``Model.quantize``, bridged) in the Engine
against the JAX Engine.  Both sides run ``dequant`` and the JAX prefix
attention in interpret mode (``REPRO_FUSED_PREFILL=interpret``).
Tolerances are ``tests/test_torch_llama3.py``'s: attention in f32 within
2e-6 on unit-scale values (``tests/test_torch_kernels.py``); greedy
streams equal up to a near-tie in bfloat16, exactly equal in f32.
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
from repro.models import build_model as jax_build_model
from repro.models import layers as JL
from repro.serving.engine import Engine as JaxEngine
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax
from repro_torch.core.quantization import quantize_rows
from repro_torch.kernels import ops, ref
from repro_torch.models.model import build_model
from repro_torch.serving.engine import Engine

from test_torch_llama3 import ENGINE, U, _top2_gaps, pinned  # noqa: F401

torch.set_num_threads(2)

ARCH = "glm4-9b"
I = dict(interpret=True)
# glm4-9b's decode attention layout: 2 KV heads, 16 query heads each, D 128
B, KVH, HQ, D = 2, 2, 16, 128


def test_config_is_the_reference_config():
    """The port's glm4-9b and its reduced form equal the JAX package's
    field for field; it differs from llama3.2-3b only in fields the
    reference's own file sets."""
    full = tconfigs.get_config(ARCH)
    assert asdict(full) == asdict(get_config(ARCH))
    assert asdict(tconfigs.reduced(full)) == asdict(reduced(get_config(ARCH)))
    l3 = tconfigs.get_config("llama3.2-3b")
    differ = {k for k, v in asdict(full).items() if asdict(l3)[k] != v}
    assert differ == {"arch_id", "n_layers", "d_model", "n_heads",
                      "n_kv_heads", "d_ff", "vocab_size", "rope_theta"}
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.hd(), full.d_ff, full.vocab_size, full.padded_vocab(),
            full.compute_dtype, full.kv_cache_dtype) == (
        40, 4096, 32, 2, 128, 13696, 151552, 151552, "bfloat16", "bfloat16")


def test_decode_head_groups():
    """One group up to HQ*D = 1024, the launch of every shape served
    before glm4-9b; two at glm4-9b's 16 heads of 128; refused where no
    group serves."""
    served = {"llama2-110m": (1, 64), "llama3.2-3b": (3, 128),
              "phi4-mini-3.8b": (3, 128)}
    for hq, d in served.values():
        assert ops.decode_head_groups(hq, d) == 1
    for hq, d in ((1, 512), (2, 512), (8, 128), (4, 256), (32, 32),
                  (2, 36), (8, 40)):
        assert hq * d <= ops.DECODE_MAX_HQ_D
        assert ops.decode_head_groups(hq, d) == 1
    full = tconfigs.get_config(ARCH)
    hq = full.n_heads // full.n_kv_heads
    assert ops.decode_head_groups(hq, full.hd()) == 2
    # the fewest groups of equal heads that each fit: 12 x 128 -> 2, 6 x
    # 256 -> 2, 5 x 256 -> 5 (2 and 3 do not divide 5), 64 x 128 -> 8
    for (hq, d), g in {(12, 128): 2, (6, 256): 2, (5, 256): 5,
                       (64, 128): 8, (3, 1024): 3}.items():
        got = ops.decode_head_groups(hq, d)
        assert got == g and hq % got == 0
        assert hq // got * d <= ops.DECODE_MAX_HQ_D
    for hq, d in ((1, 1028), (2, 6), (16, 130), (0, 128)):
        with pytest.raises(ValueError, match="decode attention"):
            ops.decode_head_groups(hq, d)


def _caches(rng, nrows, int8):
    """K/V rows (nrows, KVH, D): bf16, or int8 codes with f32 scales (the
    pool's quantizer).  Returns torch tensors and their JAX twins."""
    k = torch.from_numpy(rng.normal(size=(nrows, KVH, D)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(nrows, KVH, D)).astype(np.float32))
    if int8:
        (k, ks), (v, vs) = quantize_rows(k), quantize_rows(v)
        out = (k, v, ks, vs)
        return out, tuple(jnp.asarray(t.numpy()) for t in out)
    k, v = k.bfloat16(), v.bfloat16()
    return (k, v, None, None), (
        jnp.asarray(k.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(v.float().numpy()).astype(jnp.bfloat16), None, None)


def _q(rng):
    return (rng.normal(size=(B, KVH * HQ, D)) / np.sqrt(D)).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=2e-6,
                               rtol=0)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_plain_paged_decode_attention_at_hq16_matches_jax(int8):
    """The port's paged decode attention on the CPU (its plain version)
    at B 2, KVH 2, HQ 16, D 128 on a bf16 and an int8 pool, a -1 entry
    inside a row's length: against the JAX plain version in the kernel's
    layout, the Pallas kernel in interpret mode and the jnp
    ``layers.paged_attention_decode`` the JAX model runs, all in f32:
    within 2e-6."""
    rng = np.random.default_rng(27)
    nb, bs, mb = 12, 16, 5
    (k, v, ks, vs), (jk, jv, jks, jvs) = _caches(rng, nb * bs, int8)
    k, v = (t.reshape(nb, bs, KVH, D) for t in (k, v))
    jk, jv = (t.reshape(nb, bs, KVH, D) for t in (jk, jv))
    if int8:
        ks, vs = (t.reshape(nb, bs, KVH) for t in (ks, vs))
        jks, jvs = (t.reshape(nb, bs, KVH) for t in (jks, jvs))
    pt = rng.permutation(nb)[:B * mb].reshape(B, mb).astype(np.int32)
    pt[1, 1] = -1                                # inside row 1's length
    lens = np.array([77, 40], np.int32)
    q = _q(rng)
    got = ops.paged_decode_attention(torch.from_numpy(q), k, v,
                                     torch.from_numpy(pt),
                                     torch.from_numpy(lens), ks, vs)
    want = jops.paged_decode_attention(jnp.asarray(q), jk, jv,
                                       jnp.asarray(pt), jnp.asarray(lens),
                                       jks, jvs, **I)
    _close(got.numpy(), want)
    jnp_path = JL.paged_attention_decode(
        jnp.asarray(q), jk, jv, jnp.asarray(pt), jnp.asarray(lens),
        JL.AttnConfig(KVH * HQ, KVH, D), jks, jvs)
    _close(got.numpy(), jnp_path)
    q4 = q.reshape(B, KVH, HQ, D)
    got4 = ref.ref_paged_decode_attention(torch.from_numpy(q4), k, v,
                                          torch.from_numpy(pt),
                                          torch.from_numpy(lens), ks, vs)
    want4 = jref.ref_paged_decode_attention(jnp.asarray(q4), jk, jv,
                                            jnp.asarray(pt),
                                            jnp.asarray(lens), jks, jvs)
    _close(got4.numpy(), want4)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_plain_decode_attention_at_hq16_matches_jax(int8):
    """The port's dense decode attention on the CPU at B 2, KVH 2, HQ 16,
    D 128 on a bf16 and an int8 cache, one row of length 0: against the
    JAX plain version, the Pallas kernel in interpret mode and the jnp
    ``layers.attention_decode``: within 2e-6, the length-0 row 0."""
    rng = np.random.default_rng(28)
    s = 48
    (k, v, ks, vs), (jk, jv, jks, jvs) = _caches(rng, B * s, int8)
    k, v = (t.reshape(B, s, KVH, D) for t in (k, v))
    jk, jv = (t.reshape(B, s, KVH, D) for t in (jk, jv))
    if int8:
        ks, vs = (t.reshape(B, s, KVH) for t in (ks, vs))
        jks, jvs = (t.reshape(B, s, KVH) for t in (jks, jvs))
    lens = np.array([37, 0], np.int32)
    q = _q(rng)
    got = ops.decode_attention(torch.from_numpy(q), k, v,
                               torch.from_numpy(lens), ks, vs)
    want = jops.decode_attention(jnp.asarray(q), jk, jv, jnp.asarray(lens),
                                 jks, jvs, block_s=16, **I)
    _close(got.numpy(), want)
    assert not got[1].any()
    jnp_path = JL.attention_decode(jnp.asarray(q), jk, jv,
                                   jnp.asarray(lens),
                                   JL.AttnConfig(KVH * HQ, KVH, D), jks, jvs)
    _close(got.numpy(), jnp_path)
    q4 = q.reshape(B, KVH, HQ, D)
    got4 = ref.ref_decode_attention(torch.from_numpy(q4), k, v,
                                    torch.from_numpy(lens.reshape(B, 1)),
                                    ks, vs)
    want4 = jref.ref_decode_attention(jnp.asarray(q4), jk, jv,
                                      jnp.asarray(lens.reshape(B, 1)), jks,
                                      jvs)
    _close(got4.numpy(), want4)


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


# glm4-9b's head ratio at a narrow head: 32 query heads over 2 KV heads
HEADS = dict(n_heads=32, n_kv_heads=2, head_dim=16)
F32 = dict(compute_dtype="float32", kv_cache_dtype="float32")


@pytest.mark.parametrize("over", [dict(), F32, HEADS, {**HEADS, **F32}],
                         ids=["bf16", "f32", "heads-32-2-bf16",
                              "heads-32-2-f32"])
def test_engine_matches_jax_engine(over, pinned):
    """The paged Engine on chunked traffic (prompts past the 16-token
    chunk, three queued behind two slots), at the reduced config and at a
    variant with glm4-9b's 16 query heads a KV head: equal plan logs;
    greedy streams equal up to a near-tie in bf16 (a top-2 gap below twice
    the logits' bound ``2 * n_layers * u * max |logit|``), exactly equal
    with f32 compute."""
    tag = "-".join(str(v) for v in over.values()) or "bf16"
    jm, jparams, tm, tparams = _models(f"engine-{tag}", **over)
    assert (tm.cfg.n_heads, tm.cfg.n_kv_heads) == (
        (32, 2) if "n_heads" in over else (4, 2))
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
        if f32:
            assert g == w
            continue
        part = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b),
                    None)
        if part is not None:
            gap, scale = _top2_gaps(tm, tparams, prompt, w)[part]
            assert gap < 2 * 2 * tm.cfg.n_layers * U * scale, (part, gap)
