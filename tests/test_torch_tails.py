"""The tails of modules the port had already ported, each against its JAX
counterpart on seeded numpy inputs, on the CPU: the paged pool's helpers
and facade (``serving/paged_cache.py``: ``init_pool``, ``append_token``,
``gather_view``, ``PagedKVCache``), the quantizer entry points and the
integer-arithmetic oracle (``core/quantization.py``: ``quantize_q8_0``,
``quantize_q4_0``, ``qmatmul_ref``, ``quantization_error``, and
``dequantize``'s in-place product), the byte count of a parameter tree
(``core/policy.py``: ``count_bytes``) and the chunk step's prefix path
(``models/transformer.py``: ``prefill_fused_mode``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.core import policy as jpolicy
from repro.core import quantization as jq
from repro.models import build_model as jax_build_model
from repro.serving import paged_cache as jpc
from repro_torch.bridge import params_from_jax
from repro_torch.core import policy as tpolicy
from repro_torch.core import quantization as tq
from repro_torch.models import transformer
from repro_torch.serving import paged_cache as tpc

torch.set_num_threads(2)


def _np(x) -> np.ndarray:
    a = jnp.asarray(x)
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                      else a)


POOLS = {"f32": dict(dtype="float32"), "bf16": dict(dtype="bfloat16"),
         "int8": dict(quantized=True)}


@pytest.mark.parametrize("kind", list(POOLS))
def test_paged_kv_cache_matches_jax(kind, monkeypatch):
    """The same seeded traffic through both facades (2 layers, 2 KV heads
    of 16, blocks of 4, 3 slots): slot 0 admits 6 prompt rows and slot 2
    admits 9, four appends with slot 1 idle (its -1 page-table row writes
    the pool's last block, as the reference's scatter does) and slot 2
    idle for the last two, slot 0 released and re-admitted with 3 rows,
    then one more append.  After every step the pools, lengths and page
    tables, and the views (``gather_view``: K/V and, for the int8 pool,
    the scales) are bitwise the JAX facade's: the same copies and the same
    ``quantize_rows``.  The JAX facade's ``admit`` quantizes eagerly,
    where ``absmax / 127`` is a true division; compiled (its
    ``append_token``, every cache write of its models), XLA folds it into
    a multiply by the f32 reciprocal, which the port's ``quantize_rows``
    takes.  So the JAX facade runs here with its ``quantize_rows``
    compiled."""
    monkeypatch.setattr(jpc, "quantize_rows", jax.jit(jpc.quantize_rows))
    cfg_kw = dict(n_layers=2, n_kv_heads=2, head_dim=16, block_size=4,
                  n_blocks=12, max_slots=3, max_blocks_per_seq=4,
                  **POOLS[kind])
    jc = jpc.PagedKVCache(jpc.PagedConfig(**cfg_kw))
    tc = tpc.PagedKVCache(tpc.PagedConfig(**cfg_kw), device="cpu")
    rng = np.random.default_rng(11)
    dt = jnp.bfloat16 if kind == "bf16" else jnp.float32

    def rows(*shape):
        x = rng.standard_normal(shape).astype(np.float32)
        xj = jnp.asarray(x).astype(dt)
        return xj, torch.from_numpy(np.array(_np(xj))).to(
            torch.bfloat16 if kind == "bf16" else torch.float32)

    def same():
        assert (tc.lens == jc.lens).all()
        assert set(tc.pool) == set(jc.pool)
        for name in jc.pool:
            assert str(tc.pool[name].dtype).split(".")[-1] \
                == str(jc.pool[name].dtype)
            np.testing.assert_array_equal(tc.pool[name].float().numpy(),
                                          _np(jc.pool[name]), err_msg=name)
        for got, want in zip(tc.view(), jc.view()):
            np.testing.assert_array_equal(got.float().numpy(), _np(want))
        assert len(tc.view()) == (4 if kind == "int8" else 2)

    for slot, n in ((0, 6), (2, 9)):
        kj, kt = rows(2, n, 2, 16)
        vj, vt = rows(2, n, 2, 16)
        jc.admit(slot, kj, vj)
        tc.admit(slot, kt, vt)
        same()
    for step in range(4):
        active = np.array([True, False, step < 2])
        kj, kt = rows(2, 3, 2, 16)
        vj, vt = rows(2, 3, 2, 16)
        jc.append(kj, vj, active)
        tc.append(kt, vt, active)
        same()
    assert tc.lens.tolist() == [10, 0, 11]
    jc.release(0)
    tc.release(0)
    same()
    kj, kt = rows(2, 3, 2, 16)
    vj, vt = rows(2, 3, 2, 16)
    jc.admit(0, kj, vj)
    tc.admit(0, kt, vt)
    kj, kt = rows(2, 3, 2, 16)
    vj, vt = rows(2, 3, 2, 16)
    jc.append(kj, vj, np.array([True, False, True]))
    tc.append(kt, vt, np.array([True, False, True]))
    same()
    assert tc.lens.tolist() == [4, 0, 12]
    assert (tc.alloc.page_table() == jc.alloc.page_table()).all()


def test_append_token_and_gather_view_alone_match_jax():
    """``append_token`` on a given pool, page table and lengths writes the
    pool in place, bitwise the new pool the JAX function returns, and
    returns it and ``lens + 1``; ``gather_view`` of it the same views."""
    rng = np.random.default_rng(3)
    cfg = dict(n_layers=2, n_kv_heads=2, head_dim=8, block_size=4,
               n_blocks=6, max_slots=2, max_blocks_per_seq=3)
    tpool = tpc.init_pool(tpc.PagedConfig(**cfg, quantized=True),
                          device="cpu")
    jpool = jpc.init_pool(jpc.PagedConfig(**cfg, quantized=True))
    pt = np.array([[4, 1, -1], [0, 5, 2]], np.int32)
    lens = np.array([5, 9], np.int32)
    k = rng.standard_normal((2, 2, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 2, 2, 8)).astype(np.float32)
    got, glens = tpc.append_token(tpool, torch.from_numpy(pt),
                                  torch.from_numpy(lens),
                                  torch.from_numpy(k), torch.from_numpy(v))
    want, wlens = jpc.append_token(jpool, jnp.asarray(pt), jnp.asarray(lens),
                                   jnp.asarray(k), jnp.asarray(v))
    assert got is tpool
    assert glens.tolist() == np.asarray(wlens).tolist() == [6, 10]
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))
    for g, w in zip(tpc.gather_view(got, torch.from_numpy(pt), glens),
                    jpc.gather_view(want, jnp.asarray(pt), wlens)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_pool_helpers_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    cfg = tpc.PagedConfig(n_layers=1, n_kv_heads=1, head_dim=4)
    for make in (lambda: tpc.init_pool(cfg), lambda: tpc.PagedKVCache(cfg),
                 lambda: transformer.prefill_fused_mode()):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


SHAPES = {"rows": ((8, 256), 64), "bank": ((3, 16, 128), 32),
          "ragged-group": ((4, 96), 48)}


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("bits", [8, 4])
def test_quantizers_match_jax_bitwise(bits, shape):
    """``quantize_q8_0`` / ``quantize_q4_0`` on seeded values (an all-zero
    group, a row at 1e4): codes, scales, group size and packed width
    bitwise the JAX package's; ``quantization_error`` equal to JAX's."""
    dims, gs = SHAPES[shape]
    rng = np.random.default_rng(bits + len(dims))
    x = (rng.standard_normal(dims) * 2.0).astype(np.float32)
    x[(0,) * (len(dims) - 1)][:gs] = 0.0
    x[(-1,) * (len(dims) - 1)] *= 1e4
    tfn = tq.quantize_q8_0 if bits == 8 else tq.quantize_q4_0
    jfn = jq.quantize_q8_0 if bits == 8 else jq.quantize_q4_0
    got, want = tfn(torch.from_numpy(x), gs), jfn(jnp.asarray(x), gs)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert (got.group_size, got.bits, got.orig_dim) == (
        want.group_size, want.bits, want.orig_dim)
    err = tq.quantization_error(torch.from_numpy(x), gs, bits)
    assert float(err) == float(jq.quantization_error(jnp.asarray(x), gs,
                                                     bits))


@pytest.mark.parametrize("bits", [8, 4])
def test_dequantize_in_place_is_bitwise_the_product(bits):
    """``dequantize`` multiplies the f32 codes by their scales in place:
    bitwise the out-of-place ``q.float() * scale`` it replaced, on a
    3-axis expert bank (4 experts x 64 x 256, groups of 64), to f32 and
    bf16."""
    rng = np.random.default_rng(bits)
    x = torch.from_numpy(rng.standard_normal((4, 64, 256)).astype(
        np.float32))
    t = tq.quantize(x, 64, bits)
    q = tq._unpack_nibbles(t.q) if bits == 4 else t.q
    old = (q.reshape(4, 64, 4, 64).float() * t.scale[..., None]).reshape(
        4, 64, 256)
    for dt in (torch.float32, torch.bfloat16):
        got = tq.dequantize(t, dt)
        assert got.dtype == dt and torch.equal(got, old.to(dt))


@pytest.mark.parametrize("bits", [(8, 8), (8, 4), (4, 4)],
                         ids=["q8xq8", "q8xq4", "q4xq4"])
def test_qmatmul_ref_matches_jax(bits):
    """``qmatmul_ref`` (int32 partials within a group, f32 across groups)
    on quantized activations (2 x 3 x 256) and weights (40 x 256) against
    the JAX oracle: within 1e-6 of the output's largest magnitude (only
    the f32 sum across groups may take another order)."""
    rng = np.random.default_rng(sum(bits))
    x = rng.standard_normal((2, 3, 256)).astype(np.float32)
    w = rng.standard_normal((40, 256)).astype(np.float32)
    xb, wb = bits
    got = tq.qmatmul_ref(tq.quantize(torch.from_numpy(x), 64, xb),
                         tq.quantize(torch.from_numpy(w), 64, wb))
    want = np.asarray(jq.qmatmul_ref(jq.quantize(jnp.asarray(x), 64, xb),
                                     jq.quantize(jnp.asarray(w), 64, wb)))
    assert got.dtype == torch.float32 and got.shape == (2, 3, 40)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    with pytest.raises(ValueError, match="group size"):
        tq.qmatmul_ref(tq.quantize(torch.from_numpy(x), 64),
                       tq.quantize(torch.from_numpy(w), 32))


@pytest.mark.parametrize("arch", ["llama2-110m", "llama4-maverick-400b-a17b"])
def test_count_bytes_matches_jax(arch):
    """``count_bytes`` of the reduced config's quantized tree (bridged from
    JAX, fused operands included; the MoE router f32) and of its float
    tree: quantized, float and total bytes equal to the JAX count."""
    jm = jax_build_model(reduced(get_config(arch)))
    jinit = jax.jit(jm.init)(jax.random.PRNGKey(0))
    for tree in (jinit, jm.quantize(jinit)):
        want = jpolicy.count_bytes(tree)
        got = tpolicy.count_bytes(params_from_jax(
            jax.tree_util.tree_map(np.asarray, tree), device="cpu"))
        assert got == want
        assert got["total"] == got["quantized"] + got["float"] > 0


@pytest.mark.parametrize("env", ["", "kernel", "off"])
def test_prefill_fused_mode_names_the_path_of_the_device(env, monkeypatch):
    """On the CPU the chunk step's prefix read is the plain version
    (``"oracle"``), whatever ``REPRO_FUSED_PREFILL`` says, as the JAX
    package's default on the CPU is; a CUDA device names the kernel."""
    from repro.models import transformer as jtransformer
    monkeypatch.setenv("REPRO_FUSED_PREFILL", env)
    assert transformer.prefill_fused_mode("cpu") == "oracle"
    if not env:
        assert jtransformer.prefill_fused_mode() == "oracle"
    if torch.cuda.is_available():
        assert transformer.prefill_fused_mode("cuda") == "kernel"
