"""The port's kernel wrappers on the CPU against the JAX package's kernels.

On CPU tensors each wrapper in ``repro_torch.kernels.ops`` runs its
kernel's plain version; these tests hold that against the JAX Pallas kernel
run as the JAX tests run it (interpret mode) and against the JAX plain
versions (``repro/kernels/ref.py``), on the same numpy inputs.  The CUDA
kernels themselves are held against the same plain versions on the card
by ``chip_smoke.py``.

Tolerances: the Q8 products are exact per group, so the only difference is
the f32 order of the sum over groups (rtol = atol = 1e-5 on outputs of
magnitude ~10); attention sums the same f32 terms in another order and
with another softmax normalisation point (atol 2e-6 on unit-scale values).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quantization import quantize as jquantize
from repro.core.quantization import quantize_rows as jquantize_rows
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core.quantization import QuantizedTensor, quantize
from repro_torch.kernels import build, ops, ref

torch.set_num_threads(2)
I = dict(interpret=True)


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors never reach a CUDA kernel: every counter stays 0."""
    build.reset_launches()
    yield
    assert all(v == 0 for v in build.LAUNCHES.values()), build.LAUNCHES


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("m", [1, 8, 32, 33, 80])
@pytest.mark.parametrize("group", [32, 64])
def test_q8_matmul_matches_pallas(m, group):
    rng = np.random.default_rng(m * 100 + group)
    n, k = 96, 256
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((n, k)) / 16).astype(np.float32)
    jw = jquantize(jnp.asarray(w), group_size=group)
    want = np.asarray(jops.q8_matmul(jnp.asarray(x), jw, **I))
    tw = QuantizedTensor(q=_t(jw.q), scale=_t(jw.scale), group_size=group,
                         orig_dim=k)
    got = ops.q8_matmul(_t(x), tw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("group", [32, 64])
def test_ref_q8_matmul_matches_jax_ref(group):
    rng = np.random.default_rng(group)
    x = rng.standard_normal((40, 192)).astype(np.float32)
    w = rng.standard_normal((64, 192)).astype(np.float32)
    xq, wq = jquantize(jnp.asarray(x), group), jquantize(jnp.asarray(w), group)
    want = np.asarray(jref.ref_q8_matmul(xq.q, xq.scale, wq.q, wq.scale,
                                         group))
    for fn in (ops.q8_matvec_kernel, ops.q8_matmul_kernel,
               ref.ref_q8_matmul):
        got = fn(_t(xq.q), _t(xq.scale), _t(wq.q), _t(wq.scale),
                 group).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _pool(rng, nb, bs, kvh, d, int8):
    k = rng.standard_normal((nb, bs, kvh, d)).astype(np.float32)
    v = rng.standard_normal((nb, bs, kvh, d)).astype(np.float32)
    if not int8:
        return k, v, None, None
    kq, ks = jax.jit(jquantize_rows)(jnp.asarray(k))
    vq, vs = jax.jit(jquantize_rows)(jnp.asarray(v))
    return (np.asarray(kq), np.asarray(vq), np.asarray(ks), np.asarray(vs))


def _opt(a):
    return None if a is None else _t(a)


def _jopt(a):
    return None if a is None else jnp.asarray(a)


# page tables with -1 entries past each row's live pages, lens 0 included
_PT = np.array([[3, 7, -1, -1],
                [-1, -1, -1, -1],
                [0, 5, 2, 6],
                [4, -1, -1, -1]], np.int32)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("hq", [1, 2])
def test_paged_decode_attention_matches_pallas(int8, hq):
    rng = np.random.default_rng(7 + hq)
    nb, bs, kvh, d = 8, 16, 2, 32
    k, v, ks, vs = _pool(rng, nb, bs, kvh, d, int8)
    lens = np.array([17, 0, 64, 16], np.int32)
    q = (rng.standard_normal((4, kvh * hq, d)) / np.sqrt(d)).astype(
        np.float32)
    want = np.asarray(jops.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(_PT),
        jnp.asarray(lens), _jopt(ks), _jopt(vs), **I))
    got = ops.paged_decode_attention(_t(q), _t(k), _t(v), _t(_PT),
                                     _t(lens), _opt(ks), _opt(vs)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)
    assert not got[1].any()                    # len 0 -> exactly 0
    # the plain version against the JAX plain version, in kernel layout
    q4 = q.reshape(4, kvh, hq, d)
    want4 = np.asarray(jref.ref_paged_decode_attention(
        jnp.asarray(q4), jnp.asarray(k), jnp.asarray(v), jnp.asarray(_PT),
        jnp.asarray(lens), _jopt(ks), _jopt(vs)))
    got4 = ref.ref_paged_decode_attention(_t(q4), _t(k), _t(v), _t(_PT),
                                          _t(lens), _opt(ks), _opt(vs))
    np.testing.assert_allclose(got4.numpy(), want4, atol=2e-6, rtol=0)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("hq", [1, 2])
def test_paged_prefill_attention_matches_pallas(int8, hq):
    rng = np.random.default_rng(11 + hq)
    nb, bs, kvh, d, c = 8, 16, 2, 32, 24
    k, v, ks, vs = _pool(rng, nb, bs, kvh, d, int8)
    pfx = np.array([20, 0, 64, 5], np.int32)      # row 1: empty prefix
    qlens = np.array([24, 24, 7, 0], np.int32)    # padded q rows
    q = (rng.standard_normal((4, c, kvh * hq, d)) / np.sqrt(d)).astype(
        np.float32)
    want = [np.asarray(a) for a in jops.paged_prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(_PT),
        jnp.asarray(pfx), jnp.asarray(qlens), _jopt(ks), _jopt(vs),
        block_q=8, **I)]
    got = [a.numpy() for a in ops.paged_prefill_attention(
        _t(q), _t(k), _t(v), _t(_PT), _t(pfx), _t(qlens), _opt(ks),
        _opt(vs))]
    for g, w in zip(got, want):
        assert g.shape == w.shape
    # rows at or past q_lens are skipped by both kernels (their state is
    # unspecified); compare the live rows only
    for b in range(4):
        n = qlens[b]
        np.testing.assert_allclose(got[0][b, :n], want[0][b, :n], atol=2e-6,
                                   rtol=0)
        np.testing.assert_allclose(got[1][b, :, :n], want[1][b, :, :n],
                                   atol=2e-6, rtol=0)
        np.testing.assert_allclose(got[2][b, :, :n], want[2][b, :, :n],
                                   rtol=2e-6, atol=2e-6)
    # an empty prefix is exactly (0, -1e30, 0) in both
    assert not got[0][1].any() and not got[2][1].any()
    assert (got[1][1] == np.float32(-1e30)).all()
    assert (want[1][1] == np.float32(-1e30)).all()


@pytest.mark.parametrize("int8", [False, True])
def test_ref_paged_prefill_matches_jax_ref(int8):
    rng = np.random.default_rng(5)
    k, v, ks, vs = _pool(rng, 8, 16, 2, 32, int8)
    pfx = np.array([20, 0, 64, 5], np.int32)
    q = rng.standard_normal((4, 12, 4, 32)).astype(np.float32) / 6
    want = jref.ref_paged_prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(_PT),
        jnp.asarray(pfx), _jopt(ks), _jopt(vs))
    got = ref.ref_paged_prefill_attention(_t(q), _t(k), _t(v), _t(_PT),
                                          _t(pfx), _opt(ks), _opt(vs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-6,
                                   rtol=2e-6)


def test_non_cpu_tensors_never_take_the_plain_version():
    """A tensor off the CPU goes to the CUDA kernel or raises: here (no
    nvcc, no card) meta tensors must raise, never run the plain version."""
    xq = torch.zeros((2, 64), dtype=torch.int8, device="meta")
    xs = torch.zeros((2, 1), device="meta")
    wq = torch.zeros((8, 64), dtype=torch.int8, device="meta")
    ws = torch.zeros((8, 1), device="meta")
    for fn in (ops.q8_matvec_kernel, ops.q8_matmul_kernel):
        with pytest.raises((RuntimeError, ValueError, NotImplementedError)):
            fn(xq, xs, wq, ws, 64)


def test_wrappers_reject_bad_operands():
    """Shape / dtype checks run before any launch."""
    xq = torch.zeros((2, 64), dtype=torch.int8, device="meta")
    xs = torch.zeros((2, 2), device="meta")          # wrong group count
    wq = torch.zeros((8, 64), dtype=torch.int8, device="meta")
    ws = torch.zeros((8, 1), device="meta")
    with pytest.raises(ValueError):
        ops.q8_matvec_kernel(xq, xs, wq, ws, 64)
    with pytest.raises(ValueError):
        ops.q8_matmul_kernel(xq, xs.float(), wq.float(), ws, 64)
