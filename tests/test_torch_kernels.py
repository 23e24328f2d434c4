"""The port's kernel wrappers on the CPU against the JAX package's kernels.

On CPU tensors each wrapper in ``repro_torch.kernels.ops`` runs its
kernel's plain version; these tests hold that against the JAX Pallas kernel
run as the JAX tests run it (interpret mode) and against the JAX plain
versions (``repro/kernels/ref.py``), on the same numpy inputs.  The CUDA
kernels themselves are held against the same plain versions on the card
by ``chip_smoke.py``.

Tolerances: the Q8 and Q4 products are exact per group, so the only
difference is the f32 order of the sum over groups (rtol = atol = 1e-5 on
outputs of magnitude ~10); attention sums the same f32 terms in another
order and with another softmax normalisation point (atol 2e-6 on unit-scale
values); rope may fuse its multiply-add in XLA (1e-6, the last place).
The fused RMSNorm + Q8_0 gives the JAX kernel's codes bitwise at the JAX
tests' shapes; its scales differ in the last places (rtol 4e-7, three ulps),
because the two norms sum ``mean(x^2)`` in different orders.
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
from repro_torch.core import qlinear
from repro_torch.core.quantization import (QuantizedTensor, _unpack_nibbles,
                                          quantize)
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


@pytest.mark.parametrize("m", [1, 8, 32, 33, 80, 600])
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


def _q4_unpack_emulation(wq):
    """csrc/q4_matvec.cu's unpack8 on the packed weights (N, K/2), in numpy:
    each nibble n becomes the byte (n ^ 8) - 8 mod 256 (__vsub4), and the
    low nibbles (even codes) and high nibbles (odd codes) interleave, as
    its byte permutes do.  Returns the int8 codes (N, K) in code order."""
    b = np.ascontiguousarray(wq).view(np.uint8).astype(np.int32)
    lo, hi = [(((b >> s & 0xF) ^ 8) - 8) & 0xFF for s in (0, 4)]
    out = np.stack([lo, hi], axis=-1).astype(np.uint8)
    return out.reshape(wq.shape[0], -1).view(np.int8)


def _q8_mma_emulation(xq, xs, w, ws, group, bits=8):
    """The arithmetic of csrc/q8_matmul.cu's tensor-core kernel, and of
    csrc/q4_matvec.cu's (bits=4, its M > 32 path), in numpy: Q4_0 weights
    first unpack to int8 codes as the kernel unpacks each staged chunk;
    128-code stages; inside a stage, k-steps of 32 codes (mma m16n8k32), or
    two of 16 (m16n8k16) where a group ends 16 codes into the pair; each
    group's int32 sum restarts at its first step and, after its last, folds
    into the f32 output in group order as acc + (f32(part) * xs) * ws, each
    product and sum rounded to f32 alone.  xq (M, K) and w (N, K) are int
    codes, or w (N, K/2) packed nibbles for bits=4."""
    if bits == 4:
        w = _q4_unpack_emulation(w)
    m, k = xq.shape
    x64, w64 = xq.astype(np.int64), w.astype(np.int64)
    acc = np.zeros((m, w.shape[0]), np.float32)
    part = np.zeros(acc.shape, np.int64)
    g, kg, steps = 0, 0, set()

    def step(k0, width):
        nonlocal part, g, kg
        part = part + x64[:, k0:k0 + width] @ w64[:, k0:k0 + width].T
        steps.add(width)
        kg += width
        if kg == group:
            assert np.abs(part).max() < 2 ** 24
            term = ((part.astype(np.float32)
                     * xs[:, g, None].astype(np.float32))
                    * ws[None, :, g].astype(np.float32))
            acc[...] = acc + term
            part[...] = 0
            g, kg = g + 1, 0

    for k0 in range(0, k, 128):
        for kk in range(k0, min(k0 + 128, k), 32):
            if group - kg != 16:
                step(kk, 32)
            else:
                step(kk, 16)
                if kk + 16 < k:
                    step(kk + 16, 16)
    assert g == k // group
    return acc, steps


# Q8_0 cases keep their original ids; Q4_0 cases run the M > 32 path's
# arithmetic on a ragged N (not a multiple of any tile)
_MMA_CASES = [pytest.param(8, g, id=str(g)) for g in (16, 32, 48, 64, 512)]
_MMA_CASES += [pytest.param(4, g, id=f"q4-g{g}")
               for g in (16, 32, 64, 128, 512)]


@pytest.mark.parametrize("bits,group", _MMA_CASES)
def test_q8_matmul_kernel_arithmetic_is_the_plain_version(bits, group):
    """The chip check holds the GEMMs (M > 32) of q8_matmul and q4_matvec
    bitwise to their plain versions.  Their arithmetic, emulated here --
    the Q4_0 unpack, per-group int32 sums in k-steps of 32 and 16, the fold
    in group order with separately rounded products and sums -- is bitwise
    ref.ref_q8_matmul (ref.ref_q4_matvec) on the CPU, and within the usual
    1e-5 of the JAX plain version."""
    rng = np.random.default_rng(700 + group + 1000 * (bits == 4))
    m, n, k = 96, (160 if bits == 8 else 100), 1536
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((n, k)) / np.sqrt(k)).astype(np.float32)
    xt = jquantize(jnp.asarray(x), group_size=group)
    wt = jquantize(jnp.asarray(w), group_size=group, bits=bits)
    xq, xs = np.asarray(xt.q), np.asarray(xt.scale)
    wq, ws = np.asarray(wt.q), np.asarray(wt.scale)
    got, steps = _q8_mma_emulation(xq, xs, wq, ws, group, bits)
    assert steps == ({32} if group % 32 == 0 else {16, 32} if group > 16
                     else {16})
    plain_fn = ref.ref_q8_matmul if bits == 8 else ref.ref_q4_matvec
    plain = plain_fn(_t(xq), _t(xs), _t(wq), _t(ws), group).numpy()
    assert np.array_equal(got, plain)
    jref_fn = jref.ref_q8_matmul if bits == 8 else jref.ref_q4_matvec
    want = np.asarray(jref_fn(xt.q, xt.scale, wt.q, wt.scale, group))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("byte_at", [0, 1, 2, 3])
def test_q4_unpack8_sign_extends_every_nibble(byte_at):
    """The Q4 GEMM's unpack (emulated bit for bit) gives the reference's
    sign-extended codes for every value of a packed byte, in each of a
    word's four byte positions, with random neighbours."""
    rng = np.random.default_rng(byte_at)
    wq = rng.integers(-128, 128, (256, 8), dtype=np.int8)
    wq[:, byte_at] = np.arange(-128, 128, dtype=np.int8)
    want = np.asarray(jref.ref_q4_matvec(
        jnp.eye(16, dtype=jnp.int8), jnp.ones((16, 1)), jnp.asarray(wq),
        jnp.ones((256, 1)), 16)).T
    got = _q4_unpack_emulation(wq)
    np.testing.assert_array_equal(got, want.astype(np.int8))
    np.testing.assert_array_equal(got, _unpack_nibbles(_t(wq)).numpy())


def test_q8_matmul_group_sums_are_exact_in_f32():
    """A group's int32 sum is at most 512 * 127 * 127 in magnitude (2**23
    even with -128 codes), below 2**24, so its conversion to f32 is
    exact."""
    assert 512 * 127 * 127 < 512 * 128 * 128 == 2 ** 23 < 2 ** 24
    p = np.arange(-2 ** 23, 2 ** 23 + 1, dtype=np.int64)
    assert np.array_equal(p.astype(np.float32).astype(np.int64), p)


@pytest.mark.parametrize("m,k", [(4, 256), (16, 512), (256, 1024), (3, 192)])
def test_rmsnorm_quant_matches_pallas(m, k):
    """The plain version (the port's rms_norm then quantize) against the
    JAX Pallas kernel in interpret mode and the JAX plain version, on the
    inputs of tests/test_kernels.py::test_rmsnorm_quant."""
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(m + k), (m, k)) * 3.0)
    g = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (k,)))
    tq, ts = ops.rmsnorm_quant(_t(x), _t(g))
    assert tq.dtype == torch.int8 and ts.shape == (m, k // 64)
    for wq, ws in (jops.rmsnorm_quant(jnp.asarray(x), jnp.asarray(g), **I),
                   jref.ref_rmsnorm_quant(jnp.asarray(x), jnp.asarray(g))):
        np.testing.assert_array_equal(tq.numpy(), np.asarray(wq))
        np.testing.assert_allclose(ts.numpy(), np.asarray(ws), rtol=4e-7,
                                   atol=0)


@pytest.mark.parametrize("bits", [8, 4])
def test_norm_qdot_fused_path_is_the_unfused_pair(bits):
    """On CPU tensors the kernel strategy's fused norm-and-quantize path
    gives the unfused pair's result bit for bit (the CPU path is
    unchanged); one all-zero row exercises the zero group."""
    rng = np.random.default_rng(bits)
    x = rng.standard_normal((5, 3, 128)).astype(np.float32)
    x[1, 2] = 0.0
    g = rng.standard_normal(128).astype(np.float32)
    w = quantize(_t(rng.standard_normal((96, 128)).astype(np.float32)),
                 64, bits=bits)
    old = qlinear.default_strategy()
    qlinear.set_default_strategy("kernel")
    try:
        fused = qlinear.norm_qdot(_t(x), _t(g), 1e-5, w)
        pair = qlinear.qdot(ref.rms_norm(_t(x), _t(g), 1e-5), w)
    finally:
        qlinear.set_default_strategy(old)
    assert fused.shape == (5, 3, 96)
    np.testing.assert_array_equal(fused.numpy(), pair.numpy())
    xq, xs = ref.ref_rmsnorm_quant(_t(x[1]), _t(g))
    assert (xq[2] == 0).all() and (xs[2] == 0).all()


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


# (M, group, K): the GEMV (M <= 32) and the tiled path, at every group
# size the GEMV folds differently (16: two groups a 32-code chunk; 32: one
# lane; 64 and 128: two and four neighbouring lanes), K one slab or many
# groups; the group-64, K-256 cases keep their original ids
_Q4_CASES = [pytest.param(m, 64, 256, id=str(m)) for m in (1, 8, 33, 80)]
_Q4_CASES += [pytest.param(m, g, k, id=f"{m}-g{g}-k{k}")
              for m in (1, 8, 33, 80) for g in (16, 32, 64, 128)
              for k in (256, 2048) if (g, k) != (64, 256)]


@pytest.mark.parametrize("m,group,k", _Q4_CASES)
def test_q4_matvec_matches_pallas(m, group, k):
    """Q4_0 weights go to q4_matvec for every row count, as in the JAX
    dispatch; both against the JAX kernel (interpret) and plain version."""
    rng = np.random.default_rng(40 + m + group + k)
    n = 96
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((n, k)) / 16).astype(np.float32)
    jw = jquantize(jnp.asarray(w), group_size=group, bits=4)
    want = np.asarray(jops.q8_matmul(jnp.asarray(x), jw, **I))
    tw = QuantizedTensor(q=_t(jw.q), scale=_t(jw.scale), group_size=group,
                         bits=4, orig_dim=k)
    got = ops.q8_matmul(_t(x), tw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    xq = jquantize(jnp.asarray(x), group_size=group)
    want = np.asarray(jref.ref_q4_matvec(xq.q, xq.scale, jw.q, jw.scale,
                                         group))
    for fn in (ops.q4_matvec_kernel, ref.ref_q4_matvec):
        got = fn(_t(xq.q), _t(xq.scale), _t(jw.q), _t(jw.scale),
                 group).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m", [1, 8, 32])
@pytest.mark.parametrize("group", [16, 128])
def test_q8_matvec_matches_pallas(m, group):
    """Q8_0 weights at M <= 32 go to q8_matvec, as the JAX dispatch sends
    them to q8_matvec_pallas; both against the JAX kernel (interpret) and
    the JAX plain version, K = 2048 past one of the kernel's slabs."""
    rng = np.random.default_rng(60 + m + group)
    n, k = 96, 2048
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((n, k)) / 16).astype(np.float32)
    jw = jquantize(jnp.asarray(w), group_size=group)
    want = np.asarray(jops.q8_matmul(jnp.asarray(x), jw, **I))
    tw = QuantizedTensor(q=_t(jw.q), scale=_t(jw.scale), group_size=group,
                         orig_dim=k)
    got = ops.q8_matmul(_t(x), tw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    xq = jquantize(jnp.asarray(x), group_size=group)
    want = np.asarray(jref.ref_q8_matmul(xq.q, xq.scale, jw.q, jw.scale,
                                         group))
    got = ops.q8_matvec_kernel(_t(xq.q), _t(xq.scale), _t(jw.q),
                               _t(jw.scale), group).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _gemv_fold_order(xq, xs, w, ws, group):
    """The f32 order of the GEMVs (M <= 32) of csrc/q4_matvec.cu and
    csrc/q8_matvec.cu, in numpy: lane l takes 32-code chunks c = l, l + 32,
    l + 64, ... in order (whatever the slab of codes each stages); a group's
    first lane folds its exact int32 sum as acc + (part * xs) * ws, each
    product and sum rounded to f32 (group 16: both groups of the chunk, in
    order); then a butterfly over lane offsets 16, 8, 4, 2, 1 sums the 32
    lanes.  xq (M, K) and w (N, K) are int codes."""
    m, k = xq.shape
    g = k // group
    part = np.einsum("mgk,ngk->mng", xq.reshape(m, g, group).astype(np.int64),
                     w.reshape(-1, g, group).astype(np.int64))
    term = ((part.astype(np.float32) * xs[:, None, :].astype(np.float32))
            * ws[None, :, :].astype(np.float32))        # (M, N, G) f32
    acc = np.zeros((32,) + term.shape[:2], np.float32)
    for base in range(0, (k + 31) // 32, 32):           # chunks base + lane
        for lane in range(32):
            c = base + lane
            if 32 * c >= k or (group > 32 and lane % (group // 32)):
                continue
            for gi in range(32 * c // group,
                            min(32 * c + 32, k) // group if group < 32
                            else 32 * c // group + 1):
                acc[lane] = acc[lane] + term[:, :, gi]
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[np.arange(32) ^ off]
    return acc[0]


# the Q4 cases keep their original ids
_FOLD_CASES = [pytest.param(4, n, k, id=f"{n}-{k}")
               for n, k in [(768, 768), (768, 2048)]]
_FOLD_CASES += [pytest.param(8, n, k, id=f"q8-{n}-{k}")
                for n, k in [(768, 768), (768, 2048)]]


@pytest.mark.parametrize("bits,n,k", _FOLD_CASES)
def test_gemv_fold_order_meets_the_kernel_tolerance(bits, n, k):
    """The chip checks hold the Q4 and Q8 GEMVs within 2e-5 * max(1,
    |want|max) of their plain versions.  The GEMVs' own f32 order (per-lane
    group folds, then the lane butterfly), emulated here at the decode
    path's shapes with 8 slots, stays within that of the JAX reference, and
    is not simply the plain version's order."""
    rng = np.random.default_rng(k)
    x = rng.standard_normal((8, k)).astype(np.float32)
    w = (rng.standard_normal((n, k)) / np.sqrt(k)).astype(np.float32)
    xt = jquantize(jnp.asarray(x), group_size=64)
    wt = jquantize(jnp.asarray(w), group_size=64, bits=bits)
    if bits == 4:
        want = np.asarray(jref.ref_q4_matvec(xt.q, xt.scale, wt.q, wt.scale,
                                             64))
        packed = np.asarray(wt.q).astype(np.int8)
        wcodes = np.stack([(packed << 4).astype(np.int8) >> 4, packed >> 4],
                          -1).reshape(n, k)
    else:
        want = np.asarray(jref.ref_q8_matmul(xt.q, xt.scale, wt.q, wt.scale,
                                             64))
        wcodes = np.asarray(wt.q)
    got = _gemv_fold_order(np.asarray(xt.q), np.asarray(xt.scale), wcodes,
                           np.asarray(wt.scale), 64)
    err = float(np.abs(got - want).max())
    assert err <= 2e-5 * max(1.0, float(np.abs(want).max())), err
    assert not np.array_equal(got, want)


def _cache(rng, b, s, kvh, d, int8):
    """A dense (B, S, KVH, D) K/V cache, int8 with per-row scales."""
    k, v, ks, vs = _pool(rng, b, s, kvh, d, int8)
    return k, v, ks, vs


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("hq", [1, 2])
def test_decode_attention_matches_pallas(int8, hq):
    rng = np.random.default_rng(21 + hq)
    b, s, kvh, d = 4, 48, 2, 32
    k, v, ks, vs = _cache(rng, b, s, kvh, d, int8)
    lens = np.array([17, 0, 48, 5], np.int32)      # row 1: length 0
    q = (rng.standard_normal((b, kvh * hq, d)) / np.sqrt(d)).astype(
        np.float32)
    want = np.asarray(jops.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        _jopt(ks), _jopt(vs), block_s=16, **I))
    got = ops.decode_attention(_t(q), _t(k), _t(v), _t(lens), _opt(ks),
                               _opt(vs)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)
    assert not got[1].any()                    # len 0 -> exactly 0
    q4 = q.reshape(b, kvh, hq, d)
    want4 = np.asarray(jref.ref_decode_attention(
        jnp.asarray(q4), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(lens.reshape(b, 1)), _jopt(ks), _jopt(vs)))
    got4 = ref.ref_decode_attention(_t(q4), _t(k), _t(v),
                                    _t(lens.reshape(b, 1)), _opt(ks),
                                    _opt(vs))
    np.testing.assert_allclose(got4.numpy(), want4, atol=2e-6, rtol=0)


# (seed, b, sq, sk, kvh, hq, d, q_offset, q_lens, k_lens, block): the chunked
# form with GQA at narrow width (Pallas tiles of 8), then the widths the
# CUDA kernel's fragment tiling must handle: full-width heads (H = 12,
# D = 64), ragged lengths that are no multiple of 8 or 16, GQA, and a row
# with q_lens 0
_FLASH_CASES = {
    "1": (32, 3, 24, 40, 2, 1, 32, [16, 0, 9], [24, 13, 0], [40, 13, 30], 8),
    "2": (33, 3, 24, 40, 2, 2, 32, [16, 0, 9], [24, 13, 0], [40, 13, 30], 8),
    "h12-d64-s17": (42, 1, 17, 17, 12, 1, 64, None, None, None, 128),
    "h12-d64-s70-gqa": (43, 3, 70, 86, 4, 3, 64, [16, 0, 3], [70, 0, 41],
                        [86, 50, 44], 128),
}


@pytest.mark.parametrize("case", list(_FLASH_CASES))
def test_flash_prefill_matches_pallas(case):
    """Per-row q_offset / q_lens / k_lens (chunked form, Sk >= Sq) with
    GQA; rows past q_lens are 0 in the port and unspecified in the JAX
    kernel, so only the live rows are compared.  Then the one-shot form
    (no extents) against the JAX plain version."""
    seed, b, sq, sk, kvh, hq, d, off, qlens, klens, blk = _FLASH_CASES[case]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, kvh * hq, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, kvh, d)).astype(np.float32)
    ext = [None if x is None else np.array(x, np.int32)
           for x in (off, qlens, klens)]
    off, qlens, klens = ext
    want = np.asarray(jops.flash_prefill(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        q_offset=0 if off is None else jnp.asarray(off),
        q_lens=None if qlens is None else jnp.asarray(qlens),
        k_lens=None if klens is None else jnp.asarray(klens),
        block_q=blk, block_k=blk, **I))
    off_t, ql_t, kl_t = (None if x is None else _t(x) for x in ext)
    got = ops.flash_prefill(_t(q), _t(k), _t(v), q_offset=off_t,
                            q_lens=ql_t, k_lens=kl_t).numpy()
    for i in range(b):
        n = sq if qlens is None else qlens[i]
        np.testing.assert_allclose(got[i, :n], want[i, :n], atol=2e-6,
                                   rtol=0)
        assert not got[i, n:].any()
    # the one-shot form (Sq = Sk) against the JAX plain version
    n = sq if off is None else 16
    qs, ks_, vs = q[:, :n], k[:, :n], v[:, :n]
    want = np.asarray(jref.ref_flash_prefill(
        jnp.asarray(qs), jnp.asarray(ks_), jnp.asarray(vs)))
    for fn in (ops.flash_prefill_kernel, ref.ref_flash_prefill):
        got = fn(_t(qs), _t(ks_), _t(vs)).numpy()
        np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: f32 with its mantissa rounded to 10 bits, ties
    away from zero (finite inputs)."""
    bits = x.view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_matmul(a: torch.Tensor, b: torch.Tensor, terms: int):
    """a @ b as the tensor cores take it in f32: one TF32 product
    (``terms`` 1) or 3xTF32 (big.small + small.big + big.big)."""
    ab, bb = _tf32(a), _tf32(b)
    if terms == 1:
        return ab @ bb
    as_, bs = _tf32(a - ab), _tf32(b - bb)
    return (ab @ bs + as_ @ bb) + ab @ bb


def test_3xtf32_split_meets_the_kernel_tolerance():
    """The chip check holds flash_prefill within 2e-5 of its plain
    version.  Emulated here on a 64 x 64 x 64 attention at randn scale (q
    scaled by 1/8, as D^-1/2 at D = 64): the 3xTF32 split the kernel runs
    stays below 2e-6 of float64, one plain TF32 product per product does
    not stay within 2e-5 -- the tolerance rejects a 1xTF32 kernel."""
    worst = {1: 0.0, 3: 0.0}
    for seed in range(4):
        rng = np.random.default_rng(400 + seed)
        q, k, v = (rng.standard_normal((64, 64)).astype(np.float32)
                   for _ in range(3))
        q /= 8
        s64 = q.astype(np.float64) @ k.T.astype(np.float64)
        p64 = np.exp(s64 - s64.max(-1, keepdims=True))
        want = (p64 / p64.sum(-1, keepdims=True)) @ v.astype(np.float64)
        for terms in (1, 3):
            s = _tf32_matmul(_t(q), _t(k).T.contiguous(), terms)
            p = torch.exp(s - s.amax(-1, keepdim=True))
            o = _tf32_matmul(p, _t(v), terms) / p.sum(-1, keepdim=True)
            worst[terms] = max(worst[terms],
                               float(np.abs(o.numpy() - want).max()))
    assert worst[3] < 2e-6, worst
    assert worst[1] > 2e-5, worst


def test_rope_matches_pallas():
    rng = np.random.default_rng(8)
    b, h, d = 3, 5, 32
    x = rng.standard_normal((b, h, d)).astype(np.float32)
    ang = rng.uniform(-3, 3, (b, d // 2)).astype(np.float32)
    ang = np.concatenate([ang, ang], axis=-1)
    cos, sin = np.cos(ang), np.sin(ang)
    # XLA may fuse the multiply-add, so the packages agree to the last
    # place, not bitwise
    want = np.asarray(jops.rope(jnp.asarray(x), jnp.asarray(cos),
                                jnp.asarray(sin), **I))
    want_ref = np.asarray(jref.ref_rope(jnp.asarray(x),
                                        jnp.asarray(cos)[:, None],
                                        jnp.asarray(sin)[:, None]))
    for fn in (ops.rope, ops.rope_kernel, ref.ref_rope):
        got = fn(_t(x), _t(cos), _t(sin)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(got, want_ref, atol=1e-6, rtol=1e-6)


def _meta(shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device="meta")


# one call per new kernel wrapper, on meta tensors of the right shapes
_META_CALLS = {
    "q4_matvec": lambda: ops.q4_matvec_kernel(
        _meta((2, 64), torch.int8), _meta((2, 1)), _meta((8, 32), torch.int8),
        _meta((8, 1)), 64),
    "decode_attention": lambda: ops.decode_attention_kernel(
        _meta((2, 2, 1, 32)), _meta((2, 16, 2, 32)), _meta((2, 16, 2, 32)),
        _meta((2,), torch.int32)),
    "flash_prefill": lambda: ops.flash_prefill_kernel(
        _meta((1, 8, 2, 32)), _meta((1, 8, 2, 32)), _meta((1, 8, 2, 32))),
    "rope": lambda: ops.rope_kernel(_meta((2, 3, 32)), _meta((2, 32)),
                                    _meta((2, 32))),
    "rmsnorm_quant": lambda: ops.rmsnorm_quant_kernel(
        _meta((8, 768)), _meta((768,)), 1e-5, 64),
}


@pytest.mark.parametrize("name", list(_META_CALLS))
def test_new_wrappers_never_take_the_plain_version(name):
    """Off the CPU the wrapper goes to its CUDA kernel or raises."""
    with pytest.raises((RuntimeError, ValueError, NotImplementedError)):
        _META_CALLS[name]()


@pytest.mark.parametrize("arg", ["q", "k", "v"])
def test_flash_prefill_rejects_a_misaligned_view(arg):
    """cp.async copies 16 bytes at a time: a q, k or v view that starts 4
    bytes into its storage raises, and never reaches the plain version."""
    qkv = {a: _meta((1, 8, 2, 32)) for a in ("q", "k", "v")}
    qkv[arg] = _meta((1 + 8 * 2 * 32,))[1:].view(1, 8, 2, 32)
    assert qkv[arg].is_contiguous() and qkv[arg].data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.flash_prefill_kernel(qkv["q"], qkv["k"], qkv["v"])


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


@pytest.mark.parametrize("bad", ["group", "gamma", "dtype", "width"])
def test_rmsnorm_quant_rejects_bad_operands(bad):
    """Shape / dtype / group checks of the fused norm run before any
    launch."""
    x, g, gs = _meta((8, 768)), _meta((768,)), 64
    if bad == "group":
        gs = 48                          # 12 lanes: not a power of two
    elif bad == "gamma":
        g = _meta((384,))
    elif bad == "dtype":
        x = _meta((8, 768), torch.float16)
    else:
        x, g = _meta((8, 8192)), _meta((8192,))   # wider than one block
    with pytest.raises(ValueError):
        ops.rmsnorm_quant_kernel(x, g, 1e-5, gs)
