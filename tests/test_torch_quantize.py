"""The quantize kernel's wrapper, ``rmsnorm_quant``'s launch plan and the
decode step's rope view, on the CPU against the JAX package.

``ops.quantize_kernel`` is ``rmsnorm_quant.cu``'s kernel without the norm;
on CPU tensors it runs its plain version, the port's ``quantize``, whose
codes and scales are bitwise the JAX ``quantize`` under ``jit`` (exact
rounding on both sides: no tolerance).  ``ops.q8_matmul`` quantizes through
it, bitwise the same as ``q8_matmul_quantized`` on the plain ``quantize``.
The launch plan is pure arithmetic, checked exactly: every float4 of a row
summed by one thread in PyTorch's order, every Q8_0 group within one warp,
at most 1024 threads a block.  rope at the decode step's strided view is
held to the JAX Pallas kernel in interpret mode at 1e-6 (XLA may fuse the
multiply-add, so the last place may differ), as ``test_rope_matches_pallas``
does.  The CUDA kernels themselves are held on the card by
``chip_smoke.py`` (``check_rmsnorm_quant``, ``check_rope``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantization as jq
from repro.kernels import ops as jops
from repro_torch.core.quantization import quantize
from repro_torch.kernels import build, ops

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


def _rows(m, k, group, seed):
    """Seeded rows with one all-zero group and one row x 1e4."""
    x = np.random.default_rng(seed).standard_normal((m, k)).astype(np.float32)
    x[0, group:2 * group] = 0.0
    x[-1] *= 1e4
    return x


@functools.partial(jax.jit, static_argnames=("group",))
def _jax_quantize(x, group):
    t = jq.quantize(x, group_size=group, bits=8)
    return t.q, t.scale


# the call sites' (M, K): the decode step's wo_f and w2 GEMVs, the chunk
# step's w2 GEMM, the reduced config's wo_f; groups 64 (Q8_0 and Q4_0's
# paper default) and 32
_SHAPES = [(8, 768, 64), (8, 2048, 64), (2048, 2048, 64), (1, 128, 64),
           (8, 768, 32), (8, 2048, 32)]


@pytest.mark.parametrize("m,k,group", _SHAPES)
def test_quantize_kernel_is_quantize_bitwise(m, k, group):
    x = _rows(m, k, group, m + k + group)
    q, s = ops.quantize_kernel(_t(x), group)
    want = quantize(_t(x), group, 8)
    assert q.dtype == torch.int8 and s.shape == (m, k // group)
    assert torch.equal(q, want.q) and torch.equal(s, want.scale)
    jqv, jsv = _jax_quantize(jnp.asarray(x), group)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(s.numpy(), np.asarray(jsv))
    assert (q[0, group:2 * group] == 0).all() and s[0, 1] == 0


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m", [8, 40])
def test_q8_matmul_quantizes_through_the_kernel_wrapper(bits, m):
    """``ops.q8_matmul`` (now through ``quantize_kernel``) on CPU tensors is
    bitwise ``q8_matmul_quantized`` on the plain ``quantize``'s codes, for
    Q8_0 and Q4_0 weights, at a GEMV's and a GEMM's row count."""
    rng = np.random.default_rng(bits * 100 + m)
    x = rng.standard_normal((2, m // 2, 256)).astype(np.float32)
    w = quantize(_t(rng.standard_normal((96, 256)).astype(np.float32)), 64,
                 bits=bits)
    got = ops.q8_matmul(_t(x), w)
    xt = quantize(_t(x).reshape(-1, 256), 64, 8)
    want = ops.q8_matmul_quantized(xt.q, xt.scale, w).reshape(2, m // 2, 96)
    assert got.shape == (2, m // 2, 96)
    assert torch.equal(got, want)


def test_q8_matmul_rejects_a_width_its_groups_do_not_split():
    w = quantize(torch.randn(16, 128), 64)
    with pytest.raises(ValueError, match="does not split into groups"):
        ops.q8_matmul(torch.randn(2, 96), w)


def _plan_map(m, k, width):
    """Simulate ``rmsnorm_quant.cu``'s mapping under the plan: for each
    (block, thread, slot j) that holds a float4, its row, its float4 index
    i = t + j * width and its warp.  Returns (rows, vecs, row, i, warp)."""
    width_, rows, vecs = ops.rmsnorm_quant_plan(m, k, width)
    assert width_ == width
    blk, tid, j = np.meshgrid(np.arange(-(-m // rows)),
                              np.arange(width * rows), np.arange(vecs),
                              indexing="ij")
    row = blk * rows + tid // width
    i = tid % width + j * width
    live = (row < m) & (i < k // 4)
    warp = blk * 32 + tid // 32
    return rows, vecs, row[live], i[live], warp[live]


def _check_plan(m, k, width, group):
    rows, vecs, row, i, warp = _plan_map(m, k, width)
    n4 = k // 4
    # every float4 of every row held once, by thread t = i % width of the
    # row, which sums t, t + width, ... in that order (slot j = i // width)
    key = row * n4 + i
    assert len(key) == m * n4 and len(np.unique(key)) == m * n4
    # each Q8_0 group's float4s lie in one warp of one block
    gkey = row * (k // group) + i // (group // 4)
    pairs = np.unique(np.stack([gkey, warp]), axis=1)
    assert pairs.shape[1] == m * (k // group)
    assert width * rows <= 1024
    assert vecs < 16 or width * rows <= 256     # the kernel's launch bounds
    assert vecs in ops.Q8_ROWS_VECS and vecs * width * 4 >= k
    return rows, vecs


_PLAN_CASES = [(w, k, g) for w in (32, 64, 128)
               for k in (128, 192, 768, 2048, 4096)
               for g in (16, 32, 64, 128) if k % g == 0]


@pytest.mark.parametrize("width,k,group", _PLAN_CASES)
def test_rmsnorm_quant_plan_covers_each_row_in_torch_order(width, k, group):
    """Every float4 summed by exactly one thread, thread t of a row taking
    t, t + width, ... as torch's reduction does; each Q8_0 group's float4s
    in one warp of one block; at most 1024 threads a block, at most 256
    where a thread holds 16 or more float4s (the kernel's launch bounds).
    M = 270 puts three rows in a block."""
    assert [_check_plan(m, k, width, group)[0] for m in (1, 8, 270)] == [
        1, 1, min(3, 256 // width)]


@pytest.mark.parametrize("m,k", [(1, 768), (8, 768), (2048, 768),
                                 (1, 4096), (2, 4096), (16, 4096),
                                 (1, 128), (3, 2048)])
def test_rmsnorm_quant_plan_at_torch_widths(m, k):
    """The plan at PyTorch's own width for (M, K), rows of 256 and 512
    threads included: 128 / 64 / 32 threads a row at K = 768 for M = 1 /
    8 / 2048, 512 and 256 at K = 4096 for M = 1 and 2."""
    width, _ = ops._torch_row_mean_order(m, k)
    rows, vecs = _check_plan(m, k, width, 64)
    want = {(1, 768): (128, 1, 2), (8, 768): (64, 1, 3),
            (2048, 768): (32, 8, 6), (1, 4096): (512, 1, 2),
            (2, 4096): (256, 1, 4)}.get((m, k))
    assert want is None or (width, rows, vecs) == want


def _meta(shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("bad", ["group", "wide_group", "split", "dtype",
                                 "wide", "rank"])
def test_quantize_kernel_rejects_bad_operands(bad):
    """Shape / dtype / group checks of the quantize entry run before any
    launch; a tensor off the CPU never takes the plain version."""
    x, gs = _meta((8, 768)), 64
    if bad == "group":
        gs = 48                          # 12 lanes: not a power of two
    elif bad == "wide_group":
        gs, x = 256, _meta((8, 1024))    # 64 lanes: wider than a warp
    elif bad == "split":
        x = _meta((8, 800))              # K % group != 0
    elif bad == "dtype":
        x = _meta((8, 768), torch.float16)
    elif bad == "wide":
        x = _meta((8, 131072))           # 64 float4s a thread
    else:
        x = _meta((8,))
    with pytest.raises(ValueError):
        ops.quantize_kernel(x, gs)


def test_quantize_kernel_never_takes_the_plain_version(monkeypatch):
    """On meta tensors (a dry run) the entry checks its operands as for
    the card and answers with empty meta outputs: no plain version, no
    launch."""
    def refuse(*args, **kwargs):
        raise AssertionError("took the plain version or launched")
    monkeypatch.setattr(ops, "quantize", refuse)
    monkeypatch.setattr(ops, "launch", refuse)
    q, s = ops.quantize_kernel(_meta((8, 768)), 64)
    assert (q.device.type, q.shape, q.dtype) == ("meta", (8, 768),
                                                 torch.int8)
    assert (s.device.type, s.shape, s.dtype) == ("meta", (8, 12),
                                                 torch.float32)


@pytest.mark.parametrize("bad", ["odd_d", "cos", "dtype", "heads"])
def test_rope_kernel_rejects_bad_operands(bad):
    x, cos, sin = _meta((8, 36, 64))[:, :24], _meta((8, 64)), _meta((8, 64))
    if bad == "odd_d":
        x, cos, sin = _meta((8, 4, 33)), _meta((8, 33)), _meta((8, 33))
    elif bad == "cos":
        cos = _meta((8, 32))
    elif bad == "dtype":
        x = _meta((8, 24, 64), torch.float16)
    else:
        x = _meta((8, 64, 24)).transpose(1, 2)   # heads not contiguous
    with pytest.raises(ValueError):
        ops.rope_kernel(x, cos, sin)


def test_build_holds_quantize_in_rmsnorm_quants_library():
    """One source, two entry points: ``quantize`` loads from
    ``rmsnorm_quant``'s library, is built with it, and counts on its own."""
    assert build.library_path("quantize") == build.library_path(
        "rmsnorm_quant")
    assert "quantize" in build.SIGNATURES and "quantize" in build.LAUNCHES
    assert "quantize" not in build.SOURCES
    assert set(build.SOURCES) == set(build.SIGNATURES) - {"quantize"}
    text = (build.CSRC / "rmsnorm_quant.cu").read_text()
    assert 'extern "C" int quantize(' in text
    assert 'extern "C" int rmsnorm_quant(' in text


def test_both_latency_kernels_launch_with_pdl():
    """Both sources launch through the shared PDL header, whose wait comes
    before any activation read."""
    for name in ("rmsnorm_quant", "rope"):
        text = (build.CSRC / f"{name}.cu").read_text()
        assert '#include "pdl.cuh"' in text and "launch_pdl(" in text
        assert text.index("grid_dependency_wait();") < text.index("__ldcg(")
    assert "<<<" not in (build.CSRC / "rope.cu").read_text()


def test_rope_at_the_decode_view_matches_pallas():
    """rope on the decode step's view: B = 8, the first 24 of a qkv row's
    36 heads of 64, read in place (row stride 36 * 64), against the JAX
    Pallas rope in interpret mode on the same heads."""
    rng = np.random.default_rng(22)
    b, heads, h, d = 8, 36, 24, 64
    qkv = rng.standard_normal((b, heads * d)).astype(np.float32)
    ang = rng.uniform(-3, 3, (b, d // 2)).astype(np.float32)
    ang = np.concatenate([ang, ang], axis=-1)
    cos, sin = np.cos(ang), np.sin(ang)
    view = _t(qkv).reshape(b, heads, d)[:, :h]
    assert view.stride(0) == heads * d and not view.is_contiguous()
    want = np.asarray(jops.rope(jnp.asarray(qkv.reshape(b, heads, d)[:, :h]),
                                jnp.asarray(cos), jnp.asarray(sin), **I))
    for fn in (ops.rope, ops.rope_kernel):
        got = fn(view, _t(cos), _t(sin)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
