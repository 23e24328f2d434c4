"""Wrappers around the port's CUDA kernels.

Each ``*_kernel`` function takes the kernel's own operands.  For CPU tensors
it runs the kernel's plain version (:mod:`repro_torch.kernels.ref`); for CUDA
tensors it checks device, dtype, shape, contiguity and alignment, allocates
the output, launches the kernel on the current stream and counts the launch
in ``build.LAUNCHES`` -- or raises.  There is no fallback from a CUDA tensor
to the plain version.

The public functions below them mirror ``repro/kernels/ops.py``: activation
quantization and the Q4 / GEMV / GEMM dispatch (``q8_matmul``, or
``q8_matmul_quantized`` for activations already quantized by the fused
``rmsnorm_quant``), the GQA reshapes of the decode attention kernels, and
the per-row extents of ``flash_prefill``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from repro_torch.core.quantization import QuantizedTensor, quantize
from repro_torch.kernels import ref
from repro_torch.kernels.build import LAUNCHES, launch

# decode-vs-prefill dispatch threshold: at most this many rows go to the
# GEMV kernel (activations reused by every weight row), more to the GEMM.
MATVEC_MAX_ROWS = 32


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(name: str, device: torch.device, **tensors) -> None:
    """Every operand on ``device`` (a CUDA device), contiguous; raise
    otherwise."""
    if device.type != "cuda":
        raise ValueError(f"{name}: operands on {device}; the kernel takes "
                         "CUDA tensors and the plain version CPU tensors")
    for arg, t in tensors.items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected "
                             f"{device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def _dtype(name: str, t: torch.Tensor, *dtypes) -> None:
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: got {t.dtype}, expected one of {dtypes}")


def _check_q8(name: str, xq, xs, wq, ws, group_size: int, align: int):
    m, k = xq.shape
    n, kw = wq.shape
    g = k // group_size
    if kw != k or k % group_size or xs.shape != (m, g) or ws.shape != (n, g):
        raise ValueError(f"{name}: shapes xq {tuple(xq.shape)} xs "
                         f"{tuple(xs.shape)} wq {tuple(wq.shape)} ws "
                         f"{tuple(ws.shape)} with group {group_size}")
    _check(name, xq.device, xq=xq, xs=xs, wq=wq, ws=ws)
    _dtype(name, xq, torch.int8)
    _dtype(name, wq, torch.int8)
    _dtype(name, xs, torch.float32)
    _dtype(name, ws, torch.float32)
    if xq.data_ptr() % align or wq.data_ptr() % align:
        raise ValueError(f"{name}: codes must be {align}-byte aligned")
    return m, n, k


def q8_matvec_kernel(xq, xs, wq, ws, group_size: int) -> torch.Tensor:
    """Decode GEMV (M <= 32): out (M, N) f32 =
    sum_g f32(int32 dot of group g) * xs[m, g] * ws[n, g]."""
    if xq.device.type == "cpu":
        return ref.ref_q8_matmul(xq, xs, wq, ws, group_size)
    m, n, k = _check_q8("q8_matvec", xq, xs, wq, ws, group_size, 16)
    lanes = group_size // 16
    if not (1 <= m <= MATVEC_MAX_ROWS and group_size % 16 == 0
            and lanes & (lanes - 1) == 0 and lanes <= 32):
        raise ValueError(f"q8_matvec: needs 1 <= M <= {MATVEC_MAX_ROWS} and "
                         f"group in 16..512 (power-of-two multiple of 16); "
                         f"got M={m}, group={group_size}")
    out = torch.empty((m, n), dtype=torch.float32, device=xq.device)
    launch("q8_matvec", xq.data_ptr(), xs.data_ptr(), wq.data_ptr(),
           ws.data_ptr(), out.data_ptr(), m, n, k, group_size, _stream(xq))
    return out


def q8_matmul_kernel(xq, xs, wq, ws, group_size: int) -> torch.Tensor:
    """Prefill GEMM (any M): the same function as :func:`q8_matvec_kernel`,
    tiled, folding the groups in the plain version's order (bitwise equal
    to it).  Groups that are a multiple of 16 with 16-byte aligned codes run
    on the int8 tensor cores, the rest on a dp4a kernel, whose launches are
    also counted as ``q8_matmul_dp4a``."""
    if xq.device.type == "cpu":
        return ref.ref_q8_matmul(xq, xs, wq, ws, group_size)
    m, n, k = _check_q8("q8_matmul", xq, xs, wq, ws, group_size, 4)
    if group_size % 4:
        raise ValueError(f"q8_matmul: group {group_size} not a multiple of 4")
    out = torch.empty((m, n), dtype=torch.float32, device=xq.device)
    dp4a = ctypes.c_int(0)
    launch("q8_matmul", xq.data_ptr(), xs.data_ptr(), wq.data_ptr(),
           ws.data_ptr(), out.data_ptr(), m, n, k, group_size,
           ctypes.byref(dp4a), _stream(xq))
    if dp4a.value:
        LAUNCHES["q8_matmul_dp4a"] += 1
    return out


def _check_pool(name, q, k_pool, v_pool, page_table, ks_pool, vs_pool,
                kvh: int, d: int):
    if k_pool.shape != v_pool.shape or tuple(k_pool.shape[2:]) != (kvh, d):
        raise ValueError(f"{name}: pool {tuple(k_pool.shape)} does not match "
                         f"q's kv-heads/dim {(kvh, d)}")
    int8 = ks_pool is not None
    _check(name, q.device, q=q, k_pool=k_pool, v_pool=v_pool,
           page_table=page_table, ks_pool=ks_pool, vs_pool=vs_pool)
    _dtype(name, q, torch.float32)
    _dtype(name, k_pool, torch.int8 if int8 else torch.float32)
    _dtype(name, v_pool, k_pool.dtype)
    _dtype(name, page_table, torch.int32)
    if int8:
        if (ks_pool.shape != k_pool.shape[:3] or vs_pool.shape
                != k_pool.shape[:3]):
            raise ValueError(f"{name}: scale pools must be {k_pool.shape[:3]}")
        _dtype(name, ks_pool, torch.float32)
        _dtype(name, vs_pool, torch.float32)
    return int8


def paged_decode_attention_kernel(q, k_pool, v_pool, page_table, lens,
                                  ks_pool=None, vs_pool=None) -> torch.Tensor:
    """q: (B, KVH, HQ, D) pre-scaled; k/v_pool: (NB, BS, KVH, D) (int8 when
    ks/vs_pool (NB, BS, KVH) are given); page_table (B, MB) int32; lens
    (B,) int32.  Returns (B, KVH, HQ, D) f32."""
    if q.device.type == "cpu":
        return ref.ref_paged_decode_attention(q, k_pool, v_pool, page_table,
                                              lens, ks_pool, vs_pool)
    b, kvh, hq, d = q.shape
    name = "paged_decode_attention"
    int8 = _check_pool(name, q, k_pool, v_pool, page_table, ks_pool, vs_pool,
                       kvh, d)
    _check(name, q.device, lens=lens)
    _dtype(name, lens, torch.int32)
    if d % 4 or hq * d > 1024 or lens.shape != (b,) or \
            page_table.shape[0] != b:
        raise ValueError(f"{name}: needs D % 4 == 0, HQ*D <= 1024, lens "
                         f"(B,), page_table (B, MB); got q {tuple(q.shape)}")
    nb, bs = k_pool.shape[:2]
    out = torch.empty_like(q)
    launch(name, q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
           _ptr(ks_pool), _ptr(vs_pool), page_table.data_ptr(),
           lens.data_ptr(), out.data_ptr(), b, kvh, hq, d, bs,
           page_table.shape[1], int(int8), _stream(q))
    return out


def paged_prefill_attention_kernel(q, k_pool, v_pool, page_table, pfx_lens,
                                   q_lens, ks_pool=None, vs_pool=None):
    """q: (B, C, KVH, HQ, D) pre-scaled; k/v_pool (NB, BS, KVH, D) (int8
    with ks/vs_pool); page_table (B, MB) int32; pfx_lens/q_lens (B,) int32.
    Returns the prefix segment's flash state out (B, C, KVH, HQ, D),
    m and l (B, C, KVH, HQ), f32.  Rows at or past q_lens[b] (the CUDA
    kernel skips them) and an empty prefix are (0, -1e30, 0).

    The plain version computes every row; callers read rows < q_lens only."""
    b, c, kvh, hq, d = q.shape
    if q.device.type == "cpu":
        out, m, l = ref.ref_paged_prefill_attention(
            q.reshape(b, c, kvh * hq, d), k_pool, v_pool, page_table,
            pfx_lens, ks_pool, vs_pool)
        m = m[..., 0].transpose(1, 2).reshape(b, c, kvh, hq)
        l = l[..., 0].transpose(1, 2).reshape(b, c, kvh, hq)
        return out.reshape(b, c, kvh, hq, d), m, l
    name = "paged_prefill_attention"
    int8 = _check_pool(name, q, k_pool, v_pool, page_table, ks_pool, vs_pool,
                       kvh, d)
    _check(name, q.device, pfx_lens=pfx_lens, q_lens=q_lens)
    _dtype(name, pfx_lens, torch.int32)
    _dtype(name, q_lens, torch.int32)
    if d not in (32, 64, 128) or pfx_lens.shape != (b,) or \
            q_lens.shape != (b,) or page_table.shape[0] != b:
        raise ValueError(f"{name}: needs D in (32, 64, 128), pfx_lens/q_lens "
                         f"(B,), page_table (B, MB); got q {tuple(q.shape)}")
    bs = k_pool.shape[1]
    out = torch.empty_like(q)
    m = torch.empty((b, c, kvh, hq), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    launch(name, q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
           _ptr(ks_pool), _ptr(vs_pool), page_table.data_ptr(),
           pfx_lens.data_ptr(), q_lens.data_ptr(), out.data_ptr(),
           m.data_ptr(), l.data_ptr(), b, c, kvh, hq, d, bs,
           page_table.shape[1], int(int8), _stream(q))
    return out, m, l


def q4_matvec_kernel(xq, xs, wq, ws, group_size: int) -> torch.Tensor:
    """Any M: out (M, N) f32 = sum_g f32(int32 dot of group g) * xs[m, g] *
    ws[n, g] against packed Q4_0 weights wq (N, K/2).  M <= 32 runs the
    decode GEMV, more rows the tiled GEMM, which folds the groups in the
    plain version's order (bitwise equal to it).  The GEMV stages xq by
    16-byte loads and copies weights 16 bytes at a time where wq is 16-byte
    aligned and K % 32 == 0, 8 bytes otherwise: xq must be 16-byte and wq
    8-byte aligned.  The GEMM runs on the int8 tensor cores under the same
    two conditions, on a dp4a kernel otherwise, whose launches are also
    counted as ``q4_matvec_dp4a``."""
    if xq.device.type == "cpu":
        return ref.ref_q4_matvec(xq, xs, wq, ws, group_size)
    name = "q4_matvec"
    m, k = xq.shape
    n = wq.shape[0]
    lanes = group_size // 16
    group_ok = (16 <= group_size <= 512 and group_size % 16 == 0
                and lanes & (lanes - 1) == 0 and k % group_size == 0)
    if (not group_ok or wq.shape[1] * 2 != k or k % 16 or m < 1
            or xs.shape != (m, k // group_size)
            or ws.shape != (n, k // group_size)):
        raise ValueError(f"{name}: shapes xq {tuple(xq.shape)} xs "
                         f"{tuple(xs.shape)} wq {tuple(wq.shape)} ws "
                         f"{tuple(ws.shape)} with group {group_size}: needs "
                         "K % 16 == 0 and a group in 16..512 (power-of-two "
                         "multiple of 16) dividing K")
    _check(name, xq.device, xq=xq, xs=xs, wq=wq, ws=ws)
    _dtype(name, xq, torch.int8)
    _dtype(name, wq, torch.int8)
    _dtype(name, xs, torch.float32)
    _dtype(name, ws, torch.float32)
    if xq.data_ptr() % 16 or wq.data_ptr() % 8:
        raise ValueError(f"{name}: xq must be 16-byte aligned (16-byte "
                         "activation loads) and wq 8-byte aligned (8-byte "
                         "weight copies at the least)")
    out = torch.empty((m, n), dtype=torch.float32, device=xq.device)
    dp4a = ctypes.c_int(0)
    launch(name, xq.data_ptr(), xs.data_ptr(), wq.data_ptr(), ws.data_ptr(),
           out.data_ptr(), m, n, k, group_size, ctypes.byref(dp4a),
           _stream(xq))
    if dp4a.value:
        LAUNCHES["q4_matvec_dp4a"] += 1
    return out


def decode_attention_kernel(q, k, v, lens, k_scale=None,
                            v_scale=None) -> torch.Tensor:
    """q: (B, KVH, HQ, D) pre-scaled; k/v: (B, S, KVH, D) (int8 when
    k/v_scale (B, S, KVH) are given); lens (B,) int32, clamped to S.
    Returns (B, KVH, HQ, D) f32; a length-0 row is exactly 0."""
    b, kvh, hq, d = q.shape
    if q.device.type == "cpu":
        return ref.ref_decode_attention(q, k, v, lens.reshape(b, 1),
                                        k_scale, v_scale)
    name = "decode_attention"
    int8 = k_scale is not None
    if (k.shape != v.shape or k.shape[0] != b or tuple(k.shape[2:])
            != (kvh, d) or lens.shape != (b,) or d % 4 or hq * d > 1024):
        raise ValueError(f"{name}: needs k/v (B, S, KVH, D) matching q "
                         f"{tuple(q.shape)}, lens (B,), D % 4 == 0 and "
                         f"HQ*D <= 1024; got k {tuple(k.shape)}")
    _check(name, q.device, q=q, k=k, v=v, lens=lens, k_scale=k_scale,
           v_scale=v_scale)
    _dtype(name, q, torch.float32)
    _dtype(name, k, torch.int8 if int8 else torch.float32)
    _dtype(name, v, k.dtype)
    _dtype(name, lens, torch.int32)
    if int8:
        if k_scale.shape != k.shape[:3] or v_scale.shape != k.shape[:3]:
            raise ValueError(f"{name}: scales must be {tuple(k.shape[:3])}")
        _dtype(name, k_scale, torch.float32)
        _dtype(name, v_scale, torch.float32)
    out = torch.empty_like(q)
    launch(name, q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(k_scale),
           _ptr(v_scale), lens.data_ptr(), out.data_ptr(), b, k.shape[1],
           kvh, hq, d, int(int8), _stream(q))
    return out


def flash_prefill_kernel(q, k, v, q_offset=None, q_lens=None, k_lens=None,
                         causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, H, D) f32 unscaled (scaled by D^-1/2 inside); k/v:
    (B, Sk, KVH, D) f32; q_offset/q_lens/k_lens (B,) int32 or None
    (0, Sq, Sk).  Returns (B, Sq, H, D) f32: causal flash attention with
    GQA heads indexed, queries past q_lens and queries with no live key 0.

    The CUDA kernel runs both products on the tensor cores in 3xTF32 (each
    f32 operand split into two TF32 parts, three MMAs a product: about
    f32's accuracy) and streams K/V tiles into shared memory with 16-byte
    ``cp.async`` copies, so q, k and v must be 16-byte aligned: a view
    that is not raises ``ValueError``."""
    if q.device.type == "cpu":
        return ref.ref_flash_prefill(q, k, v, causal, q_offset, q_lens,
                                     k_lens)
    name = "flash_prefill"
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if (k.shape != v.shape or k.shape[0] != b or k.shape[3] != d
            or d not in (32, 64, 128) or h % kvh):
        raise ValueError(f"{name}: needs k/v (B, Sk, KVH, D) matching q "
                         f"{tuple(q.shape)}, D in (32, 64, 128), H % KVH == "
                         f"0; got k {tuple(k.shape)}")
    for arg, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned for "
                             "cp.async")
    _check(name, q.device, q=q, k=k, v=v, q_offset=q_offset, q_lens=q_lens,
           k_lens=k_lens)
    for t in (q, k, v):
        _dtype(name, t, torch.float32)
    for t in (q_offset, q_lens, k_lens):
        if t is not None:
            _dtype(name, t, torch.int32)
            if t.shape != (b,):
                raise ValueError(f"{name}: per-row extents must be (B,)")
    out = torch.empty_like(q)
    launch(name, q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(q_offset),
           _ptr(q_lens), _ptr(k_lens), out.data_ptr(), b, sq, sk, h, kvh, d,
           int(causal), d ** -0.5, _stream(q))
    return out


def rope_kernel(x, cos, sin) -> torch.Tensor:
    """x: (B, H, D) f32 with heads contiguous in a row (rows may lie
    further apart: the q and k heads of a fused qkv row); cos/sin (B, D)
    f32.  Returns (B, H, D) f32 contiguous, ``x*cos + [-x2, x1]*sin``."""
    if x.device.type == "cpu":
        return ref.ref_rope(x, cos, sin)
    name = "rope"
    b, h, d = x.shape
    if (cos.shape != (b, d) or sin.shape != (b, d) or d % 2
            or x.stride(2) != 1 or x.stride(1) != d or x.stride(0) < h * d):
        raise ValueError(f"{name}: needs x (B, H, D) with contiguous heads "
                         f"and cos/sin (B, D); got x {tuple(x.shape)} "
                         f"strides {x.stride()}, cos {tuple(cos.shape)}")
    _check(name, x.device, cos=cos, sin=sin)
    for t in (x, cos, sin):
        _dtype(name, t, torch.float32)
    out = torch.empty((b, h, d), dtype=torch.float32, device=x.device)
    launch(name, x.data_ptr(), cos.data_ptr(), sin.data_ptr(),
           out.data_ptr(), b, h, d, x.stride(0), _stream(x))
    return out


def _last_pow2(n: int) -> int:
    return 1 << (n.bit_length() - 1)


# The PyTorch release whose CUDA row-mean order _torch_row_mean_order and
# rmsnorm_quant.cu copy.  Another release may change that order; the kernel
# then still normalizes right, but its scales may part from the plain
# version's by an ulp or two.
TORCH_ROW_MEAN_ORDER_OF = "2.11"


def _torch_row_mean_order(m: int, k: int):
    """How PyTorch's CUDA reduction takes the mean of each contiguous f32
    row of an (M, K) tensor, K >= 128 and a multiple of 4
    (``setReduceConfig`` in ATen/native/cuda/Reduce.cuh, torch
    ``TORCH_ROW_MEAN_ORDER_OF``): the threads that share a row (a power of
    two, each summing every that-many-th float4) and the factor
    ``f32(M) / f32(M * K)`` the sum is multiplied by."""
    dim0 = k // 4
    dim0_pow2 = _last_pow2(dim0) if dim0 < 512 else 512
    dim1_pow2 = _last_pow2(m) if m < 512 else 512
    height = min(dim1_pow2, 512 // min(dim0_pow2, 32))
    width = min(dim0_pow2, 512 // height)
    return width, float(np.float32(m) / np.float32(m * k))


def rmsnorm_quant_kernel(x, gamma, eps: float,
                         group_size: int) -> tuple:
    """x (M, K) f32, gamma (K,) f32 -> (codes (M, K) int8, scales
    (M, K / group_size) f32): RMSNorm then Q8_0 per group, in one pass."""
    if x.device.type == "cpu":
        return ref.ref_rmsnorm_quant(x, gamma, eps, group_size)
    name = "rmsnorm_quant"
    m, k = x.shape
    lanes = group_size // 4
    if (group_size % 4 or lanes & (lanes - 1) or lanes > 32 or k % group_size
            or not 128 <= k <= 4096 or m < 1 or gamma.shape != (k,)):
        raise ValueError(f"{name}: needs x (M >= 1, 128 <= K <= 4096), "
                         f"gamma (K,) and a group of 4..128 (4 x a power of "
                         f"two) dividing K; got x {tuple(x.shape)}, gamma "
                         f"{tuple(gamma.shape)}, group {group_size}")
    _check(name, x.device, x=x, gamma=gamma)
    _dtype(name, x, torch.float32)
    _dtype(name, gamma, torch.float32)
    if x.data_ptr() % 16 or gamma.data_ptr() % 16:
        raise ValueError(f"{name}: x and gamma must be 16-byte aligned")
    q = torch.empty((m, k), dtype=torch.int8, device=x.device)
    s = torch.empty((m, k // group_size), dtype=torch.float32,
                    device=x.device)
    width, factor = _torch_row_mean_order(m, k)
    launch(name, x.data_ptr(), gamma.data_ptr(), q.data_ptr(), s.data_ptr(),
           m, k, group_size, eps, factor, width, _stream(x))
    return q, s


# ---------------------------------------------------------------------------
# public wrappers (repro/kernels/ops.py counterparts)
# ---------------------------------------------------------------------------


def q8_matmul(x: torch.Tensor, w: QuantizedTensor) -> torch.Tensor:
    """x (..., K) f32 @ w (N, K).T with the paper's integer semantics:
    activations are Q8_0-quantized on the fly with ``w.group_size``, then
    :func:`q8_matmul_quantized` dispatches."""
    if w.bits not in (4, 8):
        raise ValueError(f"q8_matmul: bits={w.bits}")
    gs = w.group_size
    *lead, k = x.shape
    xt = quantize(x.reshape(-1, k), group_size=gs, bits=8)
    if xt.group_size != gs:
        raise ValueError(f"q8_matmul: K={k} does not split into groups of "
                         f"{gs}")
    return q8_matmul_quantized(xt.q, xt.scale, w).reshape(*lead,
                                                          w.q.shape[0])


def q8_matmul_quantized(xq: torch.Tensor, xs: torch.Tensor,
                        w: QuantizedTensor) -> torch.Tensor:
    """Q8_0 activations, codes xq (M, K) and scales xs (M, K / group), @
    w (N, K).T -> (M, N) f32.  Q4_0 weights go to the Q4 kernel whatever
    the row count, as in the reference; Q8_0 weights to the GEMV kernel for
    at most ``MATVEC_MAX_ROWS`` rows, to the tiled GEMM kernel above that."""
    if w.bits == 4:
        fn = q4_matvec_kernel
    elif w.bits == 8:
        fn = (q8_matvec_kernel if xq.shape[0] <= MATVEC_MAX_ROWS
              else q8_matmul_kernel)
    else:
        raise ValueError(f"q8_matmul: bits={w.bits}")
    return fn(xq, xs, w.q, w.scale, w.group_size)


def rmsnorm_quant(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5,
                  group_size: int = 64):
    """Fused RMSNorm + Q8_0: (..., K) f32 -> ((..., K) int8,
    (..., K / group_size) f32)."""
    *lead, k = x.shape
    q, s = rmsnorm_quant_kernel(x.reshape(-1, k).contiguous(),
                                gamma.contiguous(), eps, group_size)
    return q.reshape(*lead, k), s.reshape(*lead, k // group_size)


# x (B, H, D), cos/sin (B, D): the kernel wrapper already takes the
# reference's layout
rope = rope_kernel


def decode_attention(q, k, v, lens, k_scale=None,
                     v_scale=None) -> torch.Tensor:
    """q: (B, H, D) pre-scaled -> (B, H, D) f32 attention over each row's
    dense cache positions < lens[b]; k/v (B, S, KVH, D)."""
    b, h, d = q.shape
    kvh = k.shape[2]
    out = decode_attention_kernel(q.reshape(b, kvh, h // kvh, d).contiguous(),
                                  k, v, lens, k_scale, v_scale)
    return out.reshape(b, h, d)


def flash_prefill(q, k, v, *, causal: bool = True, q_offset=None,
                  q_lens=None, k_lens=None) -> torch.Tensor:
    """Full-sequence attention: q (B, Sq, H, D) unscaled; k/v
    (B, Sk, KVH, D) -> (B, Sq, H, D) f32.  ``q_offset``, ``q_lens`` and
    ``k_lens`` ((B,) int32 or None) are per-row data, as in the reference;
    GQA heads are indexed, not repeated."""
    return flash_prefill_kernel(q.contiguous(), k.contiguous(),
                                v.contiguous(), q_offset, q_lens, k_lens,
                                causal)


def paged_decode_attention(q, k_pool, v_pool, page_table, lens,
                           ks_pool=None, vs_pool=None) -> torch.Tensor:
    """q: (B, H, D) pre-scaled -> (B, H, D) f32 attention over each row's
    pool positions < lens[b], read through ``page_table``."""
    b, h, d = q.shape
    kvh = k_pool.shape[2]
    out = paged_decode_attention_kernel(
        q.reshape(b, kvh, h // kvh, d).contiguous(), k_pool, v_pool,
        page_table, lens, ks_pool, vs_pool)
    return out.reshape(b, h, d)


def paged_prefill_attention(q, k_pool, v_pool, page_table, pfx_lens,
                            q_lens=None, ks_pool=None, vs_pool=None):
    """q: (B, C, H, D) pre-scaled.  Returns the prefix segment's flash state
    in ``layers.attention_chunk_merge``'s ``pfx_state`` layout: out
    (B, C, H, D), m (B, H, C, 1), l (B, H, C, 1), all f32."""
    b, c, h, d = q.shape
    kvh = k_pool.shape[2]
    if q_lens is None:
        q_lens = torch.full((b,), c, dtype=torch.int32, device=q.device)
    out, m, l = paged_prefill_attention_kernel(
        q.reshape(b, c, kvh, h // kvh, d).contiguous(), k_pool, v_pool,
        page_table, pfx_lens, q_lens, ks_pool, vs_pool)
    m = m.reshape(b, c, h).transpose(1, 2)[..., None]
    l = l.reshape(b, c, h).transpose(1, 2)[..., None]
    return out.reshape(b, c, h, d), m, l
