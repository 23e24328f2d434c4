"""Wrappers around the port's CUDA kernels.

Each ``*_kernel`` function takes the kernel's own operands.  For CPU tensors
it runs the kernel's plain version (:mod:`repro_torch.kernels.ref`); for CUDA
tensors it checks device, dtype, shape, contiguity and alignment, allocates
the output, launches the kernel on the current stream and counts the launch
in ``build.LAUNCHES`` -- or raises.  There is no fallback from a CUDA tensor
to the plain version.  ``meta`` tensors (a dry run, ``launch/dryrun.py``)
take the CUDA path's checks and allocation, and the wrapper returns its
outputs, empty meta tensors of the kernel's shapes and dtypes, where it
would launch: nothing is launched, counted in ``LAUNCHES`` or computed.

On every device each wrapper reports its operations to the active
operation counter (``launch/flops.py``): the number the reference's
``flops_of_jaxpr`` counts for the jnp twin of its computation, 2·M·N·K
for a Q8_0 / Q4_0 product, QK and PV over every key the twin's einsums
span (the masked ones too), 0 for ``rope``, ``rmsnorm_quant`` and
``quantize``, which contract nothing.  On the CPU the plain version then
runs with the count paused.  On the card the only addition is the test of
whether a counter is active.

The public functions below them mirror ``repro/kernels/ops.py``: activation
quantization (``quantize_kernel``) and the Q4 / GEMV / GEMM dispatch
(``q8_matmul``, or ``q8_matmul_quantized`` for activations already
quantized by the fused ``rmsnorm_quant``), the GQA reshapes of the decode
attention kernels, and the per-row extents of ``flash_prefill``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from repro_torch.core.quantization import QuantizedTensor, quantize
from repro_torch.kernels import ref
from repro_torch.kernels.build import LAUNCHES, launch
from repro_torch.launch import flops

# decode-vs-prefill dispatch threshold: at most this many rows go to the
# GEMV kernel (activations reused by every weight row), more to the GEMM.
MATVEC_MAX_ROWS = 32


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(name: str, device: torch.device, **tensors) -> None:
    """Every operand on ``device`` (a CUDA device, or ``meta`` for a dry
    run), contiguous; raise otherwise."""
    if device.type not in ("cuda", "meta"):
        raise ValueError(f"{name}: operands on {device}; the kernel takes "
                         "CUDA tensors (meta ones in a dry run) and the "
                         "plain version CPU tensors")
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
    if flops.counting():
        flops.report(2.0 * xq.shape[0] * wq.shape[0] * xq.shape[1])
    if xq.device.type == "cpu":
        with flops.paused():
            return ref.ref_q8_matmul(xq, xs, wq, ws, group_size)
    m, n, k = _check_q8("q8_matvec", xq, xs, wq, ws, group_size, 16)
    lanes = group_size // 16
    if not (1 <= m <= MATVEC_MAX_ROWS and group_size % 16 == 0
            and lanes & (lanes - 1) == 0 and lanes <= 32):
        raise ValueError(f"q8_matvec: needs 1 <= M <= {MATVEC_MAX_ROWS} and "
                         f"group in 16..512 (power-of-two multiple of 16); "
                         f"got M={m}, group={group_size}")
    out = torch.empty((m, n), dtype=torch.float32, device=xq.device)
    if xq.device.type == "meta":
        return out
    launch("q8_matvec", xq.data_ptr(), xs.data_ptr(), wq.data_ptr(),
           ws.data_ptr(), out.data_ptr(), m, n, k, group_size, _stream(xq))
    return out


def q8_matmul_kernel(xq, xs, wq, ws, group_size: int) -> torch.Tensor:
    """Prefill GEMM (any M): the same function as :func:`q8_matvec_kernel`,
    tiled, folding the groups in the plain version's order (bitwise equal
    to it).  Groups that are a multiple of 16 with 16-byte aligned codes run
    on the int8 tensor cores, the rest on a dp4a kernel, whose launches are
    also counted as ``q8_matmul_dp4a``."""
    if flops.counting():
        flops.report(2.0 * xq.shape[0] * wq.shape[0] * xq.shape[1])
    if xq.device.type == "cpu":
        with flops.paused():
            return ref.ref_q8_matmul(xq, xs, wq, ws, group_size)
    m, n, k = _check_q8("q8_matmul", xq, xs, wq, ws, group_size, 4)
    if group_size % 4:
        raise ValueError(f"q8_matmul: group {group_size} not a multiple of 4")
    out = torch.empty((m, n), dtype=torch.float32, device=xq.device)
    if xq.device.type == "meta":
        return out
    dp4a = ctypes.c_int(0)
    launch("q8_matmul", xq.data_ptr(), xs.data_ptr(), wq.data_ptr(),
           ws.data_ptr(), out.data_ptr(), m, n, k, group_size,
           ctypes.byref(dp4a), _stream(xq))
    if dp4a.value:
        LAUNCHES["q8_matmul_dp4a"] += 1
    return out


# a pool's element as the attention kernels' C entries name it
POOL_KINDS = {torch.float32: 0, torch.int8: 1, torch.bfloat16: 2}


def _check_pool(name, q, k_pool, v_pool, page_table, ks_pool, vs_pool,
                kvh: int, d: int) -> int:
    """Check a paged pool and return its kind (``POOL_KINDS``): f32 or
    bf16 rows, or int8 rows with f32 scale pools."""
    if k_pool.shape != v_pool.shape or tuple(k_pool.shape[2:]) != (kvh, d):
        raise ValueError(f"{name}: pool {tuple(k_pool.shape)} does not match "
                         f"q's kv-heads/dim {(kvh, d)}")
    int8 = ks_pool is not None
    _check(name, q.device, q=q, k_pool=k_pool, v_pool=v_pool,
           page_table=page_table, ks_pool=ks_pool, vs_pool=vs_pool)
    _dtype(name, q, torch.float32)
    if int8:
        _dtype(name, k_pool, torch.int8)
    else:
        _dtype(name, k_pool, torch.float32, torch.bfloat16)
    _dtype(name, v_pool, k_pool.dtype)
    _dtype(name, page_table, torch.int32)
    if int8:
        if (ks_pool.shape != k_pool.shape[:3] or vs_pool.shape
                != k_pool.shape[:3]):
            raise ValueError(f"{name}: scale pools must be {k_pool.shape[:3]}")
        _dtype(name, ks_pool, torch.float32)
        _dtype(name, vs_pool, torch.float32)
    return POOL_KINDS[k_pool.dtype]


# a lane of the decode kernels holds HQ*D/32 f32 accumulators of its
# block's query heads, at most 32 (flash_decode.cuh's NA): a block folds
# at most this many (head, dim) values of a KV head
DECODE_MAX_HQ_D = 1024


def decode_head_groups(hq: int, d: int) -> int:
    """The groups the HQ query heads of a KV head are cut into across the
    decode kernels' grid (``flash_decode.cuh``): the fewest, each of the
    same HQ / G heads, that hold at most ``DECODE_MAX_HQ_D`` values of D.
    1 up to HQ*D = 1024 (llama2-110m 64, llama3.2-3b 384), 2 for glm4-9b's
    16 heads of 128.  Raises where no G serves: D not a multiple of 4, or
    one head wider than a block holds."""
    if hq < 1 or d < 4 or d % 4 or d > DECODE_MAX_HQ_D:
        raise ValueError(f"decode attention: needs D % 4 == 0 and D <= "
                         f"{DECODE_MAX_HQ_D} (a lane holds a block's "
                         f"HQ*D/32 <= 32 accumulators); got HQ {hq}, D {d}")
    g = -(-hq * d // DECODE_MAX_HQ_D)
    while hq % g:
        g += 1
    return g


def paged_decode_attention_kernel(q, k_pool, v_pool, page_table, lens,
                                  ks_pool=None, vs_pool=None) -> torch.Tensor:
    """q: (B, KVH, HQ, D) f32 pre-scaled; k/v_pool: (NB, BS, KVH, D) f32
    or bf16 (int8 when ks/vs_pool (NB, BS, KVH) are given); page_table (B,
    MB) int32; lens (B,) int32.  Returns (B, KVH, HQ, D) f32; a length-0
    row is exactly 0.  A -1 entry inside a row's length reads pool block
    0, as the reference does: only lens masks.  The kernel cuts a KV
    head's HQ query heads into :func:`decode_head_groups` groups."""
    if flops.counting():
        flops.report(4.0 * q.numel() * page_table.shape[1] * k_pool.shape[1])
    if q.device.type == "cpu":
        with flops.paused():
            return ref.ref_paged_decode_attention(q, k_pool, v_pool,
                                                  page_table, lens, ks_pool,
                                                  vs_pool)
    b, kvh, hq, d = q.shape
    name = "paged_decode_attention"
    kind = _check_pool(name, q, k_pool, v_pool, page_table, ks_pool,
                       vs_pool, kvh, d)
    _check(name, q.device, lens=lens)
    _dtype(name, lens, torch.int32)
    if lens.shape != (b,) or page_table.shape[0] != b:
        raise ValueError(f"{name}: needs lens (B,) and page_table (B, MB); "
                         f"got q {tuple(q.shape)}, lens "
                         f"{tuple(lens.shape)}, page_table "
                         f"{tuple(page_table.shape)}")
    groups = decode_head_groups(hq, d)
    bs = k_pool.shape[1]
    out = torch.empty_like(q)
    if q.device.type == "meta":
        return out
    launch(name, q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
           _ptr(ks_pool), _ptr(vs_pool), page_table.data_ptr(),
           lens.data_ptr(), out.data_ptr(), b, kvh, hq, d, bs,
           page_table.shape[1], kind, groups, _stream(q))
    return out


def paged_prefill_attention_kernel(q, k_pool, v_pool, page_table, pfx_lens,
                                   q_lens, ks_pool=None, vs_pool=None):
    """q: (B, C, KVH, HQ, D) f32 pre-scaled; k/v_pool (NB, BS, KVH, D) f32
    or bf16 (int8 with ks/vs_pool); page_table (B, MB) int32;
    pfx_lens/q_lens (B,) int32.
    Returns the prefix segment's flash state out (B, C, KVH, HQ, D),
    m and l (B, C, KVH, HQ), f32.  Rows at or past q_lens[b] (the CUDA
    kernel skips them) and an empty prefix are (0, -1e30, 0).

    The plain version computes every row; callers read rows < q_lens only.
    The CUDA kernel runs both products on the tensor cores in 3xTF32 (as
    ``flash_prefill``) and copies K/V rows, int8 codes and their scales
    with ``cp.async``, so q, the pools and the scale pools must be 16-byte
    aligned: a view that is not raises ``ValueError``."""
    b, c, kvh, hq, d = q.shape
    if flops.counting():
        flops.report(4.0 * q.numel() * page_table.shape[1] * k_pool.shape[1])
    if q.device.type == "cpu":
        with flops.paused():
            out, m, l = ref.ref_paged_prefill_attention(
                q.reshape(b, c, kvh * hq, d), k_pool, v_pool, page_table,
                pfx_lens, ks_pool, vs_pool)
        m = m[..., 0].transpose(1, 2).reshape(b, c, kvh, hq)
        l = l[..., 0].transpose(1, 2).reshape(b, c, kvh, hq)
        return out.reshape(b, c, kvh, hq, d), m, l
    name = "paged_prefill_attention"
    for arg, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                   ("ks_pool", ks_pool), ("vs_pool", vs_pool)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned for "
                             "cp.async")
    kind = _check_pool(name, q, k_pool, v_pool, page_table, ks_pool,
                       vs_pool, kvh, d)
    _check(name, q.device, pfx_lens=pfx_lens, q_lens=q_lens)
    _dtype(name, pfx_lens, torch.int32)
    _dtype(name, q_lens, torch.int32)
    if d not in (32, 64, 128) or pfx_lens.shape != (b,) or \
            q_lens.shape != (b,) or page_table.shape[0] != b:
        raise ValueError(f"{name}: needs D in (32, 64, 128) (the head dims "
                         f"the kernel is instantiated for), pfx_lens/q_lens "
                         f"(B,), page_table (B, MB); got q {tuple(q.shape)}")
    bs = k_pool.shape[1]
    out = torch.empty_like(q)
    m = torch.empty((b, c, kvh, hq), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    if q.device.type == "meta":
        return out, m, l
    launch(name, q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
           _ptr(ks_pool), _ptr(vs_pool), page_table.data_ptr(),
           pfx_lens.data_ptr(), q_lens.data_ptr(), out.data_ptr(),
           m.data_ptr(), l.data_ptr(), b, c, kvh, hq, d, bs,
           page_table.shape[1], kind, _stream(q))
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
    if flops.counting():
        flops.report(2.0 * xq.shape[0] * wq.shape[0] * xq.shape[1])
    if xq.device.type == "cpu":
        with flops.paused():
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
    if xq.device.type == "meta":
        return out
    dp4a = ctypes.c_int(0)
    launch(name, xq.data_ptr(), xs.data_ptr(), wq.data_ptr(), ws.data_ptr(),
           out.data_ptr(), m, n, k, group_size, ctypes.byref(dp4a),
           _stream(xq))
    if dp4a.value:
        LAUNCHES["q4_matvec_dp4a"] += 1
    return out


def decode_attention_kernel(q, k, v, lens, k_scale=None,
                            v_scale=None) -> torch.Tensor:
    """q: (B, KVH, HQ, D) f32 pre-scaled; k/v: (B, S, KVH, D) f32 or bf16
    (int8 when k/v_scale (B, S, KVH) are given); lens (B,) int32, clamped
    to S.  Returns (B, KVH, HQ, D) f32; a length-0 row is exactly 0.
    The kernel cuts a KV head's HQ query heads into
    :func:`decode_head_groups` groups."""
    b, kvh, hq, d = q.shape
    if flops.counting():
        flops.report(4.0 * q.numel() * k.shape[1])
    if q.device.type == "cpu":
        with flops.paused():
            return ref.ref_decode_attention(q, k, v, lens.reshape(b, 1),
                                            k_scale, v_scale)
    name = "decode_attention"
    int8 = k_scale is not None
    if (k.shape != v.shape or k.shape[0] != b or tuple(k.shape[2:])
            != (kvh, d) or lens.shape != (b,)):
        raise ValueError(f"{name}: needs k/v (B, S, KVH, D) matching q "
                         f"{tuple(q.shape)} and lens (B,); got k "
                         f"{tuple(k.shape)}")
    groups = decode_head_groups(hq, d)
    _check(name, q.device, q=q, k=k, v=v, lens=lens, k_scale=k_scale,
           v_scale=v_scale)
    _dtype(name, q, torch.float32)
    if int8:
        _dtype(name, k, torch.int8)
    else:
        _dtype(name, k, torch.float32, torch.bfloat16)
    _dtype(name, v, k.dtype)
    _dtype(name, lens, torch.int32)
    if int8:
        if k_scale.shape != k.shape[:3] or v_scale.shape != k.shape[:3]:
            raise ValueError(f"{name}: scales must be {tuple(k.shape[:3])}")
        _dtype(name, k_scale, torch.float32)
        _dtype(name, v_scale, torch.float32)
    out = torch.empty_like(q)
    if q.device.type == "meta":
        return out
    launch(name, q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(k_scale),
           _ptr(v_scale), lens.data_ptr(), out.data_ptr(), b, k.shape[1],
           kvh, hq, d, POOL_KINDS[k.dtype], groups, _stream(q))
    return out


def flash_prefill_kernel(q, k, v, q_offset=None, q_lens=None, k_lens=None,
                         causal: bool = True, scale=None) -> torch.Tensor:
    """q: (B, Sq, H, D) f32 or bf16, scaled by ``scale`` inside (None:
    D^-1/2; a caller that pre-scaled q passes 1.0); k/v: (B, Sk, KVH, D) of
    q's dtype; q_offset/q_lens/k_lens (B,) int32 or None (0, Sq, Sk).
    Returns (B, Sq, H, D) f32: causal flash attention with GQA heads
    indexed, queries past q_lens and queries with no live key 0.

    The CUDA kernel runs both products on the tensor cores in 3xTF32 (each
    f32 operand split into two TF32 parts, three MMAs a product: about
    f32's accuracy; a bf16 value is widened to f32 exactly first) and
    streams K/V tiles into shared memory with 16-byte ``cp.async`` copies,
    so q, k and v must be 16-byte aligned: a view that is not raises
    ``ValueError``."""
    b, sq, h, d = q.shape
    scale = d ** -0.5 if scale is None else float(scale)
    if flops.counting():
        flops.report(4.0 * q.numel() * k.shape[1])
    if q.device.type == "cpu":
        with flops.paused():
            return ref.ref_flash_prefill(q, k, v, causal, q_offset, q_lens,
                                         k_lens, scale)
    name = "flash_prefill"
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
    _dtype(name, q, torch.float32, torch.bfloat16)
    for t in (k, v):
        _dtype(name, t, q.dtype)
    for t in (q_offset, q_lens, k_lens):
        if t is not None:
            _dtype(name, t, torch.int32)
            if t.shape != (b,):
                raise ValueError(f"{name}: per-row extents must be (B,)")
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    if q.device.type == "meta":
        return out
    launch(name, q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(q_offset),
           _ptr(q_lens), _ptr(k_lens), out.data_ptr(), b, sq, sk, h, kvh, d,
           int(causal), scale, POOL_KINDS[q.dtype], _stream(q))
    return out


def rope_kernel(x, cos, sin) -> torch.Tensor:
    """x: (B, H, D) f32 or bf16 with heads contiguous in a row (rows may
    lie further apart: the q and k heads of a fused qkv row); cos/sin (B,
    D) f32.  Returns (B, H, D) of x's dtype, contiguous, ``x*cos + [-x2,
    x1]*sin`` computed in f32."""
    if x.device.type == "cpu":
        with flops.paused():
            return ref.ref_rope(x, cos, sin)
    name = "rope"
    b, h, d = x.shape
    if (cos.shape != (b, d) or sin.shape != (b, d) or d % 2
            or x.stride(2) != 1 or x.stride(1) != d or x.stride(0) < h * d):
        raise ValueError(f"{name}: needs x (B, H, D) with contiguous heads "
                         f"and cos/sin (B, D); got x {tuple(x.shape)} "
                         f"strides {x.stride()}, cos {tuple(cos.shape)}")
    _check(name, x.device, cos=cos, sin=sin)
    _dtype(name, x, torch.float32, torch.bfloat16)
    for t in (cos, sin):
        _dtype(name, t, torch.float32)
    out = torch.empty((b, h, d), dtype=x.dtype, device=x.device)
    if x.device.type == "meta":
        return out
    launch(name, x.data_ptr(), cos.data_ptr(), sin.data_ptr(),
           out.data_ptr(), b, h, d, x.stride(0),
           int(x.dtype == torch.bfloat16), _stream(x))
    return out


def _last_pow2(n: int) -> int:
    return 1 << (n.bit_length() - 1)


# The PyTorch release whose CUDA row-mean order _torch_row_mean_order and
# rmsnorm_quant.cu copy.  Another release may change that order; the kernel
# then still normalizes right, but its scales may part from the plain
# version's by an ulp or two.
TORCH_ROW_MEAN_ORDER_OF = "2.11"


def _torch_reduce_block(m: int, k: int):
    """The block PyTorch's CUDA reduction launches for the mean of each
    contiguous f32 row of an (M, K) tensor, K >= 128 and a multiple of 4
    (``setReduceConfig`` in ATen/native/cuda/Reduce.cuh, torch
    ``TORCH_ROW_MEAN_ORDER_OF``; vectorized by 4): (x threads, y warp-rows)."""
    dim0 = k // 4
    dim0_pow2 = _last_pow2(dim0) if dim0 < 512 else 512
    dim1_pow2 = _last_pow2(m) if m < 512 else 512
    height = min(dim1_pow2, 512 // min(dim0_pow2, 32))
    return min(dim0_pow2, 512 // height), height


def _torch_row_mean_order(m: int, k: int):
    """How PyTorch's CUDA reduction takes the mean of each row of an (M, K)
    f32 tensor (:func:`_torch_reduce_block`): the x threads of its block,
    which share a row or a slice of one (a power of two, each summing every
    that-many-th float4 of its slice), and the factor ``f32(M) / f32(M *
    K)`` the sum is multiplied by."""
    width, _ = _torch_reduce_block(m, k)
    return width, float(np.float32(m) / np.float32(m * k))


def _torch_row_split(m: int, k: int) -> int:
    """How many of PyTorch's warp-rows (y) share one row: all of them
    where each x thread would otherwise sum at least min(16 * height, 256)
    values (``split_across_warps``; K = 8192 from M = 2 on), else 1.  A
    split row's thread (x, y) sums the float4s x + width * y, + 512, ...;
    the slices' sums fold over y after each slice's own tree.  Raises
    where PyTorch would also split a row across blocks."""
    width, height = _torch_reduce_block(m, k)
    if -(-k // width) < min(16 * height, 256):
        return 1
    if height > 1 and -(-k // (width * height)) >= 256:
        raise ValueError(f"rmsnorm_quant: K={k} at M={m}: PyTorch splits "
                         "such a row across blocks, an order the kernel "
                         "does not take")
    return height


# float4s a thread that rmsnorm_quant.cu instantiates (kVecs): 40 for
# PyTorch's 32 threads a row of K 5120 (llama4's d_model) from M = 16 on
Q8_ROWS_VECS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 40)
# the float4s a thread of ``quantize`` holds at most: its width is free, so
# it takes more threads a row before the 40-float4 plan
QUANTIZE_VECS = 32
# the most threads a block of several rows holds
Q8_ROWS_BLOCK = 256
# an H100's SMs: rows share blocks only once there is a block for each
H100_SMS = 132


def quantize_width(k: int) -> int:
    """Threads a row of ``quantize``: 32, or the fewest (a power of two)
    that hold a row of K in ``QUANTIZE_VECS`` float4s a thread (64 for
    w2's K = 8192).  Without a norm there is no order to copy: any width
    gives the same bits."""
    width = 32
    while width < 512 and width * 4 * QUANTIZE_VECS < k:
        width *= 2
    return width


def rmsnorm_quant_plan(m: int, k: int, width: int, split: int = 1):
    """Launch plan of ``rmsnorm_quant.cu`` for M rows of K columns, with
    ``width`` threads a row slice (PyTorch's x threads, or
    :func:`quantize_width` for ``quantize``) and ``split`` slices a row
    (:func:`_torch_row_split`): (threads a row, rows a block, float4s a
    thread).  Thread t of a row holds the float4s t, t + width * split,
    ... (the last sweep may be part dead).  A row of more than 128
    threads has a block of its own; narrower rows share blocks of at most
    ``Q8_ROWS_BLOCK`` threads, but
    only as many as it takes to keep one block for each of the card's
    SMs, so that a few decode rows spread over as many SMs as there are
    rows.  The kernel holds a thread's float4s in registers: at most
    ``Q8_ROWS_VECS[-1]`` of them, in blocks of at most 256 threads from
    16 on (its launch bounds), which bounds K at a given width."""
    width *= split
    need = -(-(k // 4) // width)
    vecs = next((v for v in Q8_ROWS_VECS if v >= need), None)
    if vecs is None or (vecs >= 16 and width > Q8_ROWS_BLOCK):
        raise ValueError(f"rmsnorm_quant: K={k} at {width} threads a row "
                         f"needs {need} float4s a thread; the kernel holds "
                         f"at most {Q8_ROWS_VECS[-1]}, and at most 16 in a "
                         f"row of more than {Q8_ROWS_BLOCK} threads")
    rows = max(1, min(Q8_ROWS_BLOCK // width, -(-m // H100_SMS)))
    return width, rows, vecs


def _check_q8_rows(name: str, x, group_size: int, k_min: int) -> None:
    """x (M >= 1, K >= k_min) f32 (16-byte aligned) or bf16 (8-byte
    aligned: four values a load), with a group of 4..128 (4 x a power of
    two) dividing K.  How wide K may be is the launch plan's to say
    (:func:`rmsnorm_quant_plan`)."""
    m, k = x.shape
    lanes = group_size // 4
    if (group_size < 4 or group_size % 4 or lanes & (lanes - 1) or lanes > 32
            or k % group_size or k < k_min or m < 1):
        raise ValueError(f"{name}: needs x (M >= 1, K >= {k_min}) and a "
                         f"group of 4..128 (4 x a power of two) dividing K; "
                         f"got x {tuple(x.shape)}, group {group_size}")
    _check(name, x.device, x=x)
    _dtype(name, x, torch.float32, torch.bfloat16)
    if x.data_ptr() % (4 * x.element_size()):
        raise ValueError(f"{name}: x must be {4 * x.element_size()}-byte "
                         "aligned")


def _q8_outputs(x, group_size: int):
    m, k = x.shape
    return (torch.empty((m, k), dtype=torch.int8, device=x.device),
            torch.empty((m, k // group_size), dtype=torch.float32,
                        device=x.device))


def rmsnorm_quant_kernel(x, gamma, eps: float,
                         group_size: int) -> tuple:
    """x (M, K) f32 or bf16, gamma (K,) f32 -> (codes (M, K) int8,
    scales (M, K / group_size) f32): RMSNorm (its output rounded to x's
    dtype, as the plain norm returns it) then Q8_0 per group, in one
    pass."""
    if x.device.type == "cpu":
        with flops.paused():
            return ref.ref_rmsnorm_quant(x, gamma, eps, group_size)
    name = "rmsnorm_quant"
    m, k = x.shape
    if gamma.shape != (k,):
        raise ValueError(f"{name}: gamma {tuple(gamma.shape)} for K={k}")
    _check_q8_rows(name, x, group_size, 128)
    _check(name, x.device, gamma=gamma)
    _dtype(name, gamma, torch.float32)
    if gamma.data_ptr() % 16:
        raise ValueError(f"{name}: gamma must be 16-byte aligned")
    q, s = _q8_outputs(x, group_size)
    width, factor = _torch_row_mean_order(m, k)
    plan = rmsnorm_quant_plan(m, k, width, _torch_row_split(m, k))
    if x.device.type == "meta":
        return q, s
    launch(name, x.data_ptr(), gamma.data_ptr(), q.data_ptr(), s.data_ptr(),
           m, k, group_size, eps, factor, *plan, width,
           int(x.dtype == torch.bfloat16), _stream(x))
    return q, s


def quantize_kernel(x, group_size: int) -> tuple:
    """x (M, K) f32 or bf16 -> (codes (M, K) int8, scales (M, K /
    group_size) f32): Q8_0 per group, bitwise ``quantize(x, group_size,
    8)`` -- ``rmsnorm_quant``'s kernel without the norm,
    :func:`quantize_width` threads a row."""
    m, k = x.shape
    if k % group_size:
        raise ValueError(f"quantize: K={k} does not split into groups of "
                         f"{group_size}")
    if x.device.type == "cpu":
        with flops.paused():
            t = quantize(x, group_size=group_size, bits=8)
        return t.q, t.scale
    _check_q8_rows("quantize", x, group_size, group_size)
    q, s = _q8_outputs(x, group_size)
    plan = rmsnorm_quant_plan(m, k, quantize_width(k))
    if x.device.type == "meta":
        return q, s
    launch("quantize", x.data_ptr(), q.data_ptr(), s.data_ptr(), m, k,
           group_size, *plan, int(x.dtype == torch.bfloat16), _stream(x))
    return q, s


# ---------------------------------------------------------------------------
# public wrappers (repro/kernels/ops.py counterparts)
# ---------------------------------------------------------------------------


def q8_matmul(x: torch.Tensor, w: QuantizedTensor) -> torch.Tensor:
    """x (..., K) f32 or bf16 @ w (N, K).T with the paper's integer
    semantics: activations are Q8_0-quantized on the fly with
    ``w.group_size`` (:func:`quantize_kernel`), then
    :func:`q8_matmul_quantized` dispatches."""
    if w.bits not in (4, 8):
        raise ValueError(f"q8_matmul: bits={w.bits}")
    *lead, k = x.shape
    xq, xs = quantize_kernel(x.reshape(-1, k).contiguous(), w.group_size)
    return q8_matmul_quantized(xq, xs, w).reshape(*lead, w.q.shape[0])


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
    """Fused RMSNorm + Q8_0: (..., K) f32 or bf16 -> ((..., K) int8,
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
    """q: (B, H, D) pre-scaled -> (B, H, D) attention over each row's
    dense cache positions < lens[b]; k/v (B, S, KVH, D): computed in f32
    (q widened exactly) and returned in q's dtype, as the reference's
    ``attention_decode`` returns it."""
    b, h, d = q.shape
    kvh = k.shape[2]
    out = decode_attention_kernel(
        q.reshape(b, kvh, h // kvh, d).float().contiguous(), k, v, lens,
        k_scale, v_scale)
    return out.reshape(b, h, d).to(q.dtype)


def flash_prefill(q, k, v, *, causal: bool = True, q_offset=None,
                  q_lens=None, k_lens=None, scale=None) -> torch.Tensor:
    """Full-sequence attention: q (B, Sq, H, D), scaled by ``scale``
    inside (None: D^-1/2, for an unscaled f32 q; a bf16 caller pre-scales
    q in its own dtype, as the reference does, and passes 1.0); k/v
    (B, Sk, KVH, D) -> (B, Sq, H, D) computed in f32 and returned in q's
    dtype.  ``q_offset``, ``q_lens`` and ``k_lens`` ((B,) int32 or None)
    are per-row data, as in the reference; GQA heads are indexed, not
    repeated."""
    out = flash_prefill_kernel(q.contiguous(), k.contiguous(),
                               v.contiguous(), q_offset, q_lens, k_lens,
                               causal, scale)
    return out.to(q.dtype)


def paged_decode_attention(q, k_pool, v_pool, page_table, lens,
                           ks_pool=None, vs_pool=None) -> torch.Tensor:
    """q: (B, H, D) pre-scaled -> (B, H, D) attention over each row's
    pool positions < lens[b], read through ``page_table``: computed in
    f32 (q widened exactly) and returned in q's dtype, as the reference's
    ``attention_decode`` returns it."""
    b, h, d = q.shape
    kvh = k_pool.shape[2]
    out = paged_decode_attention_kernel(
        q.reshape(b, kvh, h // kvh, d).float().contiguous(), k_pool, v_pool,
        page_table, lens, ks_pool, vs_pool)
    return out.reshape(b, h, d).to(q.dtype)


def paged_prefill_attention(q, k_pool, v_pool, page_table, pfx_lens,
                            q_lens=None, ks_pool=None, vs_pool=None):
    """q: (B, C, H, D) pre-scaled (f32, or bf16 widened exactly).
    Returns the prefix segment's flash state in
    ``layers.attention_chunk_merge``'s ``pfx_state`` layout: out
    (B, C, H, D), m (B, H, C, 1), l (B, H, C, 1), all f32, as the
    reference's Pallas kernel returns it."""
    b, c, h, d = q.shape
    kvh = k_pool.shape[2]
    if q_lens is None:
        q_lens = torch.full((b,), c, dtype=torch.int32, device=q.device)
    out, m, l = paged_prefill_attention_kernel(
        q.reshape(b, c, kvh, h // kvh, d).float().contiguous(), k_pool, v_pool,
        page_table, pfx_lens, q_lens, ks_pool, vs_pool)
    m = m.reshape(b, c, h).transpose(1, 2)[..., None]
    l = l.reshape(b, c, h).transpose(1, 2)[..., None]
    return out.reshape(b, c, h, d), m, l
