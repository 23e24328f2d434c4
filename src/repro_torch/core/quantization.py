"""Q8_0 / Q4_0 symmetric per-group quantization (HLSTransform, section 3.2).

PyTorch counterpart of ``repro/core/quantization.py``.  Each group ``w`` of
``group_size`` values along the last axis maps to

    q = round(qmax * w / ||w||_inf)       (int8; qmax = 127, or 7 for Q4_0)
    scale = ||w||_inf / qmax              (f32)

computed exactly as the reference does -- multiply by ``qmax / absmax``
(never divide by the scale), round half to even, and an all-zero group
gives code 0 and scale 0 -- so codes and scales are bitwise equal to the
JAX package's.  The reference's compiled ``absmax / qmax`` is a multiply by
the f32 reciprocal of ``qmax`` (XLA's rewrite of a division by a constant),
so the port multiplies by that reciprocal too.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

DEFAULT_GROUP_SIZE = 64  # the paper's burst width: 64 int8 per cycle over AXI4


def choose_group_size(dim: int, preferred: int = DEFAULT_GROUP_SIZE) -> int:
    """Largest divisor of ``dim`` that is <= ``preferred``."""
    if dim <= 0:
        raise ValueError(f"dim must be positive, got {dim}")
    g = min(preferred, dim)
    while dim % g != 0:
        g -= 1
    return g


@dataclasses.dataclass
class QuantizedTensor:
    """A symmetric per-group quantized tensor, grouped along the last axis.

    bits=8: q (*lead, K) int8, scale (*lead, K // group) f32.
    bits=4: q (*lead, K // 2) int8 holding two codes per byte (low nibble =
    even index), scale (*lead, K // group) f32.
    """

    q: torch.Tensor
    scale: torch.Tensor
    group_size: int
    bits: int = 8
    orig_dim: int = -1  # unpacked size of the last axis

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return dequantize(self, dtype=dtype)

    def to(self, device) -> "QuantizedTensor":
        return dataclasses.replace(self, q=self.q.to(device),
                                   scale=self.scale.to(device))


def tree_differs(got, want, path: str = "") -> list:
    """The paths at which two parameter trees differ: keys, type, dtype,
    shape, or a bit of a float leaf or of a quantized leaf's codes or
    scales.  Empty when they are bitwise the same."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            return [path or "/"]
        return [p for k in want
                for p in tree_differs(got[k], want[k], f"{path}/{k}")]
    if type(got) is not type(want):
        return [path]
    pairs = ([(got.q, want.q), (got.scale, want.scale)]
             if isinstance(want, QuantizedTensor) else [(got, want)])
    same = all(a.dtype == b.dtype and torch.equal(a, b) for a, b in pairs)
    if isinstance(want, QuantizedTensor):
        same = same and (got.group_size, got.bits, got.orig_dim) == (
            want.group_size, want.bits, want.orig_dim)
    return [] if same else [path]


def _ratio(qmax: int, absmax: torch.Tensor) -> torch.Tensor:
    """``qmax / absmax`` as a true f32 division (``scalar / tensor`` in
    PyTorch multiplies by the reciprocal, which rounds differently), 0
    where the group is all zero."""
    r = torch.div(torch.full_like(absmax, float(qmax)), absmax)
    return torch.where(absmax > 0, r, torch.zeros_like(absmax))


# f32 reciprocal of each code range, rounded once as XLA's folded constant
# is; a Python float holding an f32 value, so multiplying by it needs no
# host-to-device copy
_INV_QMAX = {q: float(np.float32(1.0) / np.float32(q)) for q in (127, 7)}


def _qmax(bits: int) -> int:
    if bits == 8:
        return 127
    if bits == 4:
        return 7
    raise ValueError(f"unsupported bits={bits}")


def _pack_nibbles(q: torch.Tensor) -> torch.Tensor:
    """Pack int8 values in [-8, 7] pairwise along the last axis."""
    lo = q[..., 0::2]
    hi = q[..., 1::2]
    return ((hi << 4) | (lo & 0x0F)).to(torch.int8)


def _unpack_nibbles(p: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_pack_nibbles`; sign-extends each nibble."""
    lo = (p << 4).to(torch.int8) >> 4          # arithmetic shift sign-extends
    hi = p.to(torch.int8) >> 4
    out = torch.stack([lo, hi], dim=-1)
    return out.reshape(*p.shape[:-1], p.shape[-1] * 2)


def _quantize_impl(x: torch.Tensor, group_size: int, bits: int):
    qmax = _qmax(bits)
    *lead, k = x.shape
    g = k // group_size
    xg = x.reshape(*lead, g, group_size).float()
    absmax = torch.amax(torch.abs(xg), dim=-1, keepdim=True)
    scale = absmax * _INV_QMAX[qmax]
    q = torch.clamp(torch.round(xg * _ratio(qmax, absmax)), -qmax, qmax)
    q = q.to(torch.int8)
    q = q.reshape(*lead, k)
    scale = scale.reshape(*lead, g)
    if bits == 4:
        q = _pack_nibbles(q)
    return q, scale


def quantize(x: torch.Tensor, group_size: int = DEFAULT_GROUP_SIZE,
             bits: int = 8) -> QuantizedTensor:
    """Symmetric per-group quantization along the last axis (Q8_0 / Q4_0)."""
    k = x.shape[-1]
    group_size = choose_group_size(k, group_size)
    if bits == 4 and (group_size % 2 != 0 or k % 2 != 0):
        raise ValueError("Q4_0 packing needs an even grouped axis")
    q, scale = _quantize_impl(x, group_size, bits)
    return QuantizedTensor(q=q, scale=scale, group_size=group_size, bits=bits,
                           orig_dim=k)


def quantize_rows(vec: torch.Tensor):
    """Q8_0 with one group per whole vector: (..., hd) -> int8 codes
    (..., hd) + f32 scale (...,).  The KV-pool quantizer."""
    absmax = torch.amax(torch.abs(vec.float()), dim=-1, keepdim=True)
    q = torch.clamp(torch.round(vec * _ratio(127, absmax)), -127, 127)
    q = q.to(torch.int8)
    return q, absmax[..., 0] * _INV_QMAX[127]


def dequantize(t: QuantizedTensor, dtype=torch.float32) -> torch.Tensor:
    """codes * scale in f32, then cast to ``dtype``.  The product is taken
    in place on the f32 copy of the codes: the same f32 multiply of the
    same values as ``q.float() * scale``, with one f32 copy of the tensor
    held instead of two (an expert bank of llama4-maverick-400b-a17b is
    21.5 GB of f32)."""
    q = _unpack_nibbles(t.q) if t.bits == 4 else t.q
    *lead, k = q.shape
    g = k // t.group_size
    out = q.reshape(*lead, g, t.group_size).float()
    out.mul_(t.scale[..., None])
    return out.reshape(*lead, k).to(dtype)


def quantize_q8_0(x: torch.Tensor,
                  group_size: int = DEFAULT_GROUP_SIZE) -> QuantizedTensor:
    return quantize(x, group_size=group_size, bits=8)


def quantize_q4_0(x: torch.Tensor,
                  group_size: int = DEFAULT_GROUP_SIZE) -> QuantizedTensor:
    return quantize(x, group_size=group_size, bits=4)


def qmatmul_ref(x: QuantizedTensor, w: QuantizedTensor) -> torch.Tensor:
    """``dequant(x) @ dequant(w)`` the integer way, as the reference's
    oracle: x (*batch, K) and w (N, K), both grouped along K; int8 x int8
    products summed in int32 within a group, each group's sum times
    ``xs[g] * ws[n, g]`` in f32, then summed in f32 across groups.
    Returns f32 (*batch, N)."""
    if x.group_size != w.group_size:
        raise ValueError(f"group size mismatch {x.group_size} vs "
                         f"{w.group_size}")
    gs = x.group_size
    xq = _unpack_nibbles(x.q) if x.bits == 4 else x.q
    wq = _unpack_nibbles(w.q) if w.bits == 4 else w.q
    *bx, k = xq.shape
    n, kw = wq.shape
    if k != kw:
        raise ValueError(f"contraction mismatch {k} vs {kw}")
    g = k // gs
    xg = xq.reshape(*bx, g, gs).double()
    wg = wq.reshape(n, g, gs).double()
    # the int32 partial of each (batch, n, group), exact in f64 (integers
    # below 2^53; PyTorch has no integer matmul on the card)
    part = torch.einsum("...gk,ngk->...ng", xg, wg).float()
    scaled = part * x.scale[..., None, :] * w.scale
    return scaled.sum(-1)


def quantization_error(x: torch.Tensor, group_size: int = DEFAULT_GROUP_SIZE,
                       bits: int = 8) -> torch.Tensor:
    """Max-abs round-trip error of ``quantize`` then ``dequantize``."""
    t = quantize(x, group_size=group_size, bits=bits)
    return (t.dequantize() - x).abs().max()


# ---------------------------------------------------------------------------
# Structural ops: reshape / concat quantized tensors without requantizing.
# Groups tile the last axis contiguously, so any reshape that leaves it alone,
# or folds whole leading axes into it, keeps every (code, scale) pairing.
# ---------------------------------------------------------------------------


def qt_reshape_lead(t: QuantizedTensor, *new_lead: int) -> QuantizedTensor:
    """Reshape the leading (non-grouped) axes."""
    return dataclasses.replace(
        t, q=t.q.reshape(*new_lead, t.q.shape[-1]),
        scale=t.scale.reshape(*new_lead, t.scale.shape[-1]))


def qt_fold_lead_into_groups(t: QuantizedTensor) -> QuantizedTensor:
    """(*lead, A, K) -> (*lead, A*K): the innermost leading axis folds into
    the grouped axis, whose groups then tile A*K with the same scales."""
    *lead, a, kq = t.q.shape
    g = t.scale.shape[-1]
    return dataclasses.replace(
        t, q=t.q.reshape(*lead, a * kq), scale=t.scale.reshape(*lead, a * g),
        orig_dim=a * t.orig_dim)


def qt_concat(ts, axis: int) -> QuantizedTensor:
    """Concatenate quantized tensors along a leading (non-grouped) axis."""
    t0 = ts[0]
    if any(t.group_size != t0.group_size or t.bits != t0.bits
           or t.orig_dim != t0.orig_dim for t in ts[1:]):
        raise ValueError("qt_concat needs matching group/bits/orig_dim")
    ax = axis % t0.q.ndim
    if ax == t0.q.ndim - 1:
        raise ValueError("cannot concat along the grouped axis")
    return dataclasses.replace(
        t0, q=torch.cat([t.q for t in ts], dim=ax),
        scale=torch.cat([t.scale for t in ts], dim=ax))
