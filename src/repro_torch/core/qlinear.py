"""Quantized linear layers: the paper's integer matmul, three ways.

PyTorch counterpart of ``repro/core/qlinear.py``.  Weights are stored
``(out, in)`` contraction-last; ``qdot(x, w)`` computes ``x @ dequant(w).T``
with one of three strategies of identical math:

``dequant``  weight-only: the codes are dequantized to f32 and multiplied
             with ``torch.matmul`` in full f32 (the process default, as in
             the reference).
``integer``  the paper's arithmetic in plain PyTorch: activations are
             Q8_0-quantized on the fly, each group's int8 products sum
             exactly, and groups combine in f32 in order.
``kernel``   the same arithmetic on the port's CUDA kernels
             (``kernels.ops.q8_matmul``: the Q4 kernel for Q4_0 weights;
             for Q8_0 the GEMV for <= 32 rows, the tiled GEMM above) --
             the counterpart of the reference's ``"pallas"``.

``qdot_many(x, ws)`` is ``qdot`` of one ``x`` against several weights,
quantizing x once under ``kernel``.
``norm_qdot(x, gamma, eps, w)`` is ``qdot`` of the RMS-normed ``x``: under
``kernel``, with a quantized weight, the norm and the activations' Q8_0
quantization run as one ``rmsnorm_quant`` launch (the reference's fused
Pallas kernel), whose codes and scales feed the same dispatch.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.core.quantization import QuantizedTensor, quantize
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ref_q4_matvec, ref_q8_matmul, rms_norm

Weight = Union[torch.Tensor, QuantizedTensor]

STRATEGIES = ("integer", "dequant", "kernel")

# Process-wide default, as in the reference; models read it at call time.
_DEFAULT_STRATEGY = "dequant"


def set_default_strategy(s: str) -> None:
    global _DEFAULT_STRATEGY
    if s not in STRATEGIES:
        raise ValueError(f"strategy must be one of {STRATEGIES}, got {s!r}")
    _DEFAULT_STRATEGY = s


def default_strategy() -> str:
    return _DEFAULT_STRATEGY


def as_float(w: Weight, dtype=torch.float32) -> torch.Tensor:
    """Dequantize if needed -- used by einsum-shaped consumers."""
    if isinstance(w, QuantizedTensor):
        return w.dequantize(dtype)
    return w.to(dtype)


def _qdot_dequant(x: torch.Tensor, w: QuantizedTensor) -> torch.Tensor:
    return torch.matmul(x.float(), as_float(w).T)


def _qdot_integer(x: torch.Tensor, w: QuantizedTensor) -> torch.Tensor:
    """Dynamic Q8_0 activation quantization + one exact partial per group,
    folded into f32 group by group (the reference's ``lax.scan`` order):
    the plain version of the kernels, on any device.  Q4_0 codes are
    unpacked first; activations stay 8-bit."""
    *lead, k = x.shape
    xt = quantize(x.reshape(-1, k), group_size=w.group_size, bits=8)
    fn = ref_q4_matvec if w.bits == 4 else ref_q8_matmul
    out = fn(xt.q, xt.scale, w.q, w.scale, w.group_size)
    return out.reshape(*lead, w.q.shape[0])


def qeinsum(eq: str, x: torch.Tensor, w: Weight) -> torch.Tensor:
    """einsum against a possibly-quantized weight (always dequant), for the
    head-structured attention projections of prefill."""
    if isinstance(w, QuantizedTensor):
        return torch.einsum(eq, x.float(), as_float(w)).to(x.dtype)
    return torch.einsum(eq, x, w.to(x.dtype))


def qdot(x: torch.Tensor, w: Weight,
         strategy: Optional[str] = None) -> torch.Tensor:
    """``x @ w.T`` where ``w`` may be float or quantized."""
    if not isinstance(w, QuantizedTensor):
        return torch.matmul(x, w.to(x.dtype).T)
    s = strategy or _DEFAULT_STRATEGY
    if s == "dequant":
        return _qdot_dequant(x, w)
    if s == "integer":
        return _qdot_integer(x, w)
    if s == "kernel":
        return ops.q8_matmul(x, w)
    raise ValueError(f"unknown strategy {s!r}")


def qdot_many(x: torch.Tensor, ws) -> list:
    """``[qdot(x, w) for w in ws]``.  Under ``kernel``, when the quantized
    weights among ``ws`` share one group size, x is quantized once (one
    ``quantize`` launch) and its codes and scales feed each of their
    products: the codes ``qdot`` would make for each.  Float weights take
    ``qdot``."""
    quantized = [w for w in ws if isinstance(w, QuantizedTensor)]
    if (_DEFAULT_STRATEGY != "kernel" or not quantized
            or len({w.group_size for w in quantized}) != 1):
        return [qdot(x, w) for w in ws]
    *lead, k = x.shape
    xq, xs = ops.quantize_kernel(x.reshape(-1, k).contiguous(),
                                 quantized[0].group_size)
    return [ops.q8_matmul_quantized(xq, xs, w).reshape(*lead, w.q.shape[0])
            if isinstance(w, QuantizedTensor) else qdot(x, w) for w in ws]


def norm_qdot(x: torch.Tensor, gamma: torch.Tensor, eps: float,
              w: Weight) -> torch.Tensor:
    """``qdot(rms_norm(x, gamma, eps), w)``.  Under ``kernel`` with a
    quantized weight and f32 or bf16 activations the norm and the
    quantization of its output are one ``ops.rmsnorm_quant`` launch
    feeding ``ops.q8_matmul_quantized``; the codes and scales are those
    the unfused pair computes (a bf16 norm rounds its output to bf16
    before the quantization, as ``rms_norm`` returns it)."""
    if (_DEFAULT_STRATEGY != "kernel" or not isinstance(w, QuantizedTensor)
            or x.dtype not in (torch.float32, torch.bfloat16)):
        return qdot(rms_norm(x, gamma, eps), w)
    *lead, k = x.shape
    if k % w.group_size:
        raise ValueError(f"norm_qdot: K={k} does not split into groups of "
                         f"{w.group_size}")
    xq, xs = ops.rmsnorm_quant(x.reshape(-1, k), gamma, eps, w.group_size)
    return ops.q8_matmul_quantized(xq, xs, w).reshape(*lead, w.q.shape[0])
