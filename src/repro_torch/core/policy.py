"""Quantization policy: which parameters get quantized (paper section 3.2).

PyTorch counterpart of ``repro/core/policy.py``: every large matmul operand
is quantized, every norm / bias / small-state parameter stays in float.  The
rules match parameter paths ("blocks/attn/wq"), so the models need not know
about quantization.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any

import torch

from repro_torch.core.quantization import (DEFAULT_GROUP_SIZE,
                                           QuantizedTensor, quantize)

# Path fragments that must never be quantized.
_FLOAT_PATTERNS = (
    r"norm",          # rms / layer norms (paper-mandated fp32)
    r"\bbias\b",
    r"rope",          # rotary tables
    r"pos",           # learned positional tables
    r"wdt",           # SSM dt projection
    r"conv",          # short convolutions and frontend stubs
    r"A_log", r"\bdt", r"ssm_dt", r"dt_bias",   # SSM dynamics params
    r"D_skip",
    r"router",        # MoE router: tiny and precision-sensitive
    r"gamma", r"beta",
)
_FLOAT_RE = re.compile("|".join(_FLOAT_PATTERNS))


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """What to quantize and how (paper defaults: Q8_0, groups of 64)."""

    bits: int = 8
    group_size: int = DEFAULT_GROUP_SIZE
    min_size: int = 4096          # don't quantize tensors smaller than this
    quantize_embedding: bool = True   # the paper quantizes the embedding

    def wants(self, path: str, shape: tuple) -> bool:
        if _FLOAT_RE.search(path):
            return False
        if not self.quantize_embedding and "embed" in path:
            return False
        n = 1
        for d in shape:
            n *= d
        if n < self.min_size:
            return False
        return len(shape) >= 2  # only matmul operands


PAPER_POLICY = QuantPolicy()


def quantize_params(params: Any, policy: QuantPolicy = PAPER_POLICY,
                    path: str = "") -> Any:
    """Post-training quantization of a nested dict of parameters."""
    if isinstance(params, dict):
        return {k: quantize_params(v, policy, f"{path}/{k}" if path else k)
                for k, v in params.items()}
    if isinstance(params, torch.Tensor) and policy.wants(
            path, tuple(params.shape)):
        return quantize(params, group_size=policy.group_size,
                        bits=policy.bits)
    return params


def count_bytes(params: Any) -> dict:
    """Bytes of a parameter tree by storage class: ``quantized`` (each
    quantized leaf's codes and f32 scales), ``float`` (every other tensor)
    and their ``total``, as the reference counts them."""
    tally = {"quantized": 0, "float": 0}

    def visit(leaf):
        if isinstance(leaf, dict):
            for v in leaf.values():
                visit(v)
        elif isinstance(leaf, (list, tuple)):
            for v in leaf:
                visit(v)
        elif isinstance(leaf, QuantizedTensor):
            tally["quantized"] += (leaf.q.numel() * leaf.q.element_size()
                                   + leaf.scale.numel() * 4)
        elif isinstance(leaf, torch.Tensor):
            tally["float"] += leaf.numel() * leaf.element_size()

    visit(params)
    tally["total"] = tally["quantized"] + tally["float"]
    return tally
