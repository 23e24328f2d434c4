"""Roofline energy model of one device call on an NVIDIA H100.

PyTorch counterpart of ``step_joules``, ``tree_bytes`` and
``per_device_bytes`` of ``repro/launch/roofline.py``: a call takes the larger of its memory time
and its compute time, and the card burns its power limit for that long.
The engine feeds it each step's bytes (weights, live KV rows) and
operations and accumulates ``metrics["energy_joules"]``; tokens over that
total is the paper's tokens-per-joule, here from the analytic roofline and
not from a power meter.

The constants are the H100 SXM's dense figures from NVIDIA's H100 Tensor
Core GPU data sheet.
"""

from __future__ import annotations

import math

from repro_torch.core.policy import count_bytes
from repro_torch.core.quantization import QuantizedTensor

HBM_BW = 3.35e12          # B/s: HBM3 bandwidth (data sheet)
PEAK_INT8_OPS = 1979e12   # op/s: INT8 tensor core, dense (data sheet)
PEAK_TF32_FLOPS = 495e12  # FLOP/s: TF32 tensor core, dense (data sheet),
#                           kept for reference
H100_POWER_W = 700.0      # W: the SXM's maximum TDP (data sheet), the power
#                           limit nvidia-smi reports on the card


def step_joules(bytes_moved: float, flops: float,
                power_w: float = H100_POWER_W,
                hbm_bw: float = HBM_BW,
                peak_flops: float = PEAK_INT8_OPS) -> float:
    """Roofline energy of one device call: ``max(bytes / hbm_bw, flops /
    peak_flops) * power_w``.  The default compute rate is the int8 one:
    the served products run on int8 codes."""
    t = max(bytes_moved / hbm_bw, flops / peak_flops)
    return t * power_w


def tree_bytes(tree) -> int:
    """Bytes a parameter tree holds: a quantized leaf counts its codes and
    its f32 scales (``policy.count_bytes``'s total)."""
    return count_bytes(tree)["total"]


def per_device_bytes(struct, specs, mesh) -> float:
    """Bytes one device holds of a tree (tensors, meta tensors included)
    given its specs (``distribution/sharding.py``): each leaf's bytes over
    the product of the sizes of the axes that split it; a quantized leaf's
    codes and scales each under their own spec."""
    if isinstance(struct, dict):
        return sum(per_device_bytes(v, specs[k], mesh)
                   for k, v in struct.items())
    if isinstance(struct, (tuple, list)):
        return sum(per_device_bytes(v, s, mesh)
                   for v, s in zip(struct, specs))
    if isinstance(struct, QuantizedTensor):
        return (per_device_bytes(struct.q, specs.q, mesh)
                + per_device_bytes(struct.scale, specs.scale, mesh))
    shards = 1
    for axis in specs:
        for a in (axis if isinstance(axis, tuple) else (axis,)):
            if a is not None:
                shards *= mesh.shape[a]
    return math.prod(struct.shape) * struct.element_size() / shards
