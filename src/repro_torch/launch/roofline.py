"""Roofline model of a step on an NVIDIA H100: its energy, and the three
terms of a dry-run cell.

PyTorch counterpart of ``repro/launch/roofline.py``.  ``step_joules``: a
call takes the larger of its memory time and its compute time, and the
card burns its power limit for that long.  The engine feeds it each
step's bytes (weights, live KV rows) and operations and accumulates
``metrics["energy_joules"]``; tokens over that total is the paper's
tokens-per-joule, here from the analytic roofline and not from a power
meter.

``analytic_bytes`` and ``assemble`` give a dry-run cell's three terms
(``launch/dryrun.py``), with the reference's formulas term for term:

  compute term    algorithmic operations (``launch/flops.py``) over the
                  devices, divided by the bf16 peak.
  memory term     the analytic per-device HBM traffic below, divided by
                  the HBM bandwidth.
  collective term per-device wire bytes of the step's collective tally
                  (``launch/collective_cost.py``), divided by one card's
                  NVLink bandwidth: a lower bound, as if every group lay
                  on one NVLink domain.  A group that spans hosts (the
                  model axis of 16 on 8-card hosts) crosses the hosts'
                  network, which is slower, so the term is NVLink's lower
                  bound, not a prediction.

Analytic HBM traffic (per device, per step):

  train    opt update reads p,m,v and writes p,m,v (6·P·4B) + fwd reads
           P once per microbatch + bwd reads P (transposes) + remat
           re-reads P + grad write/read (2·P·4B)
           + activations: ~6 passes over the per-layer residual stream
           (write fwd, read/write remat, read bwd) × L layers.
  prefill  weight bytes (int8 + scales) + KV-cache write + ~4 activation
           passes per layer.
  decode   weight bytes + KV-cache read (+ write of 1 token) + O(B·D)
           activations.

The constants are the H100 SXM's dense figures from NVIDIA's H100 Tensor
Core GPU data sheet: estimates at those figures, not measurements.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.core.policy import count_bytes
from repro_torch.core.quantization import QuantizedTensor

HBM_BW = 3.35e12          # B/s: HBM3 bandwidth (data sheet)
PEAK_INT8_OPS = 1979e12   # op/s: INT8 tensor core, dense (data sheet)
PEAK_TF32_FLOPS = 495e12  # FLOP/s: TF32 tensor core, dense (data sheet),
#                           kept for reference
PEAK_BF16_FLOPS = 989e12  # FLOP/s: BF16 tensor core, dense (data sheet)
NVLINK_BW = 450e9         # B/s: NVLink, each way (900 GB/s total, data sheet)
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


def analytic_bytes(cfg: ModelConfig, cell: ShapeCell, n_dev: int,
                   param_bytes_global: int, cache_bytes_global: int = 0,
                   microbatches: int = 1,
                   param_bytes_per_dev: float = 0.0,
                   model_shards: int = 16) -> Dict[str, float]:
    """Per-device HBM traffic estimate (see module docstring): the
    reference's formulas, term for term.  ``model_shards`` is the model
    axis, 16 on both production meshes as the reference fixes it (a
    world of one passes 1)."""
    p_dev = param_bytes_per_dev or \
        param_bytes_global / model_shards  # params replicated over data
    b_loc = max(cell.global_batch // (n_dev // model_shards), 1)
    act_elem = 2                           # bf16 residual stream

    if cell.kind == "train":
        opt_traffic = 6 * (param_bytes_global / model_shards / 4)
        w_traffic = (2 * microbatches + 3) * p_dev
        layers = max(cfg.n_layers, 1)
        act = 6 * layers * b_loc * cell.seq_len * cfg.d_model * act_elem
        total = w_traffic + opt_traffic + act
        return {"weights": w_traffic, "opt": opt_traffic, "acts": act,
                "total": total}

    if cell.kind == "prefill":
        layers = max(cfg.n_layers, 1)
        act = 4 * layers * b_loc * cell.seq_len * cfg.d_model * act_elem
        cache_w = cache_bytes_global / n_dev
        total = p_dev + act + cache_w
        return {"weights": p_dev, "acts": act, "cache": cache_w,
                "total": total}

    cache_r = cache_bytes_global / n_dev
    act = 8 * cfg.n_layers * b_loc * cfg.d_model * 4
    total = p_dev + cache_r + act
    return {"weights": p_dev, "cache": cache_r, "acts": act, "total": total}


def assemble(cfg: ModelConfig, cell: ShapeCell, n_dev: int,
             algo_flops_global: float, model_flops_global: float,
             mem: Dict[str, float], coll_bytes_dev: float,
             raw_cost: Dict[str, Any],
             flops_dev_executed: Optional[float] = None) -> Dict[str, Any]:
    """The cell's record: the reference's keys and definitions, at the
    card's constants (``PEAK_BF16_FLOPS``, ``HBM_BW``, ``NVLINK_BW``).
    Two keys besides: ``flops_dev_executed``, the operations one rank's
    own trace counted, and ``t_compute_executed_s``, that count over the
    peak.  The port's serve executors compute replicated over ``model``
    (``launch/steps.py``), so a rank executes more than the reference's
    ``algo_flops_global / n_dev``; ``dominant`` and ``roofline_fraction``
    keep the reference's definitions all the same."""
    flops_dev = algo_flops_global / n_dev
    t_compute = flops_dev / PEAK_BF16_FLOPS
    t_memory = mem["total"] / HBM_BW
    t_coll = coll_bytes_dev / NVLINK_BW
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    step_time = max(terms.values())
    ideal = (model_flops_global / n_dev) / PEAK_BF16_FLOPS
    rec = {
        "arch": cfg.arch_id, "shape": cell.name, "devices": n_dev,
        "bw_fraction": t_memory / step_time if step_time else 0.0,
        "algo_flops_global": algo_flops_global,
        "model_flops_global": model_flops_global,
        "useful_flop_ratio": model_flops_global / algo_flops_global
        if algo_flops_global else 0.0,
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_coll, "dominant": dominant,
        "est_step_time_s": step_time,
        "roofline_fraction": ideal / step_time if step_time else 0.0,
        "mem_breakdown": mem,
        "collective_bytes_dev": coll_bytes_dev,
        "raw_cost_analysis": raw_cost,
    }
    if flops_dev_executed is not None:
        rec["flops_dev_executed"] = flops_dev_executed
        rec["t_compute_executed_s"] = flops_dev_executed / PEAK_BF16_FLOPS
    return rec
