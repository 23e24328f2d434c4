"""Train, prefill and serve steps, and the spec and struct helpers that
place them on a mesh.

PyTorch counterpart of ``repro/launch/steps.py``: the step bodies
(``make_train_step``, ``make_prefill_step``, ``make_serve_step``,
``make_serve_sample_step``), the abstract inputs and trees a cell's specs
are read from (``input_specs``, ``cache_struct``, ``params_struct``: meta
tensors, the counterpart of ``jax.ShapeDtypeStruct``; nothing is drawn or
held), the optimizer's specs (``train_state_specs``, ZeRO-1) and
``pick_microbatches``.  The reference's ``jit_*`` wrappers (GSPMD
executors of these bodies over a mesh) have no counterpart yet (ROADMAP);
served on a mesh, the engine runs the bodies itself
(``serving/engine.py``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.quantization import QuantizedTensor
from repro_torch.core.tree import leaves, map_tree, unflatten
from repro_torch.distribution import sharding as sh
from repro_torch.models.model import Model
from repro_torch.optim import adamw


# ---------------------------------------------------------------------------
# input specs (meta tensors -- never allocated)
# ---------------------------------------------------------------------------


def _meta(shape, dtype=torch.float32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, cell: ShapeCell) -> Dict[str, Any]:
    """Abstract input batch for one shape cell, as meta tensors.

    train:   token/label batch (or stub embeds for vlm/audio frontends).
    prefill: prompt batch of seq_len.
    decode:  one token per sequence (the cache is ``cache_struct``'s)."""
    b, s = cell.global_batch, cell.seq_len
    i32 = torch.int32
    if cell.kind == "train":
        if cfg.family == "vlm":
            return {"embeds": _meta((b, s, cfg.d_model)),
                    "labels": _meta((b, s), i32)}
        if cfg.family == "audio":
            return {"frames": _meta((b, cfg.enc_seq, cfg.d_model)),
                    "tokens": _meta((b, s), i32),
                    "labels": _meta((b, s), i32)}
        return {"tokens": _meta((b, s), i32), "labels": _meta((b, s), i32)}
    if cell.kind == "prefill":
        if cfg.family == "vlm":
            return {"embeds": _meta((b, s, cfg.d_model))}
        if cfg.family == "audio":
            return {"frames": _meta((b, cfg.enc_seq, cfg.d_model)),
                    "tokens": _meta((b, s), i32)}
        return {"tokens": _meta((b, s), i32)}
    return {"tokens": _meta((b,), i32)}


def cache_struct(model: Model, cell: ShapeCell):
    """The dense decode cache of one cell, on the meta device."""
    return model.init_cache(cell.global_batch, cell.seq_len, device="meta")


def params_struct(model: Model, quantized: bool = False,
                  policy: Optional[QuantPolicy] = None):
    """The parameter tree on the meta device; ``quantized``: after
    ``Model.quantize`` (the fused decode operands included)."""
    ps = model.init_meta()
    if quantized:
        ps = model.quantize(ps, policy)
    return ps


def value_and_grad(model: Model, params: Any,
                   batch: Dict[str, Any]) -> Tuple[torch.Tensor, Any]:
    """(loss, gradients): ``model.loss`` of ``batch`` (detached) and its
    gradient with respect to every leaf of ``params``, a tree shaped as
    ``params`` in each leaf's dtype, zeros for a leaf the loss does not
    read (as ``jax.value_and_grad`` gives).  The leaves are marked to
    require gradients only for the call."""
    ws = leaves(params)
    if any(isinstance(w, QuantizedTensor) for w in ws):
        raise TypeError("training needs float parameters: a quantized "
                        "leaf has no gradient")
    for w in ws:
        w.requires_grad_(True)
    try:
        loss = model.loss(params, batch)
        gs = torch.autograd.grad(loss, ws, allow_unused=True)
    finally:
        for w in ws:
            w.requires_grad_(False)
    gs = [torch.zeros_like(w) if g is None else g for w, g in zip(ws, gs)]
    return loss.detach(), unflatten(params, gs)


def make_train_step(model: Model, ocfg: adamw.AdamWConfig,
                    microbatches: int = 1):
    """``train_step(state, batch) -> (state, metrics)``: the loss and its
    gradients, then one AdamW step (``adamw.apply_updates``, in place; no
    compression error is passed, as in the reference, so
    ``grad_compress_bits`` changes nothing).  With ``microbatches`` k > 1
    the batch is cut into k sequential slices along its first axis, the
    gradients summed in f32 and divided by k, the loss the mean: one
    microbatch's activations at a time, the same effective batch.
    ``metrics``: ``loss``, ``lr``, ``grad_norm`` and ``step``, 0-d
    tensors."""

    def train_step(state, batch):
        params = state["params"]
        if microbatches == 1:
            loss, grads = value_and_grad(model, params, batch)
        else:
            n = next(iter(batch.values())).shape[0] // microbatches
            grads, loss = None, None
            for i in range(microbatches):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                lo, g = value_and_grad(model, params, mb)
                g = map_tree(lambda x: x.float(), g)
                grads = g if grads is None else map_tree(torch.add, grads, g)
                loss = lo if loss is None else loss + lo
            k = float(microbatches)
            grads = map_tree(lambda g: g / k, grads)
            loss = loss / k
        params, opt, metrics, _ = adamw.apply_updates(
            params, state["opt"], grads, ocfg)
        metrics["loss"] = loss
        return {"params": params, "opt": opt}, metrics

    return train_step


def make_prefill_step(model: Model, max_seq: int):
    def prefill_step(params, batch):
        return model.prefill(params, batch, max_seq=max_seq)
    return prefill_step


def make_serve_step(model: Model):
    def serve_step(params, cache, tokens):
        return model.decode_step(params, cache, tokens)
    return serve_step


def make_serve_sample_step(model: Model, temperature: float = 1.0):
    """Decode, then communication-avoiding sampling: the Gumbel-max draw
    of ``serving/sampling_distributed.py``, which a vocab-sharded head
    reduces to a winner exchange."""
    from repro_torch.serving.sampling_distributed import gumbel_argmax

    def serve_sample_step(params, cache, tokens, key):
        logits, cache = model.decode_step(params, cache, tokens)
        return gumbel_argmax(key, logits, temperature), cache

    return serve_sample_step


# ---------------------------------------------------------------------------
# optimizer-state specs and the microbatch count
# ---------------------------------------------------------------------------


def train_state_specs(cfg: ModelConfig, pspecs, mesh, pstruct,
                      zero: bool = True):
    """Optimizer m/v inherit param specs; with ``zero`` the *data* axes
    additionally shard the first unsharded, divisible dim of every large
    state tensor (ZeRO-1: Adam moments are never replicated across data
    parallel replicas)."""
    if not zero:
        return {"params": pspecs, "opt": {"m": pspecs, "v": pspecs,
                                          "step": ()}}
    dp_all = sh.batch_axes_for(cfg, mesh, "train")
    dp = dp_all if len(dp_all) > 1 else dp_all[0]
    dsz = math.prod(mesh.shape[a] for a in dp_all)
    dp_set = set(dp_all)

    def zero_one(spec, leaf):
        if not isinstance(spec, tuple):
            return spec
        shape = tuple(leaf.shape)
        parts = list(spec) + [None] * (len(shape) - len(spec))
        if math.prod(shape) < (1 << 20):          # skip small tensors
            return spec
        used = set()
        for axis in parts:
            for a in (axis if isinstance(axis, tuple) else (axis,)):
                if a is not None:
                    used.add(a)
        if used & dp_set:
            return spec       # data axes already shard this tensor (EP-data)
        for i, axis in enumerate(parts):
            if axis is None and shape[i] % dsz == 0 and shape[i] >= dsz:
                parts[i] = dp
                return tuple(parts)
        return spec

    def walk(spec, leaf):
        if isinstance(spec, dict):
            return {k: walk(v, leaf[k]) for k, v in spec.items()}
        return zero_one(spec, leaf)

    zspecs = walk(pspecs, pstruct)
    return {"params": pspecs, "opt": {"m": zspecs, "v": zspecs, "step": ()}}


def pick_microbatches(cell: ShapeCell, mesh, target_rows_per_dev: int = 2,
                      cfg=None) -> int:
    """Largest k such that the batch splits evenly and each microbatch puts
    ~target rows on each data shard."""
    if cfg is not None and cfg.train_shard == "dp":
        dsz = math.prod(mesh.shape[a] for a in mesh.axis_names)
    else:
        dsz = sh._dp_size(mesh)
    rows_per_dev = max(cell.global_batch // dsz, 1)
    k = max(rows_per_dev // target_rows_per_dev, 1)
    while cell.global_batch % (k * dsz) and k > 1:
        k -= 1
    return k
