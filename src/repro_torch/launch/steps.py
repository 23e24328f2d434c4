"""Train, prefill and serve steps, and the spec and struct helpers that
place them on a mesh.

PyTorch counterpart of ``repro/launch/steps.py``: the step bodies
(``make_train_step``, ``make_prefill_step``, ``make_serve_step``,
``make_serve_sample_step``), the abstract inputs and trees a cell's specs
are read from (``input_specs``, ``cache_struct``, ``params_struct``: meta
tensors, the counterpart of ``jax.ShapeDtypeStruct``; nothing is drawn or
held), the optimizer's specs (``train_state_specs``, ZeRO-1) and
``pick_microbatches``, and ``jit_train_step``, the train step on a mesh.

The reference's ``jit_*`` wrappers are GSPMD executors: ``jax.jit`` of a
step body with in and out shardings.  Here nothing is compiled and a mesh
is one process a rank (``launch/mesh.py``): ``jit_train_step`` returns a
step that takes the rank's shards of the state and its rows of the batch,
computes its loss and gradients on them (``Model.loss(mesh=, specs=)``:
tensor parallelism over ``model`` for the dense family, the other
families' leaves gathered whole on use), sums the gradients over the data
axes (``reduce_grads``: a reduce-scatter where ZeRO-1 splits the moments)
and updates its shards (``adamw.apply_updates(mesh=)``).  The serve-side
wrappers (``jit_prefill_step``, ``jit_serve_step``,
``jit_serve_sample_step``) have no counterpart yet (ROADMAP); served on a
mesh, the engine runs the bodies itself (``serving/engine.py``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.quantization import QuantizedTensor
from repro_torch.core.tree import leaves, map_tree, unflatten
from repro_torch.distribution import collectives as C
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


def value_and_grad(model: Model, params: Any, batch: Dict[str, Any],
                   mesh=None, specs=None) -> Tuple[torch.Tensor, Any]:
    """(loss, gradients): ``model.loss`` of ``batch`` (detached) and its
    gradient with respect to every leaf of ``params``, a tree shaped as
    ``params`` in each leaf's dtype, zeros for a leaf the loss does not
    read (as ``jax.value_and_grad`` gives).  The leaves are marked to
    require gradients only for the call.  On a train ``mesh`` the rank's
    part of both on its shards of the parameter specs ``specs``
    (``Model.loss(mesh=, specs=)``), before ``reduce_grads``."""
    ws = leaves(params)
    if any(isinstance(w, QuantizedTensor) for w in ws):
        raise TypeError("training needs float parameters: a quantized "
                        "leaf has no gradient")
    for w in ws:
        w.requires_grad_(True)
    try:
        loss = model.loss(params, batch, mesh=mesh, specs=specs)
        gs = torch.autograd.grad(loss, ws, allow_unused=True)
    finally:
        for w in ws:
            w.requires_grad_(False)
    gs = [torch.zeros_like(w) if g is None else g for w, g in zip(ws, gs)]
    return loss.detach(), unflatten(params, gs)


def reduce_grads(cfg: ModelConfig, grads: Any, specs: dict, mesh) -> Any:
    """The rank's gradients summed over the batch axes (the ranks that
    hold other rows of the batch), each leaf in the layout of its moments
    (``specs["opt"]["m"]``): reduce-scattered along the dim ZeRO-1 splits
    over the data axes, all-reduced over the others.  An axis that
    already splits the parameter itself (``ep_data``'s experts) was summed
    by the gather's backward (``sharding.gather_for_grad``)."""
    baxes = sh.batch_axes_for(cfg, mesh, "train")

    def one(g, pspec, ospec):
        own = {a for e in pspec for a in sh.live_axes(e, mesh)}
        todo = [a for a in baxes if mesh.shape[a] > 1 and a not in own]
        z = adamw.zero_dim(pspec, ospec, mesh)
        if z is not None:
            for a in sh.live_axes(z[1], mesh):
                group, n, _ = C.axis(mesh, a)
                g = C.reduce_scatter_dim(g, z[0], group, n)
                todo.remove(a)
        for a in todo:
            group, n, _ = C.axis(mesh, a)
            g = C.all_reduce(g.contiguous(), group, n)
        return g

    return unflatten(grads, [one(g, p, o) for g, p, o in zip(
        leaves(grads), leaves(specs["params"]), leaves(specs["opt"]["m"]))])


def train_grads(model: Model, params: Any, batch: Dict[str, Any],
                microbatches: int = 1, mesh=None,
                specs: Optional[dict] = None) -> Tuple[torch.Tensor, Any]:
    """(loss, gradients) of one train step: with ``microbatches`` k > 1 the
    batch is cut into k sequential slices along its first axis, the
    gradients summed in f32 and divided by k, the loss the mean: one
    microbatch's activations at a time, the same effective batch.  On a
    train ``mesh`` ``params`` are the rank's shards of ``specs["params"]``
    and ``batch`` its rows: the loss is summed over the batch axes and the
    gradients reduced (``reduce_grads``) into the layout of the moments."""
    pspecs = None if specs is None else specs["params"]
    if microbatches == 1:
        loss, grads = value_and_grad(model, params, batch, mesh, pspecs)
    else:
        n = next(iter(batch.values())).shape[0] // microbatches
        grads, loss = None, None
        for i in range(microbatches):
            mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            lo, g = value_and_grad(model, params, mb, mesh, pspecs)
            g = map_tree(lambda x: x.float(), g)
            grads = g if grads is None else map_tree(torch.add, grads, g)
            loss = lo if loss is None else loss + lo
        k = float(microbatches)
        grads = map_tree(lambda g: g / k, grads)
        loss = loss / k
    if mesh is not None:
        grads = reduce_grads(model.cfg, grads, specs, mesh)
        for a in sh.batch_axes_for(model.cfg, mesh, "train"):
            group, n, _ = C.axis(mesh, a)
            C.all_reduce(loss, group, n)
    return loss, grads


def _train_step(model: Model, ocfg: adamw.AdamWConfig, microbatches: int,
                mesh=None, specs: Optional[dict] = None):
    def train_step(state, batch):
        params = state["params"]
        loss, grads = train_grads(model, params, batch, microbatches, mesh,
                                  specs)
        params, opt, metrics, _ = adamw.apply_updates(
            params, state["opt"], grads, ocfg, mesh=mesh, specs=specs)
        metrics["loss"] = loss
        return {"params": params, "opt": opt}, metrics

    return train_step


def make_train_step(model: Model, ocfg: adamw.AdamWConfig,
                    microbatches: int = 1):
    """``train_step(state, batch) -> (state, metrics)``: the loss and its
    gradients (``train_grads``), then one AdamW step
    (``adamw.apply_updates``, in place; no compression error is passed, as
    in the reference, so ``grad_compress_bits`` changes nothing).
    ``metrics``: ``loss``, ``lr``, ``grad_norm`` and ``step``, 0-d
    tensors."""
    return _train_step(model, ocfg, microbatches)


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


def shard_batch(batch: Dict[str, Any], bspecs: Dict[str, Any],
                mesh) -> Dict[str, Any]:
    """The rank's rows of a host batch (numpy arrays or tensors, the
    global batch every rank draws alike) under ``bspecs``
    (``data_specs``), as tensors where they are."""
    return {k: sh.shard(v if isinstance(v, torch.Tensor)
                        else torch.from_numpy(np.ascontiguousarray(v)),
                        bspecs[k], mesh)
            for k, v in batch.items()}


def jit_train_step(model: Model, mesh, ocfg: adamw.AdamWConfig,
                   cell: ShapeCell, zero: bool = True,
                   microbatches: int = 0):
    """The train step on one rank of ``mesh``: the reference's
    ``jit_train_step``, whose name it keeps.  Nothing is compiled (there
    is no ``jax.jit``): the step runs eagerly, each rank on its shards.

    Returns (step, state_struct, batch_struct, (state_specs,
    batch_specs)): ``step(state, batch) -> (state, metrics)`` takes the
    rank's shards of the state under ``state_specs``
    (``train_state_specs``: the train-mode parameter specs, and with
    ``zero`` the moments also split over the data axes) and its rows of
    the batch under ``batch_specs`` (``data_specs``; ``shard_batch``) and
    updates the state in place; the structs are meta tensors of the whole
    state and batch.  ``metrics`` (``loss``, ``lr``, ``grad_norm``,
    ``step``) are the global batch's on every rank: the loss the summed
    cross-entropy over the global token count, the gradient norm each
    element counted once.  ``microbatches`` <= 0 takes
    ``pick_microbatches``.  On a mesh of one every collective is skipped
    and the step is ``make_train_step``'s, bit for bit."""
    cfg = model.cfg
    if microbatches <= 0:
        microbatches = pick_microbatches(cell, mesh, cfg=cfg)
    pstruct = params_struct(model)
    state_struct = {"params": pstruct, "opt": adamw.init_state(pstruct)}
    batch_struct = input_specs(cfg, cell)
    pspecs = sh.param_specs(cfg, pstruct, mesh, mode="train")
    sspecs = train_state_specs(cfg, pspecs, mesh, pstruct, zero=zero)
    bspecs = sh.data_specs(cfg, batch_struct, mesh, mode="train")
    dsz = math.prod(mesh.shape[a]
                    for a in sh.batch_axes_for(cfg, mesh, "train"))
    if cell.global_batch % (dsz * microbatches):
        raise ValueError(f"a global batch of {cell.global_batch} does not "
                         f"split into {microbatches} microbatches over "
                         f"{dsz} data ranks")
    step = _train_step(model, ocfg, microbatches, mesh, sspecs)
    return step, state_struct, batch_struct, (sspecs, bspecs)
