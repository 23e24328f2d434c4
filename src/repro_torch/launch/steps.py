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
tensor parallelism over ``model`` for the dense, vlm and MoE families,
the MoE's experts in expert parallelism, the other families' leaves
gathered whole on use), sums the gradients over the axes the batch
really splits (those of ``data_specs``' batch spec; ``reduce_grads``: a
reduce-scatter where ZeRO-1 splits the moments) and updates its shards
(``adamw.apply_updates(mesh=)``).

The serve-side wrappers (``jit_prefill_step``, ``jit_serve_step``,
``jit_serve_sample_step``) keep the reference's names, arguments and
returns; their specs are ``serve_specs``'s, which callers shard their
inputs with (``sharding.shard``).  Each step takes the rank's weight
shards, its part of the dense cache and its rows, and runs the model
storage-sharded and compute-replicated over ``model``
(``transformer._ServeMesh``): the weights gathered on use, the rank's rows
computed whole, its part of the cache written; rows over the data axes
are plain data parallelism, with no collective.  It returns the rank's
``(B@data, V@model)`` slice of the logits (or its rows' tokens) and its
part of the cache, each bit for bit the unsharded step's.  The engine
serves its paged pool on a mesh itself (``serving/engine.py``).
"""

from __future__ import annotations

import dataclasses
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
                   mesh=None, specs=None, batch_axes=None
                   ) -> Tuple[torch.Tensor, Any]:
    """(loss, gradients): ``model.loss`` of ``batch`` (detached) and its
    gradient with respect to every leaf of ``params``, a tree shaped as
    ``params`` in each leaf's dtype, zeros for a leaf the loss does not
    read (as ``jax.value_and_grad`` gives).  The leaves are marked to
    require gradients only for the call.  On a train ``mesh`` the rank's
    part of both on its shards of the parameter specs ``specs`` and its
    rows, split over ``batch_axes`` (``Model.loss(mesh=, specs=,
    batch_axes=)``), before ``reduce_grads``."""
    ws = leaves(params)
    if any(isinstance(w, QuantizedTensor) for w in ws):
        raise TypeError("training needs float parameters: a quantized "
                        "leaf has no gradient")
    for w in ws:
        w.requires_grad_(True)
    try:
        loss = model.loss(params, batch, mesh=mesh, specs=specs,
                          batch_axes=batch_axes)
        gs = torch.autograd.grad(loss, ws, allow_unused=True)
    finally:
        for w in ws:
            w.requires_grad_(False)
    gs = [torch.zeros_like(w) if g is None else g for w, g in zip(ws, gs)]
    return loss.detach(), unflatten(params, gs)


def reduce_grads(cfg: ModelConfig, grads: Any, specs: dict, mesh,
                 batch_axes: tuple) -> Any:
    """The rank's gradients summed over the batch axes (the ranks that
    hold other rows of the batch: ``batch_axes``, the axes the batch
    spec splits), each leaf in the
    layout of its moments (``specs["opt"]["m"]``): reduce-scattered along
    the dim ZeRO-1 splits over the data axes, all-reduced over the others.
    An axis that already splits the parameter itself is not summed: an
    ``ep_data`` expert's gradient is whole on the rank that holds the
    expert (its forward took every row's slots there)."""
    def one(g, pspec, ospec):
        own = {a for e in pspec for a in sh.live_axes(e, mesh)}
        todo = [a for a in batch_axes if mesh.shape[a] > 1 and a not in own]
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
                specs: Optional[dict] = None,
                batch_axes=None) -> Tuple[torch.Tensor, Any]:
    """(loss, gradients) of one train step: with ``microbatches`` k > 1 the
    batch is cut into k sequential slices along its first axis, the
    gradients summed in f32 and divided by k, the loss the mean: one
    microbatch's activations at a time, the same effective batch.  On a
    train ``mesh`` ``params`` are the rank's shards of ``specs["params"]``
    and ``batch`` its rows: the loss is summed over the batch axes
    (``batch_axes``, the axes the batch spec splits, which a mesh needs;
    ``jit_train_step`` passes them) and the gradients reduced
    (``reduce_grads``) into the layout of the moments."""
    pspecs = None if specs is None else specs["params"]
    if microbatches == 1:
        loss, grads = value_and_grad(model, params, batch, mesh, pspecs,
                                     batch_axes)
    else:
        n = next(iter(batch.values())).shape[0] // microbatches
        grads, loss = None, None
        for i in range(microbatches):
            mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            lo, g = value_and_grad(model, params, mb, mesh, pspecs,
                                   batch_axes)
            g = map_tree(lambda x: x.float(), g)
            grads = g if grads is None else map_tree(torch.add, grads, g)
            loss = lo if loss is None else loss + lo
        k = float(microbatches)
        grads = map_tree(lambda g: g / k, grads)
        loss = loss / k
    if mesh is not None:
        grads = reduce_grads(model.cfg, grads, specs, mesh, batch_axes)
        for a in batch_axes:
            group, n, _ = C.axis(mesh, a)
            C.all_reduce(loss, group, n)
    return loss, grads


def _train_step(model: Model, ocfg: adamw.AdamWConfig, microbatches: int,
                mesh=None, specs: Optional[dict] = None, batch_axes=None):
    def train_step(state, batch):
        params = state["params"]
        loss, grads = train_grads(model, params, batch, microbatches, mesh,
                                  specs, batch_axes)
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
                      zero: bool = True, batch_axes=None):
    """Optimizer m/v inherit param specs; with ``zero`` the *data* axes
    additionally shard the first unsharded, divisible dim of every large
    state tensor (ZeRO-1: Adam moments are never replicated across data
    parallel replicas).  The data axes are ``batch_axes``, the axes the
    batch spec splits (``jit_train_step`` passes them; a moment split over
    an axis whose ranks compute the same rows would sum their gradients
    twice), ``sharding.batch_axes_for``'s by default, as the reference
    takes them."""
    dp_all = (sh.batch_axes_for(cfg, mesh, "train") if batch_axes is None
              else tuple(batch_axes))
    if not zero or not dp_all:
        return {"params": pspecs, "opt": {"m": pspecs, "v": pspecs,
                                          "step": ()}}
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
    the batch under ``batch_specs`` (``data_specs``; ``shard_batch``;
    the axes of its batch spec, the reference's ``_best_batch_spec``, are
    the ranks whose gradients and losses are summed, and ZeRO-1's) and
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
    bspecs = sh.data_specs(cfg, batch_struct, mesh, mode="train")
    # the axes the batch really splits over: the ranks that hold other
    # rows, whose gradients and losses are summed
    baxes = sh.train_batch_axes(cfg, mesh, cell.global_batch)
    pspecs = sh.param_specs(cfg, pstruct, mesh, mode="train")
    sspecs = train_state_specs(cfg, pspecs, mesh, pstruct, zero=zero,
                               batch_axes=baxes)
    dsz = math.prod(mesh.shape[a] for a in baxes)
    if cell.global_batch % (dsz * microbatches):
        raise ValueError(f"a global batch of {cell.global_batch} does not "
                         f"split into {microbatches} microbatches over "
                         f"{dsz} data ranks")
    step = _train_step(model, ocfg, microbatches, mesh, sspecs, baxes)
    return step, state_struct, batch_struct, (sspecs, bspecs)


# ---------------------------------------------------------------------------
# the serve-side executors
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ServeSpecs:
    """The specs of one serve cell on a mesh, the reference's shardings of
    its serve-side ``jit_*`` wrappers: ``params`` (``param_specs(mode=
    "serve")`` of ``pstruct``), ``cache`` (``cache_specs`` of the cell's
    dense cache ``cstruct``), ``batch`` (``data_specs(mode="serve")`` of
    ``batch_struct``), ``tokens`` (a decode cell's tokens, (B,)) and
    ``logits`` ((B, V): rows over the data axes where B divides them, the
    vocab over ``model`` where the padded vocab divides it)."""

    params: Any
    cache: Any
    batch: Dict[str, Any]
    tokens: tuple
    logits: tuple
    pstruct: Any
    cstruct: Any
    batch_struct: Dict[str, Any]

    @property
    def rows(self):
        """The spec entry of the cache's batch dim: the rows a rank
        computes."""
        return self.cache["lens"][0]


def serve_specs(model: Model, mesh, cell: ShapeCell, quantized: bool = True,
                policy: Optional[QuantPolicy] = None,
                sample: bool = False) -> ServeSpecs:
    """The specs ``jit_prefill_step`` / ``jit_serve_step`` (``sample``:
    ``jit_serve_sample_step``, whose tokens take ``_best_batch_spec``) put
    on one cell, with the structs they are read from (meta tensors)."""
    cfg = model.cfg
    pstruct = params_struct(model, quantized=quantized, policy=policy)
    batch_struct = input_specs(cfg, cell)
    cstruct = cache_struct(model, cell)
    bdim = cell.global_batch
    bspec = sh.dp_axes(mesh) if bdim % sh._dp_size(mesh) == 0 else None
    vspec = "model" if cfg.padded_vocab() % mesh.shape["model"] == 0 \
        else None
    tspec = sh._best_batch_spec(cfg, mesh, bdim, "serve") if sample \
        else bspec
    return ServeSpecs(
        params=sh.param_specs(cfg, pstruct, mesh, mode="serve"),
        cache=sh.cache_specs(cfg, cstruct, mesh),
        batch=sh.data_specs(cfg, batch_struct, mesh, mode="serve"),
        tokens=(tspec,), logits=(bspec, vspec), pstruct=pstruct,
        cstruct=cstruct, batch_struct=batch_struct)


def _to_rows(t: torch.Tensor, spec: tuple, dim: int, want, mesh
             ) -> torch.Tensor:
    """``t`` held under ``spec``, whose dim ``dim`` carries the batch rows,
    as held with ``want`` in that entry: itself where the two agree, else
    gathered whole and cut again (a multi-pod mesh, where a batch that
    divides ``data`` but not ``pod x data`` splits its tokens over
    ``data`` and its cache not at all)."""
    spec = tuple(spec) + (None,) * (t.dim() - len(spec))
    if spec[dim] == want:
        return t
    to = spec[:dim] + (want,) + spec[dim + 1:]
    return sh.shard(sh.gather(t, spec, mesh), to, mesh)


def _batch_rows(batch: Dict[str, Any], sp: ServeSpecs, mesh
                ) -> Dict[str, Any]:
    """A prefill batch held under ``sp.batch`` -> the cache's rows."""
    return {k: _to_rows(torch.as_tensor(v), sp.batch[k], 0, sp.rows, mesh)
            for k, v in batch.items()}


def _vocab_part(logits: torch.Tensor, sp: ServeSpecs, mesh) -> torch.Tensor:
    """The rank's rows' whole logits -> their slice under ``sp.logits``
    (the rows are already the rank's: the logits' rows follow the
    cache's)."""
    return sh.shard(logits, (None, sp.logits[1]), mesh)


def jit_prefill_step(model: Model, mesh, cell: ShapeCell,
                     quantized: bool = True,
                     policy: Optional[QuantPolicy] = None):
    """The one-shot prefill on one rank of ``mesh``: the reference's
    ``jit_prefill_step``, whose name, arguments and returns it keeps;
    nothing is compiled.  Returns (step, pstruct, batch_struct).
    ``step(params, batch) -> (logits, cache)`` takes the rank's shards of
    ``serve_specs(...).params`` and its rows of the batch (``.batch``) and
    returns its ``(B@data, V@model)`` slice of the last position's logits
    and its part of a cache of ``cell.seq_len`` positions under
    ``.cache``.  The prompts run on the rank's rows, every rank of the
    model axis alike, on the weights gathered on use."""
    sp = serve_specs(model, mesh, cell, quantized, policy)

    def prefill_step(params, batch):
        logits, cache = model.prefill(
            sh.Sharded(params, sp.params), _batch_rows(batch, sp, mesh),
            max_seq=cell.seq_len, mesh=mesh, cache_specs=sp.cache)
        return _vocab_part(logits, sp, mesh), cache

    return prefill_step, sp.pstruct, sp.batch_struct


def jit_serve_step(model: Model, mesh, cell: ShapeCell,
                   quantized: bool = True,
                   policy: Optional[QuantPolicy] = None):
    """One decode step on one rank of ``mesh``: the reference's
    ``jit_serve_step``.  Returns (step, pstruct, cstruct, batch_struct).
    ``step(params, cache, tokens) -> (logits, cache)`` takes the rank's
    weight shards, its part of the cell's cache (``serve_specs(...).cache``,
    written in place and returned) and its tokens (``.tokens``: the rows
    over the data axes, or every row where B does not divide them, as
    ``long_500k``'s batch of 1), and returns its ``(B@data, V@model)``
    slice of the logits."""
    sp = serve_specs(model, mesh, cell, quantized, policy)

    def serve_step(params, cache, tokens):
        tokens = _to_rows(tokens, sp.tokens, 0, sp.rows, mesh)
        logits, cache = model.decode_step(sh.Sharded(params, sp.params),
                                          cache, tokens, mesh=mesh,
                                          cache_specs=sp.cache)
        return _vocab_part(logits, sp, mesh), cache

    return serve_step, sp.pstruct, sp.cstruct, sp.batch_struct


def jit_serve_sample_step(model: Model, mesh, cell: ShapeCell,
                          quantized: bool = True,
                          policy: Optional[QuantPolicy] = None):
    """Decode and sample on one rank of ``mesh``: the reference's
    ``jit_serve_sample_step``.  Returns (step, pstruct, cstruct,
    batch_struct).  ``step(params, cache, tokens, key) -> (tokens, cache)``
    is :func:`jit_serve_step`'s step followed by
    ``make_serve_sample_step``'s draw, the vocab-sharded Gumbel-max of
    ``serving/sampling_distributed.gumbel_argmax`` at temperature 1: the
    rank perturbs its vocab slice of its rows' logits with the noise of the
    global (row, vocab) indices and the model axis exchanges winners, so
    the tokens are the unsharded ones bit for bit.  Tokens in and out are
    held under ``serve_specs(..., sample=True).tokens``
    (``_best_batch_spec``); every rank holds its rows' tokens."""
    from repro_torch.serving.sampling_distributed import gumbel_argmax
    sp = serve_specs(model, mesh, cell, quantized, policy, sample=True)
    rows = sp.rows
    row_start = (sh.shard_range(cell.global_batch, rows, mesh)[0]
                 if sh.live_axes(rows, mesh) else 0)

    def serve_sample_step(params, cache, tokens, key):
        tokens = _to_rows(tokens, sp.tokens, 0, rows, mesh)
        logits, cache = model.decode_step(sh.Sharded(params, sp.params),
                                          cache, tokens, mesh=mesh,
                                          cache_specs=sp.cache)
        nxt = gumbel_argmax(key, _vocab_part(logits, sp, mesh),
                            mesh=mesh if sp.logits[1] else None,
                            vocab_size=logits.shape[-1], row_start=row_start)
        return _to_rows(nxt, (rows,), 0, sp.tokens[0], mesh), cache

    return serve_sample_step, sp.pstruct, sp.cstruct, sp.batch_struct
