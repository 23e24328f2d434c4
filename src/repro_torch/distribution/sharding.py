"""Sharding rules: tree paths -> partition specs, per mode (train / serve),
and the data movement of a mesh: each rank's shard of a tree, and a leaf
gathered whole.

PyTorch counterpart of ``repro/distribution/sharding.py``; the rules are
the reference's, line for line.  A spec is a plain tuple with one entry a
dim, each an axis name, a tuple of axis names or None: the counterpart of
``jax.sharding.PartitionSpec``, which compares as the same tuple.  A
quantized leaf's spec is a ``QuantizedTensor`` whose ``q`` and ``scale``
hold the specs of its codes and its scales.  Paths are the tree's keys
joined by ``/`` (``blocks/attn/wq``; a tuple's items by their index), as
the reference's ``_path_str`` names them, so every rule matches the port's
trees (``models/transformer.py`` keeps the reference's layout).

The mesh is (data, model), optionally with a leading
pure-DP ``pod`` axis.

TRAIN / PREFILL (Megatron-style TP over ``model``):
  * embedding + LM head: vocab on ``model``,
  * attention: q heads on ``model`` when they divide it, else head_dim;
    KV heads sharded only when divisible, else replicated,
  * MLP: column-parallel w1/w3, row-parallel w2,
  * MoE: experts on ``model`` (EP), or over ``data`` with d_ff on
    ``model`` (``moe_shard="ep_data"``),
  * Mamba2: d_inner and everything aligned with it on ``model``; B/C
    projections replicated,
  * batch on (``pod``, ``data``).

SERVE (decode): identical except that the attention projections shard the
d_model contraction (``serve_attn_shard='din'``) and the KV cache shards
its KV heads when they divide the model axis, else its sequence.

In place of the reference's ``to_shardings`` (a GSPMD placement),
:func:`shard` keeps each rank's local slice of a tree and :func:`gather`
all-gathers a leaf whole.  An all-gather moves data and adds nothing, so a
tree gathered back is its unsharded self, bit for bit.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantization import QuantizedTensor
from repro_torch.distribution import collectives as C

Spec = Tuple[Any, ...]


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def map_with_path(fn: Callable, tree: Any, path: tuple = ()) -> Any:
    """``fn(path string, leaf)`` over a tree of dicts, tuples and lists
    whose leaves are tensors or ``QuantizedTensor``s, in a tree of the same
    structure."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, (*path, k)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_with_path(fn, v, (*path, i))
                          for i, v in enumerate(tree))
    return fn(_path_str(path), tree)


def _map2(fn: Callable, tree: Any, specs: Any) -> Any:
    """``fn(leaf, spec)`` over ``tree`` and its spec tree together."""
    if isinstance(tree, dict):
        return {k: _map2(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map2(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, specs)


def dp_axes(mesh) -> Any:
    """The batch-carrying mesh axes: ('pod','data') multi-pod, 'data' else."""
    axes = tuple(a for a in mesh.axis_names if a != "model")
    return axes if len(axes) > 1 else axes[0]


def _pad(spec_tail: tuple, rank: int) -> Spec:
    """Left-pad with None for stacked leading (layer/superblock) dims."""
    return tuple([None] * (rank - len(spec_tail)) + list(spec_tail))


def _rule(path: str, rank: int, cfg: ModelConfig, model_size: int,
          mode: str) -> Spec:
    if mode == "train" and cfg.train_shard == "dp":
        # pure data parallelism: params replicated, batch over ALL axes
        return tuple([None] * rank)

    kv_div = cfg.n_kv_heads > 0 and cfg.n_kv_heads % model_size == 0

    if re.search(r"^(embed|lm_head)$", path):
        return ("model", None)
    if re.search(r"enc_pos|dec_pos", path):
        return (None, None)
    if re.search(r"norm|gamma|beta", path):
        if "/ssm/" in path:                      # gated-norm gamma (d_inner,)
            return _pad(("model",), rank)
        return _pad((None,), rank)

    # --- attention (head-structured: wq/wk/wv (H, hd, D), wo (D, H, hd)) ---
    # the head axis is sharded only when H % model == 0; otherwise
    # head_dim
    h_div = cfg.n_heads > 0 and cfg.n_heads % model_size == 0
    if re.search(r"/(attn|cross)/w[qkv]$", path):
        is_kv = path.endswith("wk") or path.endswith("wv")
        if mode == "serve" and cfg.serve_attn_shard == "din":
            return _pad((None, None, "model"), rank)
        if is_kv:
            # KV layout-consistent with Q: replicated when Q is
            # head-sharded, hd-sharded when Q is
            if kv_div:
                return _pad(("model", None, None), rank)
            if h_div:
                return _pad((None, None, None), rank)
            if cfg.hd() % model_size == 0:
                return _pad((None, "model", None), rank)
            return _pad((None, None, None), rank)
        if h_div:
            return _pad(("model", None, None), rank)
        if cfg.hd() % model_size == 0:
            return _pad((None, "model", None), rank)
        return _pad((None, None, None), rank)
    if re.search(r"/(attn|cross)/wo$", path):
        if h_div:
            return _pad((None, "model", None), rank)
        if cfg.hd() % model_size == 0:
            return _pad((None, None, "model"), rank)
        return _pad((None, None, None), rank)

    # --- MoE (E leading: expert parallelism) ---
    if path.endswith("router"):
        return _pad((None, None), rank)
    if re.search(r"/moe/w[13]$", path):
        if cfg.moe_shard == "ep_data":
            # FSDP-EP: experts over `data`, d_ff over `model`
            return _pad(("data", "model", None), rank)
        return _pad(("model", None, None), rank)
    if re.search(r"/moe/w2$", path):
        if cfg.moe_shard == "ep_data":
            return _pad(("data", None, "model"), rank)
        return _pad(("model", None, None), rank)

    # --- fused decode GEMV operands (transformer.fuse_decode_weights) ---
    # wqkv ((H+2KVH)*hd, D), w13 (2*d_ff, D), wo_f (D, H*hd)
    if re.search(r"/attn/wqkv$", path):
        if mode == "serve" and cfg.serve_attn_shard == "din":
            return _pad((None, "model"), rank)
        return _pad(("model", None), rank)
    if re.search(r"/attn/wo_f$", path):
        if mode == "serve" and cfg.serve_attn_shard == "din":
            return _pad((None, "model"), rank)
        return _pad(("model", None), rank)
    if re.search(r"/mlp/w13$", path):
        return _pad(("model", None), rank)

    # --- dense MLP ---
    if re.search(r"/mlp/w[13]$", path):
        return _pad(("model", None), rank)
    if re.search(r"/mlp/w2$", path):
        return _pad((None, "model"), rank)

    # --- Mamba2 ---
    if re.search(r"/ssm/w[zx]$", path):
        return _pad(("model", None), rank)
    if re.search(r"/ssm/w[BC]$", path):
        return _pad((None, None), rank)
    if re.search(r"/ssm/wdt$", path):            # heads follow d_inner shards
        return _pad(("model", None), rank)
    if re.search(r"conv_x_bias$", path):
        return _pad(("model",), rank)
    if re.search(r"conv_[BC]_bias$", path):
        return _pad((None,), rank)
    if re.search(r"conv_x$", path):
        return _pad(("model", None), rank)
    if re.search(r"conv_[BC]$", path):
        return _pad((None, None), rank)
    if re.search(r"A_log$|dt_bias$|D_skip$", path):
        return _pad(("model",), rank)
    if path.endswith("out_proj"):
        return _pad((None, "model"), rank)

    return tuple([None] * rank)


def _axes(entry) -> tuple:
    return entry if isinstance(entry, tuple) else (entry,)


def sanitize(spec: Spec, shape: tuple, mesh) -> Spec:
    """Null out any spec entry whose dim doesn't divide the axis size.

    Degrades, never raises: an over-long spec is truncated to the array's
    rank and axis names the mesh doesn't carry fall back to replication.
    Serving calls this mid-admission, where raising would turn a spec
    mismatch into a failed request."""
    parts = list(spec)[:len(shape)] + \
        [None] * max(0, len(shape) - len(spec))
    out = []
    for dim, axis in zip(shape, parts):
        if axis is None:
            out.append(None)
            continue
        axes = _axes(axis)
        if any(a not in mesh.shape for a in axes):
            out.append(None)
            continue
        size = 1
        for a in axes:
            size *= mesh.shape[a]
        out.append(axis if size > 0 and dim % size == 0 else None)
    return tuple(out)


def _spec_for_leaf(path: str, leaf, cfg, mesh, mode: str):
    model_size = mesh.shape["model"]
    if isinstance(leaf, QuantizedTensor):
        # codes keep the float weight's spec; scales shrink the grouped
        # last axis (and Q4 packs it 2:1) -- sanitize drops entries that
        # no longer divide
        spec = _rule(path, len(leaf.q.shape), cfg, model_size, mode)
        return dataclasses.replace(
            leaf, q=sanitize(spec, tuple(leaf.q.shape), mesh),
            scale=sanitize(spec, tuple(leaf.scale.shape), mesh))
    spec = _rule(path, len(leaf.shape), cfg, model_size, mode)
    return sanitize(spec, tuple(leaf.shape), mesh)


def param_specs(cfg: ModelConfig, params: Any, mesh, mode: str = "train"
                ) -> Any:
    """Tree of specs matching ``params`` (tensors, meta tensors included)."""
    return map_with_path(
        lambda p, leaf: _spec_for_leaf(p, leaf, cfg, mesh, mode), params)


def _dp_size(mesh) -> int:
    n = 1
    for a in mesh.axis_names:
        if a != "model":
            n *= mesh.shape[a]
    return n


def batch_axes_for(cfg: ModelConfig, mesh, mode: str = "train"):
    """Mesh axes carrying the batch dim.  Pure-DP training uses ALL axes;
    otherwise everything but ``model``."""
    if mode == "train" and cfg.train_shard == "dp":
        return tuple(mesh.axis_names)
    return tuple(a for a in mesh.axis_names if a != "model")


def _best_batch_spec(cfg: ModelConfig, mesh, bdim: int, mode: str):
    """Largest suffix of the batch axes whose product divides ``bdim``."""
    axes = batch_axes_for(cfg, mesh, mode)
    while axes:
        size = 1
        for a in axes:
            size *= mesh.shape[a]
        if bdim % size == 0:
            return axes if len(axes) > 1 else axes[0]
        axes = axes[1:]          # drop the outermost (pod first)
    return None


def spec_axes(entry) -> tuple:
    """The mesh axes of one spec entry, in order (() for None)."""
    return () if entry is None else _axes(entry)


def train_batch_axes(cfg: ModelConfig, mesh, bdim: int) -> tuple:
    """The axes a train batch of ``bdim`` rows really splits over: those of
    :func:`_best_batch_spec`, the batch spec ``data_specs`` gives.  A rank
    on a batch axis left out (``pod``, where the batch does not divide the
    whole product) computes the same rows as its peers there."""
    return spec_axes(_best_batch_spec(cfg, mesh, bdim, "train"))


def data_specs(cfg: ModelConfig, batch: Any, mesh, mode: str = "train"
               ) -> Any:
    """Input batch: batch dim over the batch axes; m-rope positions are
    (3, B, S) so the batch dim sits second.  A batch smaller than the
    batch axes is replicated."""

    def visit(p, leaf):
        r = len(leaf.shape)
        if r == 0:
            return ()
        if "positions" in p and r == 3:          # m-rope (3, B, S)
            return (None, _best_batch_spec(cfg, mesh, leaf.shape[1], mode),
                    None)
        return (_best_batch_spec(cfg, mesh, leaf.shape[0], mode),
                *([None] * (r - 1)))

    return map_with_path(visit, batch)


def pool_model_axis(cfg: ModelConfig, mesh) -> Any:
    """The mesh axis the paged KV pool shards over, or None.

    The pool shards its KV-heads dim: per-head attention math is local
    (heads only mix at the wo contraction), so a KVH split keeps every
    floating-point reduction on one device and the engine's bitwise
    stream contract intact.  Degrades to replication when KVH doesn't
    divide the model axis, and on a model axis of size 1."""
    msize = mesh.shape.get("model", 1)
    if msize <= 1:
        return None
    if cfg.n_kv_heads > 0 and cfg.n_kv_heads % msize == 0:
        return "model"
    return None


def _canon(spec: Spec) -> Spec:
    """Drop trailing Nones (the reference keeps its specs canonical)."""
    parts = list(spec)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def paged_cache_specs(cfg: ModelConfig, cache: Any, mesh) -> Any:
    """Paged-pool sharding: KV pool (L, N, bs, KVH, hd) splits KVH over
    ``model`` (see ``pool_model_axis``); int8 scale pools (L, N, bs, KVH)
    follow; page_table / lens are host-authored control state and stay
    replicated.  Specs are canonical (no trailing Nones)."""
    kvh_ax = pool_model_axis(cfg, mesh)

    def visit(p, leaf):
        if p.endswith("/k") or p.endswith("/v"):
            return _canon(sanitize((None, None, None, kvh_ax, None),
                                   tuple(leaf.shape), mesh))
        if p.endswith("/ks") or p.endswith("/vs"):
            return _canon(sanitize((None, None, None, kvh_ax),
                                   tuple(leaf.shape), mesh))
        return ()

    return map_with_path(visit, cache)


def cache_specs(cfg: ModelConfig, cache: Any, mesh) -> Any:
    """Decode-state sharding.

    Attention K/V (...lead, B, S, KVH, hd): KVH on ``model`` when
    divisible, else S on ``model`` (flash-decode SP).  SSM state (..., B,
    H, P, N): heads on ``model``.  Conv ring buffers: channels on
    ``model`` for the x buffer (path .../conv/0), replicated for the tiny
    B/C buffers.  A cache with a ``page_table`` takes
    :func:`paged_cache_specs`."""
    if isinstance(cache, dict) and "page_table" in cache:
        return paged_cache_specs(cfg, cache, mesh)

    dp = dp_axes(mesh)
    dsz = _dp_size(mesh)
    msize = mesh.shape["model"]
    kv_div = cfg.n_kv_heads > 0 and cfg.n_kv_heads % msize == 0

    def bspec(bdim):
        return dp if bdim % dsz == 0 else None

    def visit(p, leaf):
        shape = tuple(leaf.shape)
        r = len(shape)
        if p.endswith("lens"):
            return (bspec(shape[0]),)
        if p.endswith("/k") or p.endswith("/v"):
            lead = r - 4                         # (..., B, S, KVH, hd)
            b, s = shape[lead], shape[lead + 1]
            if kv_div:
                tail = (None, "model", None)
            elif s % msize == 0:
                tail = ("model", None, None)     # flash-decode SP over S
            else:
                tail = (None, None, None)
            return tuple([None] * lead + [bspec(b)] + list(tail))
        if p.endswith("/ks") or p.endswith("/vs"):
            lead = r - 3                         # (..., B, S, KVH)
            b, s = shape[lead], shape[lead + 1]
            if kv_div:
                tail = (None, "model")
            elif s % msize == 0:
                tail = ("model", None)
            else:
                tail = (None, None)
            return tuple([None] * lead + [bspec(b)] + list(tail))
        if p.endswith("state"):                  # (..., B, H, P, N)
            lead = r - 4
            h = shape[lead + 1]
            return tuple([None] * lead +
                         [bspec(shape[lead]),
                          "model" if h % msize == 0 else None, None, None])
        if "/conv/" in p:                        # (..., B, W-1, C)
            lead = r - 3
            ch = "model" if p.endswith("/0") and \
                shape[-1] % msize == 0 else None
            return tuple([None] * lead + [bspec(shape[lead]), None, ch])
        return tuple([bspec(shape[0])] + [None] * (r - 1))

    return map_with_path(visit, cache)


# ---------------------------------------------------------------------------
# data movement: a rank's shard of a tree, a leaf gathered whole
# ---------------------------------------------------------------------------


def live_axes(entry, mesh) -> tuple:
    """The axes of one spec entry with more than one rank: the ones that
    really split a dim."""
    if entry is None:
        return ()
    return tuple(a for a in _axes(entry) if mesh.shape[a] > 1)


def shard_range(dim: int, entry, mesh) -> Tuple[int, int]:
    """(start, length) of this rank's part of a dim of size ``dim`` under
    one spec entry: the entry's axes split the dim into equal parts, the
    first axis outermost."""
    count, index = 1, 0
    for a in _axes(entry) if entry is not None else ():
        count *= mesh.shape[a]
        index = index * mesh.shape[a] + mesh.coords[a]
    n = dim // count
    return index * n, n


def local_view(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's part of a whole tensor under ``spec``: a view (no
    copy), ``t`` itself where no live axis splits it."""
    out = t
    for d, entry in enumerate(spec):
        if live_axes(entry, mesh):
            start, n = shard_range(t.shape[d], entry, mesh)
            out = out.narrow(d, start, n)
    return out


def _shard_tensor(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    out = local_view(t, spec, mesh)
    # a copy of the slice alone: the rank holds its shard, not the tree
    return out.clone() if out is not t else t


def restrict(spec: Spec, axes: tuple) -> Spec:
    """``spec`` with every mesh axis outside ``axes`` dropped (an entry
    left with none is None): e.g. a cache spec less its batch axes, the
    split a rank's rows keep along ``model``."""
    out = []
    for entry in spec:
        kept = tuple(a for a in (_axes(entry) if entry is not None else ())
                     if a in axes)
        out.append(None if not kept else kept if len(kept) > 1
                   else kept[0])
    return tuple(out)


def restrict_tree(tree: Any, specs: Any, axes: tuple, drop: int = 0) -> Any:
    """:func:`restrict` of every spec of ``specs`` (the spec tree of
    ``tree``, which tells a spec from a tuple of specs), each less its
    ``drop`` leading entries first (``tree`` one layer of a stacked tree
    ``specs`` describes)."""
    return _map2(lambda leaf, spec: restrict(spec[drop:], axes), tree,
                 specs)


def parts(entry, mesh) -> int:
    """How many parts one spec entry cuts its dim into on ``mesh``."""
    n = 1
    for a in live_axes(entry, mesh):
        n *= mesh.shape[a]
    return n


@dataclasses.dataclass
class Sharded:
    """A tree held sharded on one rank of a mesh: ``tree`` holds the rank's
    shards (:func:`shard`), ``specs`` the specs they were cut by; a leaf
    is whole again through :func:`gather`."""

    tree: Any
    specs: Any


def shard(tree: Any, specs: Any, mesh) -> Any:
    """This rank's local slice of every leaf of ``tree`` under ``specs``
    (a quantized leaf's codes and scales each under their own spec).  A
    leaf no live axis splits is kept as it is; a split one is a copy of
    the slice alone."""
    def visit(leaf, spec):
        if isinstance(leaf, QuantizedTensor):
            return dataclasses.replace(
                leaf, q=_shard_tensor(leaf.q, spec.q, mesh),
                scale=_shard_tensor(leaf.scale, spec.scale, mesh))
        return _shard_tensor(leaf, spec, mesh)
    return _map2(visit, tree, specs)


def all_gather_dim(t: torch.Tensor, dim: int, group, n: int
                   ) -> torch.Tensor:
    """The ``n`` ranks' tensors of ``group`` concatenated along ``dim``,
    in rank order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    C.record("all-gather", n * C.nbytes(t), n)
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def _gather_tensor(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    for d, entry in enumerate(spec):
        # the innermost axis first: its ranks hold neighbouring parts
        for a in reversed(live_axes(entry, mesh)):
            t = all_gather_dim(t, d, mesh.groups[a], mesh.shape[a])
    return t


def gather(t: Any, spec: Any, mesh) -> Any:
    """One leaf (a tensor or a ``QuantizedTensor``) all-gathered whole from
    the ranks' shards under ``spec``.  A leaf no live axis splits is
    returned as it is, with no collective."""
    if isinstance(t, QuantizedTensor):
        return dataclasses.replace(t, q=_gather_tensor(t.q, spec.q, mesh),
                                   scale=_gather_tensor(t.scale, spec.scale,
                                                        mesh))
    return _gather_tensor(t, spec, mesh)


def gather_tree(tree: Any, specs: Any, mesh) -> Any:
    """:func:`gather` of every leaf of ``tree``."""
    return _map2(lambda leaf, spec: gather(leaf, spec, mesh), tree, specs)


def gather_for_grad(tree: Any, specs: Any, mesh) -> Any:
    """Every float leaf of ``tree`` all-gathered whole under ``specs``, as
    :func:`gather`, with a gradient: the gradient of the whole leaf comes
    back as the rank's own slice, which the ranks along a splitting axis
    compute alike (no train-mode spec splits the leaves of these families
    over an axis of the batch).  A leaf no live axis splits is returned as
    it is.  The training forward of the families that compute replicated
    on a mesh (``transformer.train_view``)."""
    def visit(t, spec):
        for d, entry in enumerate(spec):
            for a in reversed(live_axes(entry, mesh)):
                group, n, index = C.axis(mesh, a)
                t = C.gather_from(t, d, group, n, index)
        return t
    return _map2(visit, tree, specs)


def drop_lead(specs: Any, n: int = 1) -> Any:
    """The spec tree (dicts of specs) of one layer of a layer-stacked
    tree: each spec less its ``n`` leading (layer) entries."""
    if isinstance(specs, dict):
        return {k: drop_lead(v, n) for k, v in specs.items()}
    if isinstance(specs, QuantizedTensor):
        return dataclasses.replace(specs, q=specs.q[n:],
                                   scale=specs.scale[n:])
    return specs[n:]
