"""Decoder-only LM: init, decode-weight fusion, decode on the paged pool or
the dense per-slot cache, chunked and one-shot prefill, and the training
loss (``lm_loss``).

PyTorch counterpart of ``repro/models/transformer.py`` for the dense
family, the vlm family (the dense decoder with M-RoPE, on precomputed
patch embeddings or text tokens), the MoE family (every layer MoE, or the
llama4 interleave: ``moe_every - 1`` dense layers, then an MoE one, in
turn), the SSM family (Mamba2 layers, ``models/ssm.py``) and the hybrid
(Mamba2 layers with one shared attention block after every
``attn_every``-th).  The audio family is ``models/encdec.py``.
Parameters are nested dicts of tensors (or ``QuantizedTensor`` leaves after
``Model.quantize``) stacked per layer in the reference's layout (the
interleave's ``blocks_dense`` on two leading axes and ``blocks_moe``; the
hybrid's ``blocks_main`` on two leading axes, ``blocks_tail``, and the
unstacked ``shared_attn``); the layer loop is a Python loop over the
stacked leading axes (``_layers``).

Serving runs on the paged KV pool (``init_paged_cache``, filled by
``prefill_chunk_batch``; ``verify_chunk_batch`` is its twin with logits at
every chunk position, for speculative decoding) or on the dense per-slot
reservation (``init_cache``, filled by the one-shot ``prefill``), each
also on one rank of a mesh (``mesh=``: :class:`_ServeMesh`); the SSM
and hybrid families and the interleave have only the dense cache (the
interleave's two attention banks, the SSM families' conv rings and SSM
states beside the hybrid's K/V).  Unlike the reference, which donates the
cache to a jitted step, the port writes it in place: ``decode_step`` and
the chunk steps return the same cache tensors they were given, updated.

Training (``forward_hidden``, ``lm_loss``) follows the reference's jnp
path: float weights through ``qeinsum`` / ``qdot``, attention on
``layers.attention_scores_blockwise`` (``train_attention``; never a CUDA
kernel, none of which has a backward), the MoE's grouped dispatch, and the
cross-entropy in chunks of f32 logits; each block and each chunk under
``torch.utils.checkpoint`` (``remat``, the reference's ``"block"``).  On
a train mesh (``lm_loss(mesh=)``, ``train_view``) the dense, vlm and MoE
families run those products in Megatron tensor parallelism, the MoE's
experts in expert parallelism (``_TrainTP``), and the other families on
leaves gathered whole.
"""

from __future__ import annotations

import collections.abc
import dataclasses
import importlib
import math
import sys
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import Device, resolve_device
from repro_torch.core.policy import QuantPolicy, count_bytes, quantize_params
from repro_torch.core.qlinear import norm_qdot, qdot, qeinsum
from repro_torch.core.quantization import (QuantizedTensor,
                                           choose_group_size, qt_concat,
                                           qt_fold_lead_into_groups,
                                           qt_reshape_lead, quantize,
                                           quantize_rows)
from repro_torch.core.tree import map_tree
from repro_torch.distribution import collectives as C
from repro_torch.distribution import sharding as sh
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import ssm as S

Params = Dict[str, Any]
Cache = Dict[str, Any]


def _cdt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def _pdt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def _q_scale(cfg: ModelConfig) -> float:
    """hd^-1/2 rounded to the compute dtype, as the reference's weakly
    typed ``q * hd ** -0.5`` rounds it before the product (PyTorch would
    multiply a bfloat16 ``q`` by the unrounded scalar)."""
    return float(torch.tensor(cfg.hd() ** -0.5, dtype=_cdt(cfg)))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def check_family(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a config the port does not serve:
    a family the JAX package does not have, and a norm or MLP its family
    does not use (the audio family's encoder-decoder, ``models/encdec.py``,
    has LayerNorm and a GELU MLP; every other family RMSNorm and
    SwiGLU)."""
    blocks = (("layernorm", "gelu") if cfg.family == "audio"
              else ("rmsnorm", "swiglu"))
    if cfg.family not in ("dense", "vlm", "moe", "ssm", "hybrid", "audio") \
            or (cfg.norm_type, cfg.mlp_type) != blocks \
            or not cfg.tie_embeddings:
        raise NotImplementedError(
            f"{cfg.arch_id}: only the dense, vlm, MoE, SSM and hybrid "
            "families with RMSNorm and SwiGLU, and the audio family with "
            "LayerNorm and a GELU MLP, each with tied embeddings, are "
            "ported")


def _draw_leaf(shape, by_layer: bool, draw):
    """``draw(shape)``; with ``by_layer``, ``draw(shape[1:])`` once a layer,
    each layer's leaf (float or quantized) written into one leaf stacked on
    the leading axis as it is made: only one layer's draw is held beside
    the stack."""
    if not by_layer:
        return draw(shape)
    n, out = shape[0], None
    for i in range(n):
        w = draw(shape[1:])
        if out is None:
            out = (dataclasses.replace(
                w, q=w.q.new_empty((n, *w.q.shape)),
                scale=w.scale.new_empty((n, *w.scale.shape)))
                if isinstance(w, QuantizedTensor)
                else w.new_empty((n, *w.shape)))
        if isinstance(w, QuantizedTensor):
            out.q[i], out.scale[i] = w.q, w.scale
        else:
            out[i] = w
        del w
    return out


def _ones(dev: torch.device, *shape) -> torch.Tensor:
    return torch.ones(shape, dtype=torch.float32, device=dev)


def _dense_block(cfg: ModelConfig, leaf, dev: torch.device,
                 lead: Tuple[int, ...], prefix: str,
                 moe: bool = False) -> Params:
    """One attention + MLP block stacked on ``lead`` (``(n_layers,)``, the
    interleave's ``(n_pat, moe_every - 1)`` or ``(n_pat,)``, or ``()`` for
    the hybrid's unstacked shared block): wq, wk, wv, wo, then w1, w3, w2
    (the dense MLP), or with ``moe`` the MoE's f32 router and its expert
    banks w1, w3, w2, each bank drawn one index of ``lead[0]`` at a time
    (qwen3-moe-30b-a3b's bank is 38.7 GB of f32 at once, 0.8 GB a layer;
    llama4-maverick-400b-a17b's 21.5 GB a layer); norm gammas of ones."""
    d, hd = cfg.d_model, cfg.hd()
    h, kvh, f = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    sc, so = 1.0 / math.sqrt(d), 1.0 / math.sqrt(h * hd)
    sf = 1.0 / math.sqrt(f)
    blk = {
        "norm1": {"gamma": _ones(dev, *lead, d)},
        "attn": {"wq": leaf(f"{prefix}/attn/wq", (*lead, h, hd, d), sc),
                 "wk": leaf(f"{prefix}/attn/wk", (*lead, kvh, hd, d), sc),
                 "wv": leaf(f"{prefix}/attn/wv", (*lead, kvh, hd, d), sc),
                 "wo": leaf(f"{prefix}/attn/wo", (*lead, d, h, hd), so)},
        "norm2": {"gamma": _ones(dev, *lead, d)},
    }
    if moe:
        e = cfg.n_experts
        blk["moe"] = {
            "router": leaf(f"{prefix}/moe/router", (*lead, e, d), sc,
                           torch.float32),
            "w1": leaf(f"{prefix}/moe/w1", (*lead, e, f, d), sc,
                       by_layer=True),
            "w3": leaf(f"{prefix}/moe/w3", (*lead, e, f, d), sc,
                       by_layer=True),
            "w2": leaf(f"{prefix}/moe/w2", (*lead, e, d, f), sf,
                       by_layer=True)}
    else:
        blk["mlp"] = {"w1": leaf(f"{prefix}/mlp/w1", (*lead, f, d), sc),
                      "w3": leaf(f"{prefix}/mlp/w3", (*lead, f, d), sc),
                      "w2": leaf(f"{prefix}/mlp/w2", (*lead, d, f), sf)}
    return blk


def _ssm_dims(cfg: ModelConfig) -> S.SSMDims:
    return S.make_ssm_dims(cfg.d_model, cfg.ssm_state, cfg.ssm_expand,
                           cfg.ssm_head_dim, cfg.ssm_groups, cfg.conv_width)


def _ssm_block(cfg: ModelConfig, leaf, dev: torch.device,
               lead: Tuple[int, ...], prefix: str) -> Params:
    """Mamba2 layers stacked on ``lead``: norm1 and the ``ssm`` tree of
    ``ssm.init_mamba2_params``."""
    return {"norm1": {"gamma": _ones(dev, *lead, cfg.d_model)},
            "ssm": S.init_mamba2_params(leaf, _ssm_dims(cfg),
                                        f"{prefix}/ssm", lead, dev)}


def _hybrid_split(cfg: ModelConfig) -> Tuple[int, int]:
    """The hybrid's (super blocks, tail layers): ``n_layers //
    attn_every`` super blocks of ``attn_every`` Mamba2 layers and the
    shared block, then the layers left over."""
    n_super = cfg.n_layers // cfg.attn_every
    return n_super, cfg.n_layers - n_super * cfg.attn_every


def interleaved(cfg: ModelConfig) -> bool:
    """The llama4 interleave: an MoE family with ``moe_every`` > 1."""
    return cfg.family == "moe" and cfg.moe_every > 1


def _interleave_split(cfg: ModelConfig) -> Tuple[int, int]:
    """The interleave's (patterns, dense layers a pattern): ``n_layers //
    moe_every`` patterns of ``moe_every - 1`` dense layers and an MoE one;
    the layers left over are dropped, as the reference drops them."""
    return cfg.n_layers // cfg.moe_every, cfg.moe_every - 1


def _param_tree(cfg: ModelConfig, leaf, dev: torch.device) -> Params:
    """The parameter tree on ``dev`` in the reference's layout, each weight
    made by ``leaf(path, shape, scale, dtype=None, by_layer=False)`` (a
    normal draw times ``scale`` in ``dtype``, the param dtype by default,
    path as ``quantize_params`` names it; ``by_layer``: drawn one layer at
    a time into the stack): the embedding, then the blocks.  Dense and MoE:
    ``blocks`` (``_dense_block``).  The interleave: ``blocks_dense``
    (n_pat, moe_every - 1, ...) and ``blocks_moe`` (n_pat, ...).  SSM:
    ``blocks`` of Mamba2 layers.
    Hybrid: ``blocks_main`` (n_super, attn_every, ...), ``blocks_tail``
    (the layers left over) and the unstacked ``shared_attn``; each stack is
    its own draw, so the quantization policy judges it at its own shape,
    as the reference's does."""
    nl, d = cfg.n_layers, cfg.d_model
    params: Params = {"embed": leaf("embed", (cfg.padded_vocab(), d), 0.02),
                      "final_norm": {"gamma": _ones(dev, d)}}
    if cfg.family == "ssm":
        params["blocks"] = _ssm_block(cfg, leaf, dev, (nl,), "blocks")
    elif cfg.family == "hybrid":
        n_super, n_tail = _hybrid_split(cfg)
        params["blocks_main"] = _ssm_block(
            cfg, leaf, dev, (n_super, cfg.attn_every), "blocks_main")
        params["blocks_tail"] = _ssm_block(cfg, leaf, dev, (n_tail,),
                                           "blocks_tail")
        params["shared_attn"] = _dense_block(cfg, leaf, dev, (),
                                             "shared_attn")
    elif interleaved(cfg):
        n_pat, n_dense = _interleave_split(cfg)
        params["blocks_dense"] = _dense_block(cfg, leaf, dev,
                                              (n_pat, n_dense),
                                              "blocks_dense")
        params["blocks_moe"] = _dense_block(cfg, leaf, dev, (n_pat,),
                                            "blocks_moe", moe=True)
    else:
        params["blocks"] = _dense_block(cfg, leaf, dev, (nl,), "blocks",
                                        moe=cfg.family == "moe")
    return params


def draw_params(cfg: ModelConfig, tree, seed: int = 0,
                policy: Optional[QuantPolicy] = None,
                device: Device = None, hold: Device = None) -> Params:
    """``tree(cfg, leaf, dev)`` (``_param_tree``, or ``encdec``'s) with
    every weight drawn from one ``torch.Generator`` seeded ``seed``: a
    normal draw times its scale, in its dtype.  With ``policy`` each weight
    the policy quantizes is quantized as it is drawn, by slices
    (``_quantize_slices``), and its float values freed before the next
    draw.  ``hold`` keeps the tree on another device than the draws'
    (each leaf moved there as it is made, the same bits): a mesh rank
    draws on its card and holds the tree on the host, where it is cut
    into the shards the card keeps."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    to = dev if hold is None else torch.device(hold)

    def leaf(path, shape, scale, dtype=None, by_layer=False):
        quantized = policy is not None and policy.wants(path, shape)

        def draw(shp):
            x = torch.randn(shp, generator=gen, device=dev).mul_(scale).to(
                dtype or _pdt(cfg))
            return _quantize_slices(x, policy) if quantized else x
        return _draw_leaf(shape, by_layer, draw).to(to)

    return map_tree(lambda t: t.to(to), tree(cfg, leaf, dev))


def init_params(cfg: ModelConfig, seed: int = 0,
                device: Device = None, hold: Device = None) -> Params:
    """Random parameters from ``seed``: the reference's shapes and scales
    (normal draws times 1/sqrt(fan-in); embedding times 0.02; the MoE
    router in f32), drawn from a ``torch.Generator``, so the values differ
    from the reference's."""
    check_family(cfg)
    return draw_params(cfg, _param_tree, seed, device=device, hold=hold)


# values a quantized slice of ``init_quantized`` holds at most (1 GB of f32)
_INIT_SLICE = 1 << 28


def _quantize_slices(x: torch.Tensor, policy: QuantPolicy) -> QuantizedTensor:
    """``quantize(x)`` by slices of the leading axis (one layer, or rows of
    the embedding) into codes and scales allocated once: groups lie along
    the last axis, so each slice's codes and scales are the whole
    tensor's."""
    k = x.shape[-1]
    gs = choose_group_size(k, policy.group_size)
    kq = k // 2 if policy.bits == 4 else k
    q = torch.empty((*x.shape[:-1], kq), dtype=torch.int8, device=x.device)
    s = torch.empty((*x.shape[:-1], k // gs), dtype=torch.float32,
                    device=x.device)
    step = max(1, _INIT_SLICE * x.shape[0] // x.numel())
    for i in range(0, x.shape[0], step):
        t = quantize(x[i:i + step], group_size=gs, bits=policy.bits)
        q[i:i + step] = t.q
        s[i:i + step] = t.scale
    return QuantizedTensor(q=q, scale=s, group_size=gs, bits=policy.bits,
                           orig_dim=k)


def init_quantized(cfg: ModelConfig, seed: int = 0,
                   policy: Optional[QuantPolicy] = None,
                   device: Device = None, hold: Device = None) -> Params:
    """``init_params`` quantized as it draws: bitwise
    ``fuse_decode_weights(quantize_params(init_params(cfg, seed), policy))``
    without the float tree.  Each weight is the same generator call at the
    same shape, in the same order (an expert bank's, a layer at a time);
    it is scaled in place, quantized by slices (``_quantize_slices``) and
    freed before the next draw.  At most one draw's float values are held
    beside the codes made so far: at command-r-35b 29.5 GB (w2) instead of
    the 121 GB tree, at qwen3-moe-30b-a3b 1.2 GB (the embedding) instead
    of 119 GB."""
    check_family(cfg)
    return fuse_decode_weights(draw_params(cfg, _param_tree, seed,
                                           policy or QuantPolicy(), device,
                                           hold),
                               cfg)


def meta_params(cfg: ModelConfig, tree=_param_tree) -> Params:
    """The tree ``init_params`` would draw (``tree``: ``_param_tree``, or
    ``encdec``'s), its leaves on the meta device: shapes and dtypes,
    nothing drawn or held."""
    meta = torch.device("meta")

    def leaf(path, shape, scale, dtype=None, by_layer=False):
        return torch.empty(shape, dtype=dtype or _pdt(cfg), device=meta)

    return tree(cfg, leaf, meta)


def init_bytes(cfg: ModelConfig, policy: Optional[QuantPolicy] = None) -> int:
    """Bytes of the tree ``init_params`` (no ``policy``) or
    ``init_quantized(cfg, seed, policy)`` (the fused operands included)
    would hold, counted on the meta device: nothing is drawn."""
    tree = meta_params(cfg)
    if policy is not None:
        tree = fuse_decode_weights(quantize_params(tree, policy), cfg)
    return count_bytes(tree)["total"]


# ---------------------------------------------------------------------------
# decode-weight fusion (7 GEMVs per layer -> 4)
# ---------------------------------------------------------------------------


def _merge_head_axes(w):
    """(*lead, H, hd, D) -> (*lead, H*hd, D); float or quantized."""
    if isinstance(w, QuantizedTensor):
        *lead, h, hd, _ = w.q.shape
        return qt_reshape_lead(w, *lead, h * hd)
    *lead, h, hd, d = w.shape
    return w.reshape(*lead, h * hd, d)


def _fold_head_axes(w):
    """(*lead, D, H, hd) -> (*lead, D, H*hd); float or quantized."""
    if isinstance(w, QuantizedTensor):
        return qt_fold_lead_into_groups(w)
    *lead, d, h, hd = w.shape
    return w.reshape(*lead, d, h * hd)


def _concat_rows(ws):
    if isinstance(ws[0], QuantizedTensor):
        return qt_concat(ws, axis=-2)
    return torch.cat(ws, dim=-2)


def fuse_decode_weights(params: Params, cfg: ModelConfig) -> Params:
    """Add the fused decode GEMV operands beside the per-projection weights:

        wqkv = [wq; wk; wv] -> ((H + 2*KVH) * hd, D)
        w13  = [w1; w3]     -> (2 * d_ff, D)
        wo_f = wo flattened -> (D, H * hd)

    Codes and scales are concatenated structurally, never requantized.  The
    per-projection weights stay: prefill reads the head-structured ones."""

    def fusable(ws):
        kinds = {isinstance(w, QuantizedTensor) for w in ws}
        if len(kinds) > 1:
            return False
        return not (kinds == {True}
                    and len({(w.group_size, w.bits) for w in ws}) > 1)

    def walk(d):
        if not isinstance(d, dict):
            return d
        out = {k: walk(v) for k, v in d.items()}
        if ({"wq", "wk", "wv", "wo"} <= set(out)
                and fusable([out["wq"], out["wk"], out["wv"]])):
            out["wqkv"] = _concat_rows([_merge_head_axes(out["wq"]),
                                        _merge_head_axes(out["wk"]),
                                        _merge_head_axes(out["wv"])])
            out["wo_f"] = _fold_head_axes(out["wo"])
        if ({"w1", "w3", "w2"} <= set(out) and "router" not in out
                and fusable([out["w1"], out["w3"]])):
            out["w13"] = _concat_rows([out["w1"], out["w3"]])
        return out

    return walk(params)


def _layer(tree, i):
    """Layer ``i`` (an index, or a tuple of indices into several leading
    axes) of a per-layer-stacked parameter or cache tree (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    if isinstance(tree, QuantizedTensor):
        return dataclasses.replace(tree, q=tree.q[i], scale=tree.scale[i])
    if isinstance(tree, tuple):
        return tuple(_layer(t, i) for t in tree)
    return tree[i]


def _block(params: Params, group: str, idx, sm=None):
    """Layer ``idx`` of the stacked parameter group ``group``; on a mesh
    (``sm``, a :class:`_ServeMesh`) its shards, gathered whole on use."""
    lp = _layer(params[group], idx)
    return lp if sm is None else sm.layer(lp, group, idx)


def _layers(params: Params, cfg: ModelConfig, sm=None):
    """The layers in the reference's order: (kind, the layer's parameters,
    its cache's key, its index there), kind ``"attn"`` for an attention
    block (dense, MoE, the interleave's pattern j of dense layers (j, i) in
    ``attn_dense`` and then its MoE layer j in ``attn_moe``, or the
    hybrid's shared block, whose j-th application reads ``cache["attn"]``
    layer j) or ``"ssm"`` for a Mamba2 layer.  On a mesh (``sm``) each
    layer's weights are gathered on use (:func:`_block`)."""
    if interleaved(cfg):
        n_pat, n_dense = _interleave_split(cfg)
        for j in range(n_pat):
            for i in range(n_dense):
                yield ("attn", _block(params, "blocks_dense", (j, i), sm),
                       "attn_dense", (j, i))
            yield ("attn", _block(params, "blocks_moe", j, sm), "attn_moe",
                   j)
        return
    if cfg.family == "hybrid":
        n_super, n_tail = _hybrid_split(cfg)
        for j in range(n_super):
            for i in range(cfg.attn_every):
                yield ("ssm", _block(params, "blocks_main", (j, i), sm),
                       "ssm_main", (j, i))
            yield "attn", params["shared_attn"], "attn", j
        for i in range(n_tail):
            yield ("ssm", _block(params, "blocks_tail", i, sm), "ssm_tail",
                   i)
        return
    kind, key = ("ssm", "ssm") if cfg.family == "ssm" else ("attn", "attn")
    for i in range(cfg.n_layers):
        yield kind, _block(params, "blocks", i, sm), key, i


def embed_inputs(params: Params, cfg: ModelConfig, batch: Dict[str, Any],
                 lookup=L.embed_lookup) -> torch.Tensor:
    """The batch's input embeddings in the compute dtype: its ``embeds``
    (B, S, D), precomputed by a modality frontend (a stub, as in the
    reference), or the embedding rows of its ``tokens`` by ``lookup``
    (training passes ``_TrainTP.embed``)."""
    if "embeds" in batch:
        return batch["embeds"].to(_cdt(cfg))
    return lookup(params["embed"], batch["tokens"]).to(_cdt(cfg))


def _default_positions(cfg: ModelConfig, b: int, s: int, batch,
                       dev: torch.device) -> torch.Tensor:
    """The batch's ``positions``, else 0..S-1 for every row, (B, S), as
    three equal streams (3, B, S) for mrope."""
    if "positions" in batch:
        return torch.as_tensor(batch["positions"]).to(dev)
    return _streams(cfg, torch.arange(s, dtype=torch.int32,
                                      device=dev).expand(b, s))


def _streams(cfg: ModelConfig, pos: torch.Tensor) -> torch.Tensor:
    """Text positions (...) as the rope tables take them: mrope's three
    equal streams (3, ...), else as they are."""
    return pos.expand(3, *pos.shape) if cfg.rope_type == "mrope" else pos


def _rope_cos_sin(cfg: ModelConfig, positions: torch.Tensor):
    """(cos, sin) (..., hd) at ``positions``, (...) for rope and (3, ...)
    for mrope; None for ``rope_type`` none."""
    if cfg.rope_type == "none":
        return None
    if cfg.rope_type == "mrope":
        return L.mrope_angles(positions, cfg.hd(), cfg.rope_theta,
                              cfg.mrope_sections)
    return L.rope_angles(positions, cfg.hd(), cfg.rope_theta)


def _mlp(p, x, cfg: ModelConfig, decode: bool = False, sm=None):
    """The block's MLP on the pre-norm hidden x, (B, S, D) or, at a decode
    step, (B, D), chosen by the block's tree as the reference's
    ``_mlp_or_moe`` chooses it.  ``mlp``: ``swiglu_mlp`` (norm2 fused into
    the w13 GEMV).  ``moe``: the plain norm, then ``moe_mlp`` as the
    reference runs it, the dense dispatch at a decode step (x as (B, 1, D))
    and the grouped one at the chunk, verify and one-shot prefill steps.
    On a mesh whose data axes split the rows (``sm.rows``) the grouped
    dispatch runs on every row, gathered, and the rank keeps its own: its
    expert products' shapes follow the row count, and so may their bits."""
    if "moe" not in p:
        return L.swiglu_mlp(p["mlp"], x,
                            L.norm_gamma(p["norm2"], cfg.norm_type), cfg.eps)
    h = L.apply_norm(x, p["norm2"], cfg.norm_type, cfg.eps)
    rows = None if sm is None or decode else sm.rows
    if rows is not None:
        h = sh.gather(h, (rows,), sm.mesh)
    y = L.moe_mlp(p["moe"], h[:, None] if decode else h,
                  n_experts=cfg.n_experts, top_k=cfg.top_k,
                  group_size=cfg.moe_group,
                  capacity_factor=cfg.capacity_factor,
                  dense_dispatch=decode)
    if rows is not None:
        y = sh.local_view(y, (rows,), sm.mesh)
    return (y[:, 0] if decode else y).to(x.dtype)


def _head(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Final norm, then the head tied with the embedding: pre-norm hidden
    rows (..., D) -> f32 logits (..., V).  Only the rows given are
    normalized."""
    gamma = L.norm_gamma(params["final_norm"], cfg.norm_type)
    return norm_qdot(x, gamma, cfg.eps, params["embed"]).float()


# ---------------------------------------------------------------------------
# KV caches: the paged pool and the dense per-slot reservation
# ---------------------------------------------------------------------------


# the dense cache's attention banks: one, or the interleave's two
ATTN_BANKS = ("attn", "attn_dense", "attn_moe")


def _kv_int8(cfg: ModelConfig) -> bool:
    return cfg.kv_cache_dtype == "int8"


def supports_paged_cache(cfg: ModelConfig) -> bool:
    return (cfg.family in ("dense", "vlm", "moe") and cfg.moe_every <= 1
            and cfg.n_heads > 0)


def _attn_bank(cfg: ModelConfig, lead: Tuple[int, ...],
               dev: torch.device, scratch: bool = False,
               stack: Tuple[int, ...] = (),
               kv_heads: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Stacked K/V buffers (*stack, *lead, KVH, hd) (``stack``: the layer
    axes, ``(n_layers,)`` by default; ``kv_heads``: KVH, the config's by
    default), plus one f32 scale per row and head
    for an int8 cache.  With ``scratch`` each buffer is a
    view of one with an extra block behind the last (``lead[0] + 1``
    blocks): the paged decode step sends the rows that must write nothing
    there (:func:`_scratch_view`), and nothing reads it."""
    kvd = torch.int8 if _kv_int8(cfg) else _cdt(cfg)
    shape = (*(stack or (cfg.n_layers,)), *lead,
             kv_heads or cfg.n_kv_heads, cfg.hd())
    dtypes = {"k": kvd, "v": kvd}
    if _kv_int8(cfg):
        dtypes.update(ks=torch.float32, vs=torch.float32)
    attn = {}
    for name, dt in dtypes.items():
        shp = shape if name in ("k", "v") else shape[:-1]
        if scratch:
            full = torch.zeros((shp[0], shp[1] + 1, *shp[2:]), dtype=dt,
                               device=dev)
            attn[name] = full[:, :shp[1]]
        else:
            attn[name] = torch.zeros(shp, dtype=dt, device=dev)
    return attn


def _scratch_view(buf: torch.Tensor) -> torch.Tensor:
    """One layer's pool (NB, BS, ...) with the scratch block NB that
    :func:`_attn_bank` keeps behind it (a view of the same storage)."""
    return torch.as_strided(buf, (buf.shape[0] + 1, *buf.shape[1:]),
                            buf.stride())


def _ssm_cache(cfg: ModelConfig, lead: Tuple[int, ...], batch: int,
               dev: torch.device) -> Dict[str, Any]:
    """Mamba2 layers' decode state stacked on ``lead``: ``conv``, the (x, B,
    C) rings of the last ``conv_width - 1`` pre-conv inputs, (*lead, batch,
    W-1, C) f32 each, and ``state`` (*lead, batch, H, P, N) f32."""
    d = _ssm_dims(cfg)
    gn, w1 = d.n_groups * d.state, cfg.conv_width - 1

    def zeros(*shape):
        return torch.zeros((*lead, batch, *shape), dtype=torch.float32,
                           device=dev)
    return {"conv": (zeros(w1, d.d_inner), zeros(w1, gn), zeros(w1, gn)),
            "state": zeros(d.n_heads, d.head_dim, d.state)}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device: Device = None) -> Cache:
    """Dense per-slot cache: ``attn``, K/V (n_layers, batch, max_seq, KVH,
    hd); for the interleave ``attn_dense`` (n_pat, moe_every - 1, batch,
    ...) and ``attn_moe`` (n_pat, batch, ...), as the reference's; for the
    SSM family ``ssm`` (``_ssm_cache``) instead; for the hybrid
    ``ssm_main`` (n_super, attn_every, batch, ...), ``ssm_tail`` and
    ``attn`` with one layer per application of the shared block."""
    dev = resolve_device(device)
    cache: Cache = {"lens": torch.zeros((batch,), dtype=torch.int32,
                                        device=dev)}
    if cfg.family == "ssm":
        cache["ssm"] = _ssm_cache(cfg, (cfg.n_layers,), batch, dev)
    elif cfg.family == "hybrid":
        n_super, n_tail = _hybrid_split(cfg)
        cache["ssm_main"] = _ssm_cache(cfg, (n_super, cfg.attn_every), batch,
                                       dev)
        cache["ssm_tail"] = _ssm_cache(cfg, (n_tail,), batch, dev)
        cache["attn"] = _attn_bank(cfg, (batch, max_seq), dev,
                                   stack=(n_super,))
    elif interleaved(cfg):
        n_pat, n_dense = _interleave_split(cfg)
        cache["attn_dense"] = _attn_bank(cfg, (batch, max_seq), dev,
                                         stack=(n_pat, n_dense))
        cache["attn_moe"] = _attn_bank(cfg, (batch, max_seq), dev,
                                       stack=(n_pat,))
    else:
        cache["attn"] = _attn_bank(cfg, (batch, max_seq), dev)
    return cache


def init_paged_cache(cfg: ModelConfig, batch: int, *, block_size: int = 64,
                     n_blocks: int, max_blocks_per_seq: int,
                     device: Device = None, mesh=None) -> Cache:
    """Block-pool KV cache + page table (rows of -1 where unassigned).
    With ``mesh`` the pool holds this rank's KV heads alone
    (``sharding.paged_cache_specs``: KVH split over ``model`` where it
    divides, else every head)."""
    if not supports_paged_cache(cfg):
        raise ValueError(f"paged cache unsupported for family {cfg.family}")
    dev = resolve_device(device)
    kvh = None if mesh is None else _ServeMesh.kv_range(cfg, mesh)[1]
    return {"lens": torch.zeros((batch,), dtype=torch.int32, device=dev),
            "page_table": torch.full((batch, max_blocks_per_seq), -1,
                                     dtype=torch.int32, device=dev),
            "attn": _attn_bank(cfg, (n_blocks, block_size), dev,
                               scratch=True, kv_heads=kvh)}


class _ServeMesh:
    """The storage-sharded, compute-replicated serving scheme on one rank
    of a mesh: the counterpart of the reference's ``_serve_mesh_helpers``,
    and of the GSPMD placement its ``jit_*`` serve wrappers give the dense
    cache.

    Weights are held sharded (``sharding.Sharded``: the tree of this rank's
    shards and its specs) and all-gathered whole at use, one layer at a
    time (``layer``), the unstacked leaves (the embedding, the final norm,
    the hybrid's shared block, the audio family's positions) at each call
    (``top``); every rank computes q, k, v, the MLP and the head of its
    rows whole from the whole weights.  The paged pool holds the rank's own
    KV heads (``kv_range``): both paged attentions run on them and their
    query heads (``q`` / ``kv``), and the output is all-gathered along
    heads (``heads``) before the wo contraction mixes them.  The dense
    cache holds the rank's part under ``cache_specs``
    (``sharding.cache_specs``: rows over the data axes, and KV heads, or
    else positions, SSM heads and the x conv ring's channels over
    ``model``): :func:`_dense_attention` and :func:`_ssm_decode_layer` say
    what a rank does with each.  A rank computes only its rows, but for
    the MoE's grouped dispatch at the prefill, which sees every row
    (:func:`_mlp`).  Every collective is an all-gather: no float reduction
    is split across ranks, so each rank computes the unsharded bits of its
    rows.  Replicated params (a plain tree, as the
    engine places them at model size 1) are read as they are; a cache
    without specs is held whole, and nothing is gathered around
    attention."""

    def __init__(self, cfg: ModelConfig, params, mesh, cache_specs=None):
        self.mesh = mesh
        self.cache_specs = cache_specs
        if isinstance(params, sh.Sharded):
            self.tree, self.specs = params.tree, params.specs
        else:
            self.tree, self.specs = params, None
        start, n = self.kv_range(cfg, mesh)
        g = cfg.n_heads // cfg.n_kv_heads if cfg.n_kv_heads else 0
        self.split = n < cfg.n_kv_heads
        self.kv = slice(start, start + n)
        self.q = slice(start * g, (start + n) * g)
        self.kv_heads, self.q_heads = n, n * g
        # the rows' spec entry where the data axes split the dense cache's
        # batch (its lens' spec), else None
        self.rows = None
        if cache_specs is not None and sh.live_axes(cache_specs["lens"][0],
                                                    mesh):
            self.rows = cache_specs["lens"][0]
        self.top = dict(self.tree)
        self._lead: Dict[str, Any] = {}
        if self.specs is not None:
            for k, v in self.tree.items():
                if k not in STACKED:
                    self.top[k] = sh.gather_tree(v, self.specs[k], mesh)

    @staticmethod
    def kv_range(cfg: ModelConfig, mesh) -> Tuple[int, int]:
        """(first, count) of the KV heads this rank's pool holds."""
        ax = sh.pool_model_axis(cfg, mesh)
        if ax is None:
            return 0, cfg.n_kv_heads
        return sh.shard_range(cfg.n_kv_heads, ax, mesh)

    def layer(self, lp, group: str = "blocks", idx=0):
        """Layer ``idx`` of the stacked group ``group`` whole: a view of
        the replicated tree, or its shards, each all-gathered at its first
        use (:class:`_OnUse`)."""
        if self.specs is None:
            return lp
        if group not in self._lead:
            n = len(idx) if isinstance(idx, tuple) else 1
            self._lead[group] = sh.drop_lead(self.specs[group], n)
        return _OnUse(lp, self._lead[group], self.mesh)

    def heads(self, out: torch.Tensor, dim: int) -> torch.Tensor:
        """The attention output of the rank's heads -> every head, along
        ``dim``."""
        if not self.split:
            return out
        return sh.all_gather_dim(out, dim, self.mesh.groups["model"],
                                 self.mesh.shape["model"])

    def cache_layer_specs(self, key: str, idx, lc):
        """The specs of layer ``idx`` of the dense cache's ``key`` (the
        layer's tree ``lc``) along ``model`` alone: the rank's rows are its
        own, and nothing is gathered over the data axes.  None for a cache
        held whole."""
        if self.cache_specs is None:
            return None
        n = len(idx) if isinstance(idx, tuple) else 1
        return sh.restrict_tree(lc, self.cache_specs[key], ("model",),
                                drop=n)

    def kv_slice(self, kvh: int, entry) -> Tuple[int, int]:
        """(first, count) of the dense cache's KV heads this rank holds of
        ``kvh``, split by the spec entry ``entry``."""
        return sh.shard_range(kvh, entry, self.mesh)

    def seq_slot(self, dst, start: int, n: int):
        """The new row's (slot, position) ``dst`` on the rank holding the
        positions ``start .. start + n - 1``: (rows, the local position,
        clamped into them), and which rows' positions it owns."""
        rows, pos = dst
        local = pos - start
        own = (local >= 0) & (local < n)
        return (rows, torch.clamp(local, 0, n - 1)), own


def _write_rows(lc: Dict[str, torch.Tensor], k, v, blk, off,
                own: Optional[torch.Tensor] = None) -> None:
    """Write K/V rows (..., KVH, hd) into one layer's cache at (blk, off)
    -- (block, offset) of the pool, or (slot, position) of the dense
    cache -- quantizing them for an int8 cache (one f32 scale per row and
    head).  ``own`` (B,) bool: a row whose flag is False writes back what
    the cache holds there (a rank of a sequence split writes only the rows
    whose position it holds)."""
    if "ks" in lc:
        kq, ks = quantize_rows(k)
        vq, vs = quantize_rows(v)
        new = {"k": kq, "v": vq, "ks": ks, "vs": vs}
    else:
        new = {"k": k.to(lc["k"].dtype), "v": v.to(lc["v"].dtype)}
    for name, t in new.items():
        if own is not None:
            keep = own.reshape(own.shape + (1,) * (t.dim() - 1))
            t = torch.where(keep, t, lc[name][blk, off])
        lc[name][blk, off] = t


# ---------------------------------------------------------------------------
# decode (paged pool or dense cache)
# ---------------------------------------------------------------------------


def _decode_qkv(lp, x, cfg: ModelConfig, cos, sin):
    """Pre-norm hidden (B, D) -> rotated q (B, H, hd) and k (B, KVH, hd),
    and v (B, KVH, hd): norm1 feeding one GEMV against the fused ``wqkv``
    when present (``norm_qdot``), then one ``rope`` launch over the q and k
    heads of the qkv row, read in place (the reference rotates q and k with
    two jnp ``apply_rope``s)."""
    b = x.shape[0]
    hd, nh, kvh = cfg.hd(), cfg.n_heads, cfg.n_kv_heads
    p_attn = lp["attn"]
    if "wqkv" in p_attn:
        gamma = L.norm_gamma(lp["norm1"], cfg.norm_type)
        heads = norm_qdot(x, gamma, cfg.eps, p_attn["wqkv"]).to(x.dtype)
        heads = heads.reshape(b, nh + 2 * kvh, hd)
    else:
        h = L.apply_norm(x, lp["norm1"], cfg.norm_type, cfg.eps)
        heads = torch.cat([qeinsum("bd,hkd->bhk", h, p_attn[w])
                           for w in ("wq", "wk", "wv")], dim=1)
    qk = ops.rope(heads[:, :nh + kvh], cos, sin)
    return qk[:, :nh], qk[:, nh:], heads[:, nh + kvh:]


def _decode_out_proj(p_attn, out, x_dtype):
    """Attention output (B, H, hd) -> residual (B, D) via ``wo_f``."""
    b, nh, hd = out.shape
    if "wo_f" in p_attn:
        return qdot(out.reshape(b, nh * hd), p_attn["wo_f"]).to(x_dtype)
    return qeinsum("bhk,dhk->bd", out, p_attn["wo"]).to(x_dtype)


class _OnUse(collections.abc.Mapping):
    """A tree of shards read as the whole tree: each leaf is all-gathered
    (``sharding.gather``) when it is first read, and kept for the rest of
    the call.  A step reads only the weights its path uses (the decode
    step the fused operands, the chunk step the head-structured ones), and
    every rank runs the same code, so the ranks gather the same leaves in
    the same order."""

    def __init__(self, shards, specs, mesh):
        self._shards, self._specs, self._mesh = shards, specs, mesh
        self._whole: Dict[str, Any] = {}

    def __getitem__(self, k):
        if k not in self._whole:
            v, spec = self._shards[k], self._specs[k]
            self._whole[k] = (_OnUse(v, spec, self._mesh)
                              if isinstance(v, dict)
                              else sh.gather(v, spec, self._mesh))
        return self._whole[k]

    def __iter__(self):
        return iter(self._shards)

    def __len__(self):
        return len(self._shards)


def _dense_attention(qs, k, v, lc, dst, lens_now, sm=None, spec=None):
    """Decode attention on one layer of the dense cache ``lc``: the new
    K/V rows (B, KVH, hd) written at (slot, position) ``dst`` (none when
    ``k`` is None: the audio family's cross cache), then ``decode_attention``
    of the pre-scaled q (B, H, hd) over each row's ``lens_now`` positions.

    On a mesh (``sm``, ``spec`` the layer's specs along ``model``,
    :meth:`_ServeMesh.cache_layer_specs`) the rank holds a part of the
    layer.  KV heads on ``model``: it writes and attends its own KV heads
    and their query heads, and the heads' outputs are all-gathered.
    Positions on ``model`` (the KV heads do not divide the axis): the rank
    writes the new row only where it holds the row's position, the
    layer's parts are gathered whole, and attention runs over the whole,
    so the result is one card's bit for bit (a flash-decode split merged
    by its log-sum-exp would sum in another order).  Neither: as one
    card."""
    kv_e = s_e = None
    if spec is not None:
        s_e, kv_e = spec["k"][1], spec["k"][2]          # (B, S, KVH, hd)
    mesh = None if sm is None else sm.mesh
    kv_split = kv_e is not None and bool(sh.live_axes(kv_e, mesh))
    seq_split = s_e is not None and bool(sh.live_axes(s_e, mesh))
    if kv_split:
        kvh = lc["k"].shape[2] * sh.parts(kv_e, mesh)
        start, n = sm.kv_slice(kvh, kv_e)
        g = qs.shape[1] // kvh
        qs = qs[:, start * g:(start + n) * g]
        if k is not None:
            k, v = k[:, start:start + n], v[:, start:start + n]
    own = None
    if seq_split and k is not None:
        s_loc = lc["k"].shape[1]
        start, n = sh.shard_range(s_loc * sh.parts(s_e, mesh), s_e, mesh)
        dst, own = sm.seq_slot(dst, start, n)
    if k is not None:
        _write_rows(lc, k, v, *dst, own=own)
    if seq_split:
        lc = {name: sh.gather(t, spec[name], mesh) for name, t in lc.items()}
    out = ops.decode_attention(qs, lc["k"], lc["v"], lens_now, lc.get("ks"),
                               lc.get("vs"))
    if kv_split:
        out = sh.gather(out, (None, kv_e, None), mesh)
    return out


def _attn_decode_layer(lp, x, cfg: ModelConfig, lc, rope, dst, lens_now,
                       qscale: float, pt=None, sm=None, spec=None):
    """One attention block at a decode step: q, k, v of the pre-norm x
    (B, D), the new K/V rows written at ``dst`` ((block, offset) of the
    paged pool when ``pt`` is its page table, else (slot, position) of
    the dense cache ``lc``), attention over each row's ``lens_now``
    positions (q scaled by ``qscale``), then the MLP.  On a mesh
    (``sm``, a :class:`_ServeMesh`) the rank writes and attends its own
    KV heads of the pool, and the heads are gathered before the out
    projection; on the dense cache it reads its part of the layer as
    ``spec`` says (:func:`_dense_attention`)."""
    q, k, v = _decode_qkv(lp, x, cfg, *rope)
    qs = q * qscale
    if pt is not None:
        if sm is not None:
            qs, k, v = qs[:, sm.q], k[:, sm.kv], v[:, sm.kv]
        _write_rows({n: _scratch_view(b) for n, b in lc.items()}, k, v, *dst)
        out = ops.paged_decode_attention(qs, lc["k"], lc["v"], pt, lens_now,
                                         lc.get("ks"), lc.get("vs"))
        if sm is not None:
            out = sm.heads(out, 1)
    else:
        out = _dense_attention(qs, k, v, lc, dst, lens_now, sm, spec)
    x = x + _decode_out_proj(lp["attn"], out, x.dtype)
    return x + _mlp(lp, x, cfg, decode=True)


def _ssm_decode_layer(lp, x, cfg: ModelConfig, lc, sm=None,
                      spec=None) -> torch.Tensor:
    """One Mamba2 layer at a decode step on the pre-norm x (B, D): norm1,
    ``ssm.mamba2_decode_step``, the residual; the layer's conv rings and
    state (``lc``, views of the cache) are overwritten in place by the new
    ones, which are fresh tensors, so no read follows a write.  On a mesh
    (``sm``, ``spec`` the layer's specs along ``model``) the rank's state
    heads and x-ring channels are gathered whole on use, the step runs on
    the whole, and the rank keeps its slice of the update."""
    h = L.apply_norm(x, lp["norm1"], cfg.norm_type, cfg.eps)
    conv, state = lc["conv"], lc["state"]
    specs = (None,) * (len(conv) + 1)
    if spec is not None:
        specs = (*spec["conv"], spec["state"])
        conv = tuple(sh.gather(c, s, sm.mesh)
                     for c, s in zip(conv, spec["conv"]))
        state = sh.gather(state, spec["state"], sm.mesh)
    y, (conv, state) = S.mamba2_decode_step(lp["ssm"], h, _ssm_dims(cfg),
                                            conv, state)
    for buf, new, s in zip((*lc["conv"], lc["state"]), (*conv, state),
                           specs):
        buf.copy_(new if s is None else sh.local_view(new, s, sm.mesh))
    return x + y


def decode_step(params: Params, cfg: ModelConfig, cache: Cache,
                tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None, mesh=None,
                cache_specs=None) -> Tuple[torch.Tensor, Cache]:
    """tokens (B,) -> (logits (B, V) f32, cache), on the paged pool when
    the cache carries a ``page_table``, else on the dense cache.

    Paged: each slot's new K/V row lands at its current (block, offset); a
    slot whose page-table entry there is -1 (released, or mid-prefill past
    its leased blocks) writes its row to the pool's scratch block instead,
    so a dead slot never corrupts blocks leased to others and the write
    keeps every row without the host reading which rows live; ``lens``
    comes back as ``pos + 1``, pinned to 0 where ``page_table[:, 0] < 0``.
    Dense: every row writes at its position, clamped to the last one as the
    reference's ``dynamic_update_slice`` clamps it, and ``lens`` comes back
    as ``pos + 1``.  Attention runs on ``paged_decode_attention`` /
    ``decode_attention`` (the CUDA kernels on the card, which read only each
    row's live positions; their plain versions on the CPU).  A Mamba2 layer
    advances every row's conv rings and SSM state by its token
    (``_ssm_decode_layer``).

    ``mesh`` (``launch/mesh.Mesh``) serves on one rank of a mesh:
    ``params`` are the rank's ``sharding.Sharded`` shards (or the whole
    tree, replicated).  The paged pool holds the rank's own KV heads.  The
    dense cache holds the rank's part under ``cache_specs``
    (``sharding.cache_specs`` of the whole cache; None: held whole), and
    ``tokens`` its rows: the rows the cache's batch axis gives it.  The
    logits of the rank's rows come back whole on every rank of the model
    axis (:class:`_ServeMesh`)."""
    paged = "page_table" in cache
    sm = None
    if mesh is not None:
        sm = _ServeMesh(cfg, params, mesh, None if paged else cache_specs)
        params = sm.top
    pos = cache["lens"] if positions is None else positions
    x = embed_inputs(params, cfg, {"tokens": tokens})
    rope = _rope_cos_sin(cfg, _streams(cfg, pos))
    qscale = _q_scale(cfg) if cfg.n_heads else None
    lens_now = (pos + 1).int()
    pt = dst = None
    if paged:
        pt = cache["page_table"]
        bs = cache["attn"]["k"].shape[2]
        mb = pt.shape[1]
        blk_idx = torch.clamp(pos // bs, 0, mb - 1).long()
        blk_id = torch.gather(pt, 1, blk_idx[:, None])[:, 0]
        # rows without a target block write to the scratch block (index
        # NB): a fixed row count, so the host never reads which rows live
        nb = cache["attn"]["k"].shape[1]
        dst = (torch.where(blk_id >= 0, blk_id, nb).long(),
               (pos % bs).long())
    elif any(key in cache for key in ATTN_BANKS):
        bank = next(key for key in ATTN_BANKS if key in cache)
        s = cache[bank]["k"].shape[-3]
        if sm is not None and cache_specs is not None:
            s *= sh.parts(cache_specs[bank]["k"][-3], mesh)
        dst = (torch.arange(pos.shape[0], device=pos.device),
               torch.clamp(pos, 0, s - 1).long())

    for kind, lp, key, idx in _layers(params, cfg, sm):
        lc = _layer(cache[key], idx)
        spec = (None if sm is None or paged
                else sm.cache_layer_specs(key, idx, lc))
        if kind == "ssm":
            x = _ssm_decode_layer(lp, x, cfg, lc, sm, spec)
        else:
            x = _attn_decode_layer(lp, x, cfg, lc, rope, dst, lens_now,
                                   qscale, pt, sm, spec)

    logits = _head(params, cfg, x)
    new_cache = dict(cache)
    new_cache["lens"] = (torch.where(pt[:, 0] >= 0, lens_now,
                                     torch.zeros_like(lens_now))
                         if paged else lens_now)
    return logits, new_cache


# ---------------------------------------------------------------------------
# one-shot prefill into the dense cache
# ---------------------------------------------------------------------------


def _attn_seq(p, x, cfg: ModelConfig, cos, sin):
    """x (B, S, D) -> (attention output (B, S, D), the layer's (k, v)).

    The Q/K/V/O projections go through the dequant ``qeinsum`` whatever the
    strategy, as in the reference.  The reference pre-scales q by hd^-1/2
    in the compute dtype for its jnp ``attention_scores_blockwise``; so
    does a bf16 config here (hd^-1/2 rounded to bf16 first, then the
    product rounded, ``_q_scale``), and ``flash_prefill`` scales by 1.  An
    f32 config's q goes in unscaled and the kernel scales it in f32, as
    the TPU kernel does (pre-scaling would round an f32 q a second
    time)."""
    h = L.apply_norm(x, p["norm1"], cfg.norm_type, cfg.eps)
    q = qeinsum("bsd,hkd->bshk", h, p["attn"]["wq"])
    k = qeinsum("bsd,hkd->bshk", h, p["attn"]["wk"])
    v = qeinsum("bsd,hkd->bshk", h, p["attn"]["wv"])
    q = L.apply_rope(q, cos[:, :, None], sin[:, :, None])
    k = L.apply_rope(k, cos[:, :, None], sin[:, :, None])
    out = qeinsum("bshk,dhk->bsd", prefill_attention(q, k, v, cfg),
                  p["attn"]["wo"])
    return out.to(x.dtype), (k, v)


def prefill_attention(q, k, v, cfg: ModelConfig,
                      causal: bool = True) -> torch.Tensor:
    """q (B, Sq, H, hd) unscaled, k/v (B, Sk, KVH, hd) -> (B, Sq, H, hd)
    on ``ops.flash_prefill``, q scaled as ``_attn_seq`` says."""
    if q.dtype == torch.float32:
        return ops.flash_prefill(q, k, v, causal=causal)
    return ops.flash_prefill(q * _q_scale(cfg), k, v, causal=causal,
                             scale=1.0)


def forward_layers(params: Params, cfg: ModelConfig, x: torch.Tensor,
                   positions: torch.Tensor, sm=None):
    """x (B, S, D) input embeddings at ``positions`` ((B, S), or (3, B, S)
    for mrope) -> (hidden (B, S, D) before the final norm, each layer's
    (cache key, index, state)): an attention block's (k, v) (B, S, KVH,
    hd), a Mamba2 layer's (conv rings, SSM state)
    (``ssm.mamba2_forward``).  The head's ``_head`` normalizes only the
    rows it reads.  On a mesh (``sm``) each layer's weights are gathered
    on use."""
    rope = _rope_cos_sin(cfg, positions)
    parts = []
    for kind, lp, key, idx in _layers(params, cfg, sm):
        if kind == "ssm":
            h = L.apply_norm(x, lp["norm1"], cfg.norm_type, cfg.eps)
            y, part = S.mamba2_forward(lp["ssm"], h, _ssm_dims(cfg),
                                       cfg.ssm_chunk)
            x = x + y
        else:
            a, part = _attn_seq(lp, x, cfg, *rope)
            x = x + a
            x = x + _mlp(lp, x, cfg, sm=sm)
        parts.append((key, idx, part))
    return x, parts


def prefill(params: Params, cfg: ModelConfig, batch: Dict[str, Any],
            max_seq: Optional[int] = None, mesh=None,
            cache_specs=None) -> Tuple[torch.Tensor, Cache]:
    """Whole prompts in one pass: ``batch["tokens"]`` (B, S), or the
    ``embeds`` (B, S, D) of a modality frontend, at ``batch["positions"]``
    ((B, S), or (3, B, S) for mrope; default 0..S-1 in every stream).
    Returns the last position's logits (B, V) f32 and a dense cache of
    ``max_seq`` positions (default S) holding the prompts' K/V (and, for
    the SSM families, each Mamba2 layer's conv rings and final state,
    cast to the cache's f32), ``lens = S``.  Runs where the parameters
    live.

    ``mesh``: one rank of a mesh, as :func:`decode_step` serves on it.
    ``params`` are the rank's ``sharding.Sharded`` shards, ``batch`` its
    rows; the rank computes its rows replicated over ``model`` and keeps
    its part of the cache under ``cache_specs`` (the whole cache's specs;
    None: the cache whole)."""
    sm = None
    if mesh is not None:
        sm = _ServeMesh(cfg, params, mesh, cache_specs)
        params = sm.top
    dev = params["final_norm"]["gamma"].device
    batch = dict(batch)
    if "embeds" in batch:
        batch["embeds"] = torch.as_tensor(batch["embeds"]).to(dev)
        b, s = batch["embeds"].shape[:2]
    else:
        tokens = batch["tokens"]
        if not isinstance(tokens, torch.Tensor):
            tokens = torch.as_tensor(np.asarray(tokens, np.int64))
        batch["tokens"] = tokens.to(dev)
        b, s = tokens.shape
    positions = _default_positions(cfg, b, s, batch, dev)
    hidden, parts = forward_layers(params, cfg,
                                   embed_inputs(params, cfg, batch),
                                   positions, sm)
    cache = init_cache(cfg, b, max_seq or s, device=dev)
    cache["lens"].fill_(s)
    for key, idx, part in parts:
        lc = _layer(cache[key], idx)
        if key in ATTN_BANKS:
            _write_rows(lc, *part, slice(None), slice(0, s))
            continue
        conv, state = part
        for buf, c in zip(lc["conv"], conv):
            buf.copy_(c)
        lc["state"].copy_(state)
    return _head(params, cfg, hidden[:, -1]), keep_part(cache, cache_specs,
                                                        mesh)


def keep_part(cache: Cache, cache_specs, mesh) -> Cache:
    """A dense cache computed whole over ``model`` for a rank's rows ->
    the rank's part of it under ``cache_specs`` (a copy of each part
    alone; ``cache`` itself with no mesh or no specs)."""
    if mesh is None or cache_specs is None:
        return cache
    return sh.shard(cache, sh.restrict_tree(cache, cache_specs, ("model",)),
                    mesh)


# ---------------------------------------------------------------------------
# training: the full-sequence forward and the chunked cross-entropy
# ---------------------------------------------------------------------------


def remat(cfg: ModelConfig, fn, *args):
    """``fn(*args)``; under ``cfg.remat == "block"`` (every config's
    default) while autograd records, its intermediates are recomputed in
    the backward pass instead of held (the reference's ``_maybe_remat``,
    ``jax.checkpoint``): the values are the same either way."""
    if cfg.remat not in ("none", "block"):
        raise NotImplementedError(f"remat {cfg.remat!r}")
    if cfg.remat == "block" and torch.is_grad_enabled():
        _import_checkpoint_deps()
        # the forward draws no random numbers: no RNG state to replay
        return torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def _import_checkpoint_deps() -> None:
    """Import ``torch._dynamo``, which ``torch.utils.checkpoint`` imports
    at its first call, on a thread of its own.  Imported inside the
    caller's stack, it leaves that stack's frames, and the parameters and
    optimizer state their locals hold, in a reference cycle until the next
    collection (``torch.fx``'s ``wrap`` keeps its own frame, whose
    ``f_back`` chain reaches the caller's).  A thread's stack holds none of
    the caller's frames."""
    if "torch._dynamo" in sys.modules:
        return
    failed = []

    def load():
        try:
            importlib.import_module("torch._dynamo")
        except Exception as e:                         # noqa: BLE001
            failed.append(e)
    t = threading.Thread(target=load, name="import-torch-dynamo")
    t.start()
    t.join()
    if failed:
        raise failed[0]


class _Unbound:
    """A layer-stacked tensor unbound once along its leading axis: indexing
    it gives a layer's view (``_layer``), and autograd stacks the layers'
    gradients once, where a ``select`` per layer would build a zero-filled
    gradient of the whole stack for each layer."""

    def __init__(self, t: torch.Tensor):
        self.parts = t.unbind(0)

    def __getitem__(self, i):
        if isinstance(i, tuple):
            return self.parts[i[0]][i[1:]]
        return self.parts[i]


# the parameter groups stacked per layer on their leading axis
STACKED = ("blocks", "blocks_dense", "blocks_moe", "blocks_main",
           "blocks_tail", "enc_blocks", "dec_blocks")


def unbind_stacks(params: Params) -> Params:
    """``params`` with every tensor of a layer-stacked group an
    ``_Unbound``, for a training forward that reads each layer once."""
    def unbind(t):
        if isinstance(t, dict):
            return {k: unbind(v) for k, v in t.items()}
        return _Unbound(t)
    return {k: unbind(v) if k in STACKED else v for k, v in params.items()}


def train_attention(q, k, v, cfg: ModelConfig,
                    causal: bool = True) -> torch.Tensor:
    """The training forward's attention: q (B, Sq, H, hd) unscaled, k/v
    (B, Sk, KVH, hd) -> (B, Sq, H, hd) on the reference's own jnp function,
    ``layers.attention_scores_blockwise`` in ``cfg.q_chunk`` query rows, q
    scaled by hd^-1/2 in the compute dtype first (``_q_scale``).  The head
    counts are the tensors' (a rank of a train mesh passes its own heads).
    Never ``ops.flash_prefill``: the reference's training runs no kernel,
    and the CUDA kernel has no backward, so autograd would not reach wq /
    wk / wv through it."""
    acfg = L.AttnConfig(q.shape[2], k.shape[2], cfg.hd(),
                        q_chunk=cfg.q_chunk, causal=causal)
    return L.attention_scores_blockwise(q * _q_scale(cfg), k, v, acfg)


def _attn_block_train(p, x, cfg: ModelConfig, rope, tp: "_TrainTP"):
    """One attention block over x (B, S, D), as the reference's
    ``_dense_block_seq``: attention (rope where the config has it), then
    the MLP or the MoE's grouped dispatch (``_mlp``), both as ``tp``
    computes them (on the rank's shards on a train mesh)."""
    h = L.apply_norm(x, p["norm1"], cfg.norm_type, cfg.eps)
    x = x + tp.attention(p["attn"], h, cfg, rope).to(x.dtype)
    return x + tp.mlp(p, x, cfg)


def _ssm_block_train(p, x, cfg: ModelConfig, rope, tp: "_TrainTP"):
    h = L.apply_norm(x, p["norm1"], cfg.norm_type, cfg.eps)
    y, _ = S.mamba2_forward(p["ssm"], h, _ssm_dims(cfg), cfg.ssm_chunk)
    return x + y


def forward_hidden(params: Params, cfg: ModelConfig, x: torch.Tensor,
                   positions: torch.Tensor, tp: "_TrainTP") -> torch.Tensor:
    """x (B, S, D) input embeddings at ``positions`` ((B, S), or (3, B, S)
    for mrope) -> the hidden states (B, S, D) after the final norm: the
    reference's ``forward_hidden`` for training, every layer in its order
    (``_layers``, on ``unbind_stacks``' views), each under ``remat``, each
    attention block as ``tp`` computes it."""
    rope = _rope_cos_sin(cfg, positions)
    for kind, lp, _, _ in _layers(unbind_stacks(params), cfg):
        block = _ssm_block_train if kind == "ssm" else _attn_block_train
        x = remat(cfg, block, lp, x, cfg, rope, tp)
    return L.apply_norm(x, params["final_norm"], cfg.norm_type, cfg.eps)


def batch_to(batch: Dict[str, Any], dev: torch.device) -> Dict[str, Any]:
    """A batch of numpy arrays or tensors as tensors on ``dev``: token ids
    and labels as int64, every other entry in its own dtype."""
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.as_tensor(
            np.asarray(v))
        out[k] = t.to(dev, torch.long if k in ("tokens", "labels") else None)
    return out


def _ce_sum(w, h: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Summed cross-entropy of one chunk: the head's f32 logits
    (``layers.lm_head``: the product in h's dtype, then f32), logsumexp
    less the label's logit."""
    logits = qdot(h, w).float()
    tgt = torch.gather(logits, -1, y[..., None])[..., 0]
    return torch.sum(torch.logsumexp(logits, dim=-1) - tgt)


def chunked_ce(cfg: ModelConfig, w, hidden: torch.Tensor,
               labels: torch.Tensor, tp: "_TrainTP", chunk: int = 512,
               tokens: Optional[int] = None) -> torch.Tensor:
    """Cross-entropy of hidden (B, S, D) against labels (B, S) with the
    head ``w`` (V, D), ``chunk`` positions at a time (lowered until it
    divides S) so the logits never stand at (B, S, V): the f32 chunk sums
    (``tp.ce_sum``) added in order, each under ``remat``, divided by
    ``tokens`` (the global batch's token count on a mesh; B * S by
    default)."""
    b, s = labels.shape
    c = min(chunk, s)
    while s % c:
        c -= 1
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, s, c):
        total = total + remat(cfg, tp.ce_sum, w, hidden[:, i:i + c],
                              labels[:, i:i + c])
    return total / (tokens or b * s)


class _TrainTP:
    """Megatron tensor parallelism of the dense, vlm and MoE families over
    the ``model`` axis of a train mesh, and the MoE's expert parallelism,
    on one rank: what GSPMD makes of the reference's train-mode specs
    (``sharding.param_specs(mode="train")``).  The rank holds its shards of
    those specs and computes with them; the residual stream and the norms
    stay replicated, and each region whose ranks compute parts opens with
    *f* (``collectives.copy_to``) and closes with *g*
    (``collectives.reduce_from``):

    * attention by query heads when ``n_heads`` divides the axis: the KV
      heads with them when ``n_kv_heads`` divides it too, else held whole,
      each rank projecting only the KV heads its query heads read (one a
      query head; *f* on the weight sums its gradient over the axis);
      ``wo`` row-parallel.  When neither divides and ``head_dim`` does
      (the reference's fallback), q, k and v are projected on the rank's
      head-dim slice and gathered, attention is computed whole, and ``wo``
      is row-parallel over the rank's head-dim slice.
    * MLP: ``w1`` / ``w3`` column-parallel, ``w2`` row-parallel.
    * MoE (``experts``): the router and the grouped dispatch run on the
      rank's own rows (a group never spans rows, so capacity and drops
      are the unsharded ones).  Where the experts' axis also splits the
      rows (``ep_data``'s ``data``), the capacity buffer goes to the
      experts' owners by an all-to-all (``collectives.to_owners``), the
      owner computes its experts on every rank's slots and the results
      come back (``from_owners``) to be combined locally; where the rows
      are the same along it (``moe_shard="model"``), each rank computes
      its experts on the shared slots (*f* on the slots and the combine
      weights) and *g* sums the combine.  d_ff split over ``model``
      (``ep_data``) makes ``w1`` / ``w3`` column-parallel and ``w2``
      row-parallel inside the experts.  No bank is gathered: an expert's
      gradient is whole on its owner, summed over no axis that splits it
      (``launch/steps.reduce_grads``).
    * the tied embedding by vocab rows: a masked lookup of the rank's rows
      summed over the axis; each loss chunk's logsumexp from the ranks'
      row maxima and sums of exponentials, the label's logit from the rank
      that holds it (``target_logit``).

    A part the specs leave whole (a dim the axis does not divide) is
    computed whole, as the unsharded forward computes it.  The partial
    sums are reduced in f32.  With no ``mesh``, or where the specs split
    nothing, it splits nothing: every method is then the unsharded
    forward's ops and nothing more, the training forward of every family
    without a mesh and of the families that compute replicated on one
    (``train_view``)."""

    def __init__(self, cfg: ModelConfig, mesh=None, specs=None,
                 batch_axes: tuple = ()):
        self.attn, self.kv_whole = None, False
        self.mlp_split = self.vocab_split = False
        self.expert_axis, self.expert_f_split = None, False
        self.e_exchange = False
        self.on_mesh = mesh is not None
        if mesh is None:
            self.group, self.n, self.r = None, 1, 0
            return
        self.group, self.n, self.r = C.axis(mesh, "model")
        # the stacked block groups: ``blocks``, or the interleave's
        # ``blocks_dense`` and ``blocks_moe``
        blks = [specs[k] for k in ("blocks", "blocks_dense", "blocks_moe")
                if k in specs]
        attn = blks[0]["attn"]
        mlp = next((b["mlp"] for b in blks if "mlp" in b), None)
        moe = next((b["moe"] for b in blks if "moe" in b), None)

        def split(spec, dim):
            return bool(sh.live_axes(spec[dim], mesh))
        # wq / wk / wv (L, H, hd, D), w1 (L, F, D), embed (V, D)
        self.attn = ("heads" if split(attn["wq"], -3)
                     else "hd" if split(attn["wq"], -2) else None)
        self.kv_whole = self.attn == "heads" and not split(attn["wk"], -3)
        self.mlp_split = mlp is not None and split(mlp["w1"], -2)
        self.vocab_split = split(specs["embed"], 0)
        if moe is not None:
            # experts' w1 (L, E, F, D): the axis that splits E, and whether
            # it splits the rows too; F over ``model``
            e_axes = sh.live_axes(moe["w1"][-3], mesh)
            if len(e_axes) > 1:
                raise NotImplementedError(
                    f"experts split as {moe['w1']} on a mesh of "
                    f"{mesh.shape}")
            if e_axes:
                self.expert_axis = e_axes[0]
                self.e_group, self.e_n, self.e_r = C.axis(mesh, e_axes[0])
                self.e_exchange = e_axes[0] in batch_axes
            self.expert_f_split = split(moe["w1"], -2)
        if self.kv_whole:
            nq, g = cfg.n_heads // self.n, cfg.n_heads // cfg.n_kv_heads
            kv = [(self.r * nq + i) // g for i in range(nq)]
            self.kv_rows = slice(kv[0], kv[-1] + 1)
            self.kv_pick = [h - kv[0] for h in kv]

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return C.copy_to(x, self.group, self.n)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return C.reduce_from(x, self.group, self.n)

    def attention(self, p, h, cfg: ModelConfig, rope) -> torch.Tensor:
        """The block's attention output (B, S, D) from the normed h."""
        hf = h if self.attn is None else self.copy(h)
        q = qeinsum("bsd,hkd->bshk", hf, p["wq"])
        if self.kv_whole:
            pick = torch.tensor(self.kv_pick, device=h.device)
            k, v = (qeinsum("bsd,hkd->bshk", hf,
                            self.copy(p[w])[self.kv_rows]).index_select(
                                2, pick) for w in ("wk", "wv"))
        else:
            k = qeinsum("bsd,hkd->bshk", hf, p["wk"])
            v = qeinsum("bsd,hkd->bshk", hf, p["wv"])
        if self.attn == "hd":
            q, k, v = (C.gather_from(t, 3, self.group, self.n, self.r)
                       for t in (q, k, v))
        if rope is not None:
            cos, sin = rope
            q = L.apply_rope(q, cos[:, :, None], sin[:, :, None])
            k = L.apply_rope(k, cos[:, :, None], sin[:, :, None])
        out = train_attention(q, k, v, cfg)
        if self.attn == "hd":
            out = C.split_to(out, 3, self.group, self.n, self.r)
        y = qeinsum("bshk,dhk->bsd", out, p["wo"])
        return y if self.attn is None else self.reduce(y.float())

    def mlp(self, p, x, cfg: ModelConfig) -> torch.Tensor:
        """The block's SwiGLU MLP, or its MoE, on the pre-norm x."""
        if "moe" in p:
            return self.moe(p, x, cfg)
        if not self.mlp_split:
            return _mlp(p, x, cfg)
        w = p["mlp"]
        hf = self.copy(L.rms_norm(x, L.norm_gamma(p["norm2"], cfg.norm_type),
                                  cfg.eps))
        h = torch.nn.functional.silu(qdot(hf, w["w1"])) * qdot(hf, w["w3"])
        return self.reduce(qdot(h.to(x.dtype), w["w2"]).float()).to(x.dtype)

    def moe(self, p, x, cfg: ModelConfig) -> torch.Tensor:
        """The block's MoE on the pre-norm x: the reference's grouped
        dispatch on the rank's rows, its expert products on the rank's
        shards of the banks (``experts``); with no mesh, ``_mlp``'s."""
        if not self.on_mesh:
            return _mlp(p, x, cfg)
        h = L.apply_norm(x, p["norm2"], cfg.norm_type, cfg.eps)
        return L.moe_mlp(p["moe"], h, n_experts=cfg.n_experts,
                         top_k=cfg.top_k, group_size=cfg.moe_group,
                         capacity_factor=cfg.capacity_factor,
                         experts=self.experts).to(x.dtype)

    def experts(self, p, xin: torch.Tensor, combine: torch.Tensor
                ) -> torch.Tensor:
        """The combined expert outputs (G, Sg, D) f32 of the rank's
        capacity buffer xin (E, G, C, D) under ``combine`` (G, Sg, E, C),
        with the rank's shards of the banks (class docstring)."""
        shared = self.expert_axis is not None and not self.e_exchange
        if self.e_exchange:
            xin = C.to_owners(xin, self.e_group, self.e_n)
        if shared:
            # the ranks' gradients of the shared slots and combine weights
            # are each their own experts' part: *f* sums them
            xin, combine = (C.copy_to(t, self.e_group, self.e_n)
                            for t in (xin, combine))
            mine = slice(self.e_r * xin.shape[0] // self.e_n,
                         (self.e_r + 1) * xin.shape[0] // self.e_n)
            xin, combine = xin[mine], combine[:, :, mine]
        if self.expert_f_split:
            xin = self.copy(xin)
        yo = L.expert_ffn(p, xin)
        if self.expert_f_split:
            yo = self.reduce(yo)
        if self.e_exchange:
            yo = C.from_owners(yo, self.e_group, self.e_n)
        y = torch.einsum("gsec,egcd->gsd", combine, yo)
        return C.reduce_from(y, self.e_group, self.e_n) if shared else y

    def _rows(self, t: torch.Tensor) -> int:
        """The first vocab row of the rank's shard ``t`` (V / n rows)."""
        return self.r * t.shape[0]

    def embed(self, table: torch.Tensor, tokens: torch.Tensor):
        """Embedding rows of ``tokens`` from the rank's vocab rows."""
        if not self.vocab_split:
            return L.embed_lookup(table, tokens)
        n = table.shape[0]
        local = tokens.long() - self._rows(table)
        hit = (local >= 0) & (local < n)
        rows = table[local.clamp(0, n - 1)]
        return self.reduce(torch.where(hit[..., None], rows,
                                       torch.zeros_like(rows)))

    def target_logit(self, logits: torch.Tensor, y: torch.Tensor,
                     start: int) -> torch.Tensor:
        """The label's logit where the rank holds its vocab row, else 0."""
        n = logits.shape[-1]
        local = y - start
        hit = (local >= 0) & (local < n)
        t = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
        return torch.where(hit, t, torch.zeros_like(t))

    def ce_sum(self, w, h: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """``_ce_sum`` of one chunk on the rank's vocab rows of ``w``."""
        if not self.vocab_split:
            return _ce_sum(w, h, y)
        logits = qdot(self.copy(h), w).float()
        mx = C.all_reduce_max(logits.amax(-1), self.group, self.n)
        se = self.reduce(torch.sum(torch.exp(logits - mx[..., None]), -1))
        tgt = self.reduce(self.target_logit(logits, y, self._rows(w)))
        return torch.sum(mx + torch.log(se) - tgt)


# the families whose blocks are attention + SwiGLU or MoE, which train on
# their shards under ``_TrainTP``
TP_FAMILIES = ("dense", "vlm", "moe")


def train_view(params: Params, cfg: ModelConfig, mesh=None, specs=None,
               batch_axes=None):
    """What a rank computes its training loss with: (parameters, its
    :class:`_TrainTP`, the ranks its batch rows are one part of).  On a
    train ``mesh`` ``params`` hold the rank's shards of ``specs`` (the
    train-mode parameter specs, ``jit_train_step``'s) and the batch is
    split over ``batch_axes`` (the batch spec's axes, which a mesh
    needs).  The dense, vlm and MoE families
    (``TP_FAMILIES``) compute on their shards under a ``_TrainTP`` of the
    specs; every other family gathers each leaf whole
    (``sharding.gather_for_grad``: its gradient is the rank's own slice)
    and computes replicated.  No mesh: (params, a ``_TrainTP`` that splits nothing,
    1)."""
    if mesh is None:
        return params, _TrainTP(cfg), 1
    if batch_axes is None:
        raise ValueError("a train mesh needs the batch spec's axes "
                         "(sharding.train_batch_axes)")
    baxes = tuple(batch_axes)
    dp = math.prod(mesh.shape[a] for a in baxes)
    if cfg.family in TP_FAMILIES and cfg.train_shard == "tp":
        return params, _TrainTP(cfg, mesh, specs, baxes), dp
    return sh.gather_for_grad(params, specs, mesh), _TrainTP(cfg), dp


def lm_loss(params: Params, cfg: ModelConfig, batch: Dict[str, Any],
            chunk: int = 512, mesh=None, specs=None,
            batch_axes=None) -> torch.Tensor:
    """The training loss: ``batch["labels"]`` (B, S) against the model on
    its ``tokens`` (B, S) or the ``embeds`` (B, S, D) of a modality
    frontend, at ``batch["positions"]`` (default 0..S-1 in every stream).
    Runs where the parameters live; differentiable in every float leaf.
    On a train ``mesh`` (``launch/steps.py``'s ``jit_train_step``)
    ``params`` are the rank's shards of ``specs`` and ``batch`` its rows
    (``train_view``, the batch split over ``batch_axes``): the rows'
    summed cross-entropy over the global batch's token count, whose sum
    over the batch axes is the loss."""
    dev = params["final_norm"]["gamma"].device
    batch = batch_to(batch, dev)
    b, s = batch["labels"].shape
    params, tp, dp = train_view(params, cfg, mesh, specs, batch_axes)
    positions = _default_positions(cfg, b, s, batch, dev)
    hidden = forward_hidden(params, cfg,
                            embed_inputs(params, cfg, batch, tp.embed),
                            positions, tp)
    return chunked_ce(cfg, params["embed"], hidden, batch["labels"], tp,
                      chunk, tokens=b * s * dp)


# ---------------------------------------------------------------------------
# chunked prefill
# ---------------------------------------------------------------------------

# distinct padded (B, c) extents + pool shapes the chunk step and its verify
# twin have run with, per config: the counterpart of the reference's compile
# counts (one specialization per pool key and entry).  The two entries keep
# separate sets, as the reference keeps two jit entries.
_CHUNK_KEYS: Dict[ModelConfig, set] = {}
_VERIFY_KEYS: Dict[ModelConfig, set] = {}


def prefill_fused_mode(device: Device = None) -> str:
    """Which prefix-attention path the chunk step takes on ``device`` (the
    card by default): ``"kernel"``, the CUDA ``paged_prefill_attention``
    reading the prefix through the page table, on CUDA; ``"oracle"``, its
    plain version (a gather and ``attention_chunk_merge``'s merge), on the
    CPU.  The tensor's device decides, as ``kernels/ops.py`` dispatches:
    nothing switches the kernel off on the card (the reference's
    ``REPRO_FUSED_PREFILL`` has no counterpart)."""
    return "kernel" if resolve_device(device).type == "cuda" else "oracle"


def _mesh_key(mesh):
    """The mesh shape a compile key carries: None off a mesh."""
    return None if mesh is None else tuple(
        (a, mesh.shape[a]) for a in mesh.axis_names)


def prefill_chunk_compiles(cfg: ModelConfig, mesh=None) -> int:
    """How many distinct padded shapes the chunk step has run with for
    ``cfg`` on meshes of ``mesh``'s shape (none: off a mesh) in this
    process -- the shape-stability probe.  One per (pool key, mesh
    shape), as the reference's jit entries are kept per mesh."""
    want = _mesh_key(mesh)
    return sum(k[0] == want for k in _CHUNK_KEYS.get(cfg, ()))


def verify_chunk_compiles(cfg: ModelConfig, mesh=None) -> int:
    """The same probe for the verify entry (:func:`verify_chunk_batch`):
    the engine pads every verify call to one ``(max_slots, spec_tokens +
    1)`` extent, so this too stays at one per (pool key, mesh shape)."""
    want = _mesh_key(mesh)
    return sum(k[0] == want for k in _VERIFY_KEYS.get(cfg, ()))


@dataclasses.dataclass
class _ChunkArgs:
    toks: torch.Tensor       # (B, c) int64
    pt_rows: torch.Tensor    # (B, MB) int32, -1 -> 0, dead rows all 0
    offs: torch.Tensor       # (B,) int32 position offsets
    lens: torch.Tensor       # (B,) int32 valid rows (0 for padding rows)
    w_row: torch.Tensor      # (N,) batch row of each valid chunk position
    w_col: torch.Tensor      # (N,) its column in the chunk
    w_blk: torch.Tensor      # (N,) its pool block
    w_off: torch.Tensor      # (N,) its offset in the block
    slot_idx: torch.Tensor   # (S,) slots of the non-padding rows
    slot_row: torch.Tensor   # (S,) their batch rows


def _chunk_call_args(tokens_chunks, cache: Cache, slots, pos_offsets,
                     page_table, chunk_lens) -> _ChunkArgs:
    """Host-side addressing of a chunk step: each valid chunk position's
    (block, offset) in its own leased blocks.  Positions past a row's valid
    length and padding rows (negative slot) write nothing."""
    if "page_table" not in cache:
        raise ValueError("prefill_chunk requires a paged cache "
                         "(init_paged_cache)")
    toks = np.asarray(tokens_chunks, np.int64)
    b, c = toks.shape
    slots = np.asarray(slots, np.int32).reshape(-1)
    offs = np.broadcast_to(np.asarray(pos_offsets, np.int32), (b,))
    lens = (np.full((b,), c, np.int32) if chunk_lens is None
            else np.asarray(chunk_lens, np.int32).reshape(-1))
    valid = slots >= 0
    live = slots[valid]
    if len(set(live.tolist())) != len(live):
        raise ValueError(f"slots {slots} must be distinct where valid")
    bs = cache["attn"]["k"].shape[2]
    pt = np.asarray(cache["page_table"].cpu() if page_table is None
                    else page_table)
    mb = pt.shape[1]
    live_row = valid & (lens > 0)                       # rows that write
    rows = pt[np.where(live_row, slots, 0)]             # (b, mb)
    gpos = offs[:, None] + np.arange(c, dtype=np.int32)[None]     # (b, c)
    in_len = np.arange(c, dtype=np.int32)[None] < lens[:, None]   # (b, c)
    row_blk = np.take_along_axis(rows, np.minimum(gpos // bs, mb - 1),
                                 axis=1)                # (b, c)
    mask = in_len & live_row[:, None]
    bad = ((row_blk < 0) | (gpos >= mb * bs)) & mask
    if bad.any():
        i = int(np.argmax(bad.any(axis=1)))
        raise ValueError(f"slot {slots[i]} page table does not cover "
                         f"rows [{offs[i]}, {offs[i] + lens[i]}) -- "
                         "allocate blocks before prefill_chunk")
    w_row, w_col = np.nonzero(mask)
    dev = cache["attn"]["k"].device

    def put(a, dtype=torch.int64):
        return torch.as_tensor(np.array(a), dtype=dtype, device=dev)

    return _ChunkArgs(
        toks=put(toks),
        pt_rows=put(np.where(live_row[:, None], np.maximum(rows, 0), 0),
                    torch.int32),
        offs=put(offs, torch.int32),
        lens=put(np.where(valid, lens, 0), torch.int32),
        w_row=put(w_row), w_col=put(w_col),
        w_blk=put(row_blk[w_row, w_col]), w_off=put(gpos[w_row, w_col] % bs),
        slot_idx=put(slots[valid]), slot_row=put(np.nonzero(valid)[0]))


def prefill_chunk(params: Params, cfg: ModelConfig, tokens_chunk, cache: Cache,
                  slot: int, pos_offset: int) -> Tuple[torch.Tensor, Cache]:
    """One prompt chunk of slot ``slot`` at global positions ``pos_offset ..
    pos_offset + c - 1``: the single-sequence view (B = 1) of
    :func:`prefill_chunk_batch`.  The slot's blocks must cover
    ``pos_offset + c`` rows in ``cache["page_table"]``.  Returns the
    chunk's last-position logits (1, V) and the cache with ``lens[slot] =
    pos_offset + c``."""
    toks = np.asarray(tokens_chunk, np.int64).reshape(1, -1)
    return prefill_chunk_batch(params, cfg, toks, cache, [slot], pos_offset)


def prefill_chunk_batch(params: Params, cfg: ModelConfig, tokens_chunks,
                        cache: Cache, slots, pos_offsets, page_table=None,
                        chunk_lens=None, mesh=None
                        ) -> Tuple[torch.Tensor, Cache]:
    """Prefill one prompt chunk for up to B sequences in one call.

    ``tokens_chunks`` (B, c); ``slots`` lists B slot ids, negative for a
    padding row that writes nothing; ``pos_offsets`` (int or (B,)) is each
    row's global start position, ``chunk_lens`` (None = all full) each
    row's valid length.  Each chunk attends the prefix rows its sequence
    already wrote into the pool (``ops.paged_prefill_attention``: the CUDA
    kernel on the card, its plain gather on the CPU) merged with its own
    keys causally, then writes its K/V rows into its blocks.  Returns each
    row's last-valid-position logits (B, V) and the cache with
    ``lens[slot] = pos_offset + chunk_len``.  ``page_table`` may carry the
    caller's host copy of ``cache["page_table"]``.

    The Q/K/V/O projections go through the dequant ``qeinsum`` whatever the
    strategy, as in the reference; the MLP and head go through
    ``norm_qdot`` (norm2 and the final norm fused with their quantization
    under the kernel strategy) and ``qdot``.

    ``mesh`` serves on one rank of a mesh, as :func:`decode_step` does:
    the prefix read and the chunk's attention run on the rank's KV heads,
    whatever their count (the CUDA kernel takes any), and the heads are
    gathered before wo."""
    return _chunk_step(params, cfg, tokens_chunks, cache, slots, pos_offsets,
                       page_table, chunk_lens, all_logits=False, mesh=mesh)


def verify_chunk_batch(params: Params, cfg: ModelConfig, tokens_chunks,
                       cache: Cache, slots, pos_offsets, page_table=None,
                       chunk_lens=None, mesh=None
                       ) -> Tuple[torch.Tensor, Cache]:
    """The speculative verify step: exactly :func:`prefill_chunk_batch` --
    the same addressing, prefix read and K/V writes -- but returning the
    logits of all ``c`` chunk positions, (B, c, V), instead of each row's
    last.  A row feeds ``[output[-1], drafts...]`` at ``pos_offset =
    kv_len``; position ``j``'s logits condition on the prefix and drafts
    ``< j``.  Positions past ``chunk_lens`` are garbage and must not be
    read.  The head runs over all ``B * c`` rows at once.  Its shapes go
    into their own key set (:func:`verify_chunk_compiles`)."""
    return _chunk_step(params, cfg, tokens_chunks, cache, slots, pos_offsets,
                       page_table, chunk_lens, all_logits=True, mesh=mesh)


def _chunk_step(params: Params, cfg: ModelConfig, tokens_chunks,
                cache: Cache, slots, pos_offsets, page_table, chunk_lens,
                all_logits: bool, mesh=None) -> Tuple[torch.Tensor, Cache]:
    """The body :func:`prefill_chunk_batch` and :func:`verify_chunk_batch`
    share; ``all_logits`` picks the head's rows and the key set."""
    a = _chunk_call_args(tokens_chunks, cache, slots, pos_offsets,
                         page_table, chunk_lens)
    sm = None
    if mesh is not None:
        sm = _ServeMesh(cfg, params, mesh)
        params = sm.top
    hd, kvh, qscale = cfg.hd(), cfg.n_kv_heads, _q_scale(cfg)
    b, c = a.toks.shape
    keys = _VERIFY_KEYS if all_logits else _CHUNK_KEYS
    keys.setdefault(cfg, set()).add(
        (_mesh_key(mesh), b, c)
        + tuple(tuple(t.shape) for t in cache["attn"].values()))
    q_pos = a.offs[:, None] + torch.arange(c, dtype=torch.int32,
                                           device=a.offs.device)[None]
    cos, sin = _rope_cos_sin(cfg, _streams(cfg, q_pos))  # (B, c, hd)
    chunk_valid = (torch.arange(c, device=a.offs.device)[None]
                   < a.lens[:, None])
    acfg = L.AttnConfig(cfg.n_heads, kvh, hd, q_chunk=cfg.q_chunk)
    if sm is not None:
        acfg = acfg._replace(n_heads=sm.q_heads, n_kv_heads=sm.kv_heads)
    x = embed_inputs(params, cfg, {"tokens": a.toks})

    for i in range(cfg.n_layers):
        lp = _block(params, "blocks", i, sm)
        lc = {k: v[i] for k, v in cache["attn"].items()}
        hn = L.apply_norm(x, lp["norm1"], cfg.norm_type, cfg.eps)
        q = qeinsum("bsd,hkd->bshk", hn, lp["attn"]["wq"])
        k = qeinsum("bsd,hkd->bshk", hn, lp["attn"]["wk"])
        v = qeinsum("bsd,hkd->bshk", hn, lp["attn"]["wv"])
        q = L.apply_rope(q, cos[:, :, None], sin[:, :, None])
        k = L.apply_rope(k, cos[:, :, None], sin[:, :, None])
        qs = q * qscale
        if sm is not None:
            qs, k, v = qs[:, :, sm.q], k[:, :, sm.kv], v[:, :, sm.kv]
        pfx_state = ops.paged_prefill_attention(
            qs, lc["k"], lc["v"], a.pt_rows, a.offs, a.lens, lc.get("ks"),
            lc.get("vs"))
        out = L.attention_chunk_merge(qs, None, None, k, v, acfg, q_pos,
                                      None, chunk_valid, pfx_state=pfx_state)
        if sm is not None:
            out = sm.heads(out, 2)
        out = qeinsum("bshk,dhk->bsd", out, lp["attn"]["wo"])
        x = x + out.to(x.dtype)
        x = x + _mlp(lp, x, cfg)
        _write_rows(lc, k[a.w_row, a.w_col], v[a.w_row, a.w_col], a.w_blk,
                    a.w_off)

    if all_logits:
        logits = _head(params, cfg, x)                   # (B, c, V)
    else:
        last = torch.clamp(a.lens.long() - 1, 0, c - 1)
        logits = _head(params, cfg, x[torch.arange(b, device=x.device),
                                      last])
    new_cache = dict(cache)
    new_lens = cache["lens"].clone()
    new_lens[a.slot_idx] = (a.offs + a.lens)[a.slot_row]
    new_cache["lens"] = new_lens
    return logits, new_cache
