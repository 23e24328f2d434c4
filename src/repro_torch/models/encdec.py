"""Whisper-style encoder-decoder backbone (the audio family).

PyTorch counterpart of ``repro/models/encdec.py``.  The conv frontend is a
stub, as in the reference: the encoder takes precomputed frame embeddings
(B, enc_seq, D).  The backbone is whole: a bidirectional encoder (LayerNorm
and a GELU MLP, multi-head attention) and a causal decoder with self- and
cross-attention, learned encoder and decoder positions, the head tied with
the embedding.

The Q/K/V/O projections go through the dequant ``qeinsum`` whatever the
strategy, as in the reference; the MLP's two products and the head go
through ``qdot`` (under the ``kernel`` strategy the Q8_0 kernels, each
product's input quantized by the ``quantize`` kernel: the layer norm has
no fused norm-and-quantize).  Attention runs on ``ops.flash_prefill``
over whole sequences (the encoder's non-causal, the decoder's causal, the
cross-attention non-causal, S_dec queries against the enc_seq encoder
keys) and on ``ops.decode_attention`` at a decode step (the self cache
over each row's ``pos + 1`` positions, the cross cache over all enc_seq).

Serving keeps two dense caches: ``self``, the decoder's K/V growing to
``max_seq``, and ``cross``, the cross-attention K/V computed once from the
encoder's output; both bf16 (the compute dtype) or int8 with one f32 scale
per (position, head).  As in the port's decoder-only models, the decode
step writes the cache in place and returns the same tensors.  No engine
serves this family: the reference's engine prefills tokens alone, and the
encoder needs frames.

The training loss (``lm_loss``) runs every attention on the reference's
jnp ``attention_scores_blockwise`` (``transformer.train_attention``) and
every layer under ``transformer.remat``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import Device, resolve_device
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.qlinear import qdot, qeinsum
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.distribution import sharding as sh
from repro_torch.models.transformer import (_attn_bank, _block, _cdt,
                                            _dense_attention, _layer,
                                            _q_scale, _ServeMesh,
                                            _write_rows, batch_to,
                                            check_family, chunked_ce,
                                            draw_params, keep_part,
                                            prefill_attention, remat,
                                            train_attention, train_view,
                                            unbind_stacks)

Params = Dict[str, Any]
Cache = Dict[str, Any]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _norm(cfg: ModelConfig, dev: torch.device, lead) -> Params:
    """A layer norm's gamma (ones) and beta (zeros), f32, on ``lead``."""
    d = cfg.d_model
    return {"gamma": torch.ones((*lead, d), dtype=torch.float32, device=dev),
            "beta": torch.zeros((*lead, d), dtype=torch.float32, device=dev)}


def _attn(cfg: ModelConfig, leaf, lead, prefix: str) -> Params:
    d, hd, h, kvh = cfg.d_model, cfg.hd(), cfg.n_heads, cfg.n_kv_heads
    sc, so = 1.0 / math.sqrt(d), 1.0 / math.sqrt(h * hd)
    return {"wq": leaf(f"{prefix}/wq", (*lead, h, hd, d), sc),
            "wk": leaf(f"{prefix}/wk", (*lead, kvh, hd, d), sc),
            "wv": leaf(f"{prefix}/wv", (*lead, kvh, hd, d), sc),
            "wo": leaf(f"{prefix}/wo", (*lead, d, h, hd), so)}


def _mlp(cfg: ModelConfig, leaf, lead, prefix: str) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    return {"w1": leaf(f"{prefix}/w1", (*lead, f, d), 1.0 / math.sqrt(d)),
            "w2": leaf(f"{prefix}/w2", (*lead, d, f), 1.0 / math.sqrt(f))}


def _param_tree(cfg: ModelConfig, leaf, dev: torch.device) -> Params:
    """The reference's tree on ``dev``, each weight made by ``leaf(path,
    shape, scale, dtype=None)`` (``transformer.draw_params``): ``embed``,
    the f32 ``enc_pos`` (enc_seq, D) and ``dec_pos`` (max_pos, D), the
    stacked ``enc_blocks`` (norm1, attn, norm2, mlp) and ``dec_blocks``
    (norm1, attn, norm_x, cross, norm2, mlp), ``enc_final_norm`` and
    ``final_norm``."""
    d, ne, nd = cfg.d_model, (cfg.n_enc_layers,), (cfg.n_layers,)
    return {
        "embed": leaf("embed", (cfg.padded_vocab(), d), 0.02),
        "enc_pos": leaf("enc_pos", (cfg.enc_seq, d), 0.02, torch.float32),
        "dec_pos": leaf("dec_pos", (cfg.max_pos, d), 0.02, torch.float32),
        "enc_blocks": {"norm1": _norm(cfg, dev, ne),
                       "attn": _attn(cfg, leaf, ne, "enc_blocks/attn"),
                       "norm2": _norm(cfg, dev, ne),
                       "mlp": _mlp(cfg, leaf, ne, "enc_blocks/mlp")},
        "dec_blocks": {"norm1": _norm(cfg, dev, nd),
                       "attn": _attn(cfg, leaf, nd, "dec_blocks/attn"),
                       "norm_x": _norm(cfg, dev, nd),
                       "cross": _attn(cfg, leaf, nd, "dec_blocks/cross"),
                       "norm2": _norm(cfg, dev, nd),
                       "mlp": _mlp(cfg, leaf, nd, "dec_blocks/mlp")},
        "enc_final_norm": _norm(cfg, dev, ()),
        "final_norm": _norm(cfg, dev, ()),
    }


def init_params(cfg: ModelConfig, seed: int = 0,
                device: Device = None, hold: Device = None) -> Params:
    """Random parameters from ``seed``: the reference's shapes and scales
    (projections times 1/sqrt(fan-in), the embedding and positions times
    0.02), drawn from a ``torch.Generator``, so the values differ from the
    reference's."""
    check_family(cfg)
    return draw_params(cfg, _param_tree, seed, device=device, hold=hold)


def init_quantized(cfg: ModelConfig, seed: int = 0,
                   policy: Optional[QuantPolicy] = None,
                   device: Device = None, hold: Device = None) -> Params:
    """``init_params`` quantized as it draws: bitwise
    ``quantize_params(init_params(cfg, seed), policy)`` (no fused decode
    operands: the reference fuses none for this family) without the float
    tree."""
    check_family(cfg)
    return draw_params(cfg, _param_tree, seed, policy or QuantPolicy(),
                       device, hold)


def _qkv(p, h):
    return tuple(qeinsum("bsd,hkd->bshk", h, p[w]) for w in ("wq", "wk",
                                                            "wv"))


def _out(p, a, dtype):
    return qeinsum("bshk,dhk->bsd", a, p["wo"]).to(dtype)


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------


def _enc_block(p, x, cfg: ModelConfig, attend) -> torch.Tensor:
    """One encoder layer over x (B, S, D): bidirectional self-attention,
    every frame attending every frame, then the MLP."""
    h = L.apply_norm(x, p["norm1"], cfg.norm_type, cfg.eps)
    q, k, v = _qkv(p["attn"], h)
    x = x + _out(p["attn"], attend(q, k, v, cfg, causal=False), x.dtype)
    return x + L.gelu_mlp(p["mlp"], L.apply_norm(x, p["norm2"],
                                                 cfg.norm_type, cfg.eps))


def encode(params: Params, cfg: ModelConfig, frames: torch.Tensor,
           train: bool = False, sm=None) -> torch.Tensor:
    """frames (B, S_enc, D) stub embeddings -> the encoder's hidden states
    (B, S_enc, D), after its final norm.  Served, attention runs on
    ``prefill_attention`` (``ops.flash_prefill``); with ``train`` on
    ``transformer.train_attention``, each layer under ``remat``.  On a
    serve mesh (``sm``) each layer's weights are gathered on use."""
    s = frames.shape[1]
    x = frames.to(_cdt(cfg)) + params["enc_pos"][:s].to(_cdt(cfg))
    for i in range(cfg.n_enc_layers):
        lp = _block(params, "enc_blocks", i, sm)
        x = (remat(cfg, _enc_block, lp, x, cfg, train_attention) if train
             else _enc_block(lp, x, cfg, prefill_attention))
    return L.apply_norm(x, params["enc_final_norm"], cfg.norm_type, cfg.eps)


# ---------------------------------------------------------------------------
# decoder over whole sequences (prefill)
# ---------------------------------------------------------------------------


def _cross_kv(p, enc_hidden, cfg: ModelConfig):
    """The cross-attention's K and V (B, S_enc, KVH, hd) of the encoder's
    hidden states."""
    return (qeinsum("bsd,hkd->bshk", enc_hidden, p["cross"]["wk"]),
            qeinsum("bsd,hkd->bshk", enc_hidden, p["cross"]["wv"]))


def _dec_block_seq(p, x, enc_hidden, cfg: ModelConfig,
                   attend=prefill_attention):
    """One decoder layer over x (B, S, D): causal self-attention,
    cross-attention to the encoder's states (S queries against every
    encoder key), the MLP, each attention through ``attend``.  Returns x
    and the layer's (k, v, kx, vx) for the caches."""
    h = L.apply_norm(x, p["norm1"], cfg.norm_type, cfg.eps)
    q, k, v = _qkv(p["attn"], h)
    x = x + _out(p["attn"], attend(q, k, v, cfg), x.dtype)

    hx = L.apply_norm(x, p["norm_x"], cfg.norm_type, cfg.eps)
    qx = qeinsum("bsd,hkd->bshk", hx, p["cross"]["wq"])
    kx, vx = _cross_kv(p, enc_hidden, cfg)
    cx = attend(qx, kx, vx, cfg, causal=False)
    x = x + _out(p["cross"], cx, x.dtype)

    x = x + L.gelu_mlp(p["mlp"], L.apply_norm(x, p["norm2"], cfg.norm_type,
                                              cfg.eps))
    return x, (k, v, kx, vx)


def _embed_tokens(params: Params, cfg: ModelConfig,
                  tokens: torch.Tensor) -> torch.Tensor:
    """The decoder's input: token embeddings plus learned positions
    0..S-1, in the compute dtype."""
    s = tokens.shape[1]
    x = L.embed_lookup(params["embed"], tokens).to(_cdt(cfg))
    return x + params["dec_pos"][:s].to(_cdt(cfg))


def decoder_hidden(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                   enc_hidden: torch.Tensor, sm=None):
    """tokens (B, S) at positions 0..S-1 against the encoder's states ->
    (hidden (B, S, D) after the final norm, each layer's (k, v, kx,
    vx)).  On a serve mesh (``sm``) each layer's weights are gathered on
    use."""
    x = _embed_tokens(params, cfg, tokens)
    kvs = []
    for i in range(cfg.n_layers):
        x, kv = _dec_block_seq(_block(params, "dec_blocks", i, sm), x,
                               enc_hidden, cfg)
        kvs.append(kv)
    return L.apply_norm(x, params["final_norm"], cfg.norm_type, cfg.eps), kvs


def _dec_block_train(p, x, enc_hidden, cfg: ModelConfig) -> torch.Tensor:
    return _dec_block_seq(p, x, enc_hidden, cfg, train_attention)[0]


def lm_loss(params: Params, cfg: ModelConfig, batch: Dict[str, Any],
            chunk: int = 512, mesh=None, specs=None,
            batch_axes=None) -> torch.Tensor:
    """The training loss of ``batch``: frames (B, S_enc, D), tokens and
    labels (B, S), as the reference's ``lm_loss``.  The encoder and the
    decoder run every attention on ``transformer.train_attention`` and
    every layer under ``remat``; the cross-entropy is the decoder-only
    family's (``chunked_ce``).  On a train ``mesh`` the rank's shards and
    rows, as ``transformer.lm_loss`` (``train_view``; whisper-small trains
    data-parallel over every axis, its leaves whole)."""
    dev = params["final_norm"]["gamma"].device
    batch = batch_to(batch, dev)
    b, s = batch["labels"].shape
    params, tp, dp = train_view(params, cfg, mesh, specs, batch_axes)
    params = unbind_stacks(params)
    enc = encode(params, cfg, batch["frames"], train=True)
    x = _embed_tokens(params, cfg, batch["tokens"])
    for i in range(cfg.n_layers):
        x = remat(cfg, _dec_block_train, _layer(params["dec_blocks"], i), x,
                  enc, cfg)
    hidden = L.apply_norm(x, params["final_norm"], cfg.norm_type, cfg.eps)
    return chunked_ce(cfg, params["embed"], hidden, batch["labels"], tp,
                      chunk, tokens=b * s * dp)


def _lm_head(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Normed rows (..., D) -> f32 logits (..., V) against the embedding."""
    return qdot(x, params["embed"]).float()


# ---------------------------------------------------------------------------
# serving: the two caches, prefill, decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device: Device = None) -> Cache:
    """``self``: K/V (n_layers, batch, max_seq, KVH, hd); ``cross``: K/V
    (n_layers, batch, enc_seq, KVH, hd); each in the compute dtype, or
    int8 with f32 scales (n_layers, batch, seq, KVH) for an int8 cache."""
    dev = resolve_device(device)
    return {"lens": torch.zeros((batch,), dtype=torch.int32, device=dev),
            "self": _attn_bank(cfg, (batch, max_seq), dev),
            "cross": _attn_bank(cfg, (batch, cfg.enc_seq), dev)}


def prefill(params: Params, cfg: ModelConfig, batch: Dict[str, Any],
            max_seq: Optional[int] = None, mesh=None,
            cache_specs=None) -> Tuple[torch.Tensor, Cache]:
    """Encode ``batch["frames"]`` (B, S_enc, D), teacher-force the prompts
    ``batch["tokens"]`` (B, S) and fill both caches: returns the last
    position's logits (B, V) f32 and the cache (``self`` of ``max_seq``
    positions, default S, holding the prompts' K/V; ``cross`` the encoder's
    K/V at every one of its enc_seq positions; ``lens = S``).  Runs where
    the parameters live.  ``mesh`` / ``cache_specs``: one rank of a mesh,
    as ``transformer.prefill`` runs there."""
    sm = None
    if mesh is not None:
        sm = _ServeMesh(cfg, params, mesh)
        params = sm.top
    dev = params["final_norm"]["gamma"].device
    tokens = batch["tokens"]
    if not isinstance(tokens, torch.Tensor):
        tokens = torch.as_tensor(np.asarray(tokens, np.int64))
    tokens = tokens.to(dev)
    frames = torch.as_tensor(batch["frames"]).to(dev)
    b, s = tokens.shape
    enc_hidden = encode(params, cfg, frames, sm=sm)
    hidden, kvs = decoder_hidden(params, cfg, tokens, enc_hidden, sm)
    cache = init_cache(cfg, b, max_seq or s, device=dev)
    cache["lens"].fill_(s)
    se = enc_hidden.shape[1]
    for i, (k, v, kx, vx) in enumerate(kvs):
        _write_rows(_layer(cache["self"], i), k, v, slice(None),
                    slice(0, s))
        _write_rows(_layer(cache["cross"], i), kx, vx, slice(None),
                    slice(0, se))
    return _lm_head(params, hidden[:, -1]), keep_part(cache, cache_specs,
                                                      mesh)


def decode_step(params: Params, cfg: ModelConfig, cache: Cache,
                tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None, mesh=None,
                cache_specs=None) -> Tuple[torch.Tensor, Cache]:
    """tokens (B,) -> (logits (B, V) f32, cache).  Each row's new self K/V
    row lands at its position (clamped to the last one, as the reference's
    ``dynamic_update_slice`` clamps it); self-attention reads each row's
    ``pos + 1`` positions, cross-attention every one of the cross cache's
    positions; ``lens`` comes back as ``pos + 1``.  ``mesh`` /
    ``cache_specs``: one rank of a mesh, as ``transformer.decode_step``
    serves the dense cache there (both caches by the same ``/k``, ``/v``
    rules)."""
    sm = None
    if mesh is not None:
        sm = _ServeMesh(cfg, params, mesh, cache_specs)
        params = sm.top
    pos = cache["lens"] if positions is None else positions
    b = tokens.shape[0]
    x = L.embed_lookup(params["embed"], tokens).to(_cdt(cfg))
    x = x + params["dec_pos"][pos.long()].to(_cdt(cfg))
    qscale = _q_scale(cfg)
    lens_now = (pos + 1).int()

    def whole(part, n):
        """The global length of dim -3 of ``cache[part]["k"]`` (n local)."""
        if sm is None or cache_specs is None:
            return n
        return n * sh.parts(cache_specs[part]["k"][-3], mesh)
    s = whole("self", cache["self"]["k"].shape[2])
    enc_len = torch.full((b,), whole("cross", cache["cross"]["k"].shape[2]),
                         dtype=torch.int32, device=x.device)
    dst = (torch.arange(b, device=x.device), torch.clamp(pos, 0, s - 1).long())

    def proj(h, p, w):
        return qeinsum("bd,hkd->bhk", h, p[w])

    for i in range(cfg.n_layers):
        lp = _block(params, "dec_blocks", i, sm)
        sc, xc = _layer(cache["self"], i), _layer(cache["cross"], i)
        s_spec = x_spec = None
        if sm is not None:
            s_spec = sm.cache_layer_specs("self", i, sc)
            x_spec = sm.cache_layer_specs("cross", i, xc)
        hh = L.apply_norm(x, lp["norm1"], cfg.norm_type, cfg.eps)
        q, k, v = (proj(hh, lp["attn"], w) for w in ("wq", "wk", "wv"))
        a = _dense_attention(q * qscale, k, v, sc, dst, lens_now, sm, s_spec)
        x = x + qeinsum("bhk,dhk->bd", a, lp["attn"]["wo"]).to(x.dtype)

        hx = L.apply_norm(x, lp["norm_x"], cfg.norm_type, cfg.eps)
        qx = proj(hx, lp["cross"], "wq")
        cx = _dense_attention(qx * qscale, None, None, xc, None, enc_len, sm,
                              x_spec)
        x = x + qeinsum("bhk,dhk->bd", cx, lp["cross"]["wo"]).to(x.dtype)
        x = x + L.gelu_mlp(lp["mlp"], L.apply_norm(x, lp["norm2"],
                                                   cfg.norm_type, cfg.eps))

    x = L.apply_norm(x, params["final_norm"], cfg.norm_type, cfg.eps)
    new_cache = dict(cache)
    new_cache["lens"] = lens_now
    return _lm_head(params, x), new_cache
