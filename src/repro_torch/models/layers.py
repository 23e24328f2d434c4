"""Layers of the decoder, as plain functions on tensors.

PyTorch counterpart of the dense, MoE, M-RoPE and encoder-decoder subset
of ``repro/models/layers.py``.
Weights are stored contraction-last ``(out, in)``, so ``qdot`` takes float
or quantized leaves alike.  The model's attention calls go to
:mod:`repro_torch.kernels.ops`: the CUDA kernels for tensors on the card,
their plain versions (``kernels/ref.py``) for tensors on the CPU.
``attention_scores_blockwise`` and ``attention_decode`` are the
reference's jnp twins of the one-shot prefill and dense decode kernels,
held against both packages by the tests.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.qlinear import as_float, norm_qdot, qdot
from repro_torch.core.quantization import QuantizedTensor, _unpack_nibbles
from repro_torch.kernels.ref import ref_decode_attention, rms_norm
from repro_torch.launch.flops import product

NEG_INF = -1e30

# ---------------------------------------------------------------------------
# Norms (``rms_norm`` lives beside the plain version of the fused
# norm-and-quantize kernel, kernels/ref.py)
# ---------------------------------------------------------------------------


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm as the reference computes it: the f32 mean and the biased
    variance of each row, ``rsqrt(var + eps)``, then gamma and beta in
    f32, cast back to x's dtype."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(x.dtype)


def norm_gamma(p, kind: str) -> torch.Tensor:
    """The f32 scale of an RMSNorm, for the fused norm-and-quantize path
    (``norm_qdot``), which computes RMSNorm only: a layer norm, which also
    centres its rows and adds beta, has no fused path and raises."""
    if kind != "rmsnorm":
        raise ValueError(f"norm {kind!r} has no fused norm-and-quantize "
                         "path: apply_norm, then qdot")
    return p["gamma"]


def apply_norm(x, p, kind: str, eps: float = 1e-5):
    if kind == "rmsnorm":
        return rms_norm(x, p["gamma"], eps)
    if kind == "layernorm":
        return layer_norm(x, p["gamma"], p["beta"], eps)
    raise NotImplementedError(f"norm {kind!r}")


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (...,) -> cos/sin (..., head_dim) in rotate-half layout."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (..., H, D); cos/sin broadcastable (..., 1, D)."""
    d = x.shape[-1]
    x32 = x.float()
    x1, x2 = x32[..., : d // 2], x32[..., d // 2:]
    rot = torch.cat([-x2, x1], dim=-1)
    return (x32 * cos + rot * sin).to(x.dtype)


def mrope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                 sections):
    """Qwen2-VL's multimodal rope: positions (3, ...), the temporal, height
    and width streams -> cos/sin (..., head_dim) in rotate-half layout.
    ``sections`` counts the rotation pairs each stream drives (summing to
    head_dim // 2): frequency band j takes its position from stream
    ``repeat(arange(3), sections)[j]``.  The frequencies are
    ``rope_angles``', so with three equal streams (text tokens) the tables
    are ``rope_angles``' bit for bit."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {tuple(sections)} do not sum to "
                         f"head_dim // 2 = {half}")
    dev = positions.device
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=dev) / half)
    stream = torch.repeat_interleave(
        torch.arange(len(sections), device=dev),
        torch.as_tensor(tuple(sections), device=dev),
        output_size=half)                                       # (half,)
    pos = positions.float()[stream]                             # (half, ...)
    ang = torch.movedim(pos, 0, -1) * freqs
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang), torch.sin(ang)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


class AttnConfig(NamedTuple):
    n_heads: int
    n_kv_heads: int
    head_dim: int
    q_chunk: int = 1024       # query rows per attention block
    causal: bool = True
    window: int = 0           # > 0: sliding window (not ported)


def attention_scores_blockwise(q, k, v, cfg: AttnConfig,
                               q_offset: int = 0) -> torch.Tensor:
    """Causal attention one query chunk at a time: the plain twin of the
    one-shot prefill's ``kernels.ops.flash_prefill``.

    q: (B, S, H, D) pre-scaled; k/v: (B, T, KVH, D).  Scores for one chunk
    are (B, H, qc, T), never the whole S x T square."""
    if cfg.window > 0:
        raise NotImplementedError("sliding-window attention is not ported")
    b, s, h, d = q.shape
    t = k.shape[1]
    qc = min(cfg.q_chunk, s)
    while s % qc:
        qc -= 1
    hq = h // cfg.n_kv_heads
    kg = torch.repeat_interleave(k, hq, dim=2).float()
    vg = torch.repeat_interleave(v, hq, dim=2).to(q.dtype)
    kpos = torch.arange(t, device=q.device)[None, :]
    outs = []
    for s0 in range(0, s, qc):
        scores = torch.einsum("bqhd,bthd->bhqt", q[:, s0:s0 + qc].float(), kg)
        if cfg.causal:
            qpos = q_offset + s0 + torch.arange(qc, device=q.device)[:, None]
            scores = torch.where((kpos <= qpos)[None, None], scores,
                                 torch.full_like(scores, NEG_INF))
        p = torch.softmax(scores, dim=-1)
        outs.append(torch.einsum("bhqt,bthd->bqhd", p.to(q.dtype), vg))
    return torch.cat(outs, dim=1)


def attention_decode(q, k_cache, v_cache, length, cfg: AttnConfig,
                     k_scale=None, v_scale=None) -> torch.Tensor:
    """Single-position attention against a dense cache: the plain twin of
    ``kernels.ops.decode_attention``.

    q: (B, H, D) pre-scaled; caches (B, S, KVH, D); length (B,) or scalar.
    Optional per-(position, kv-head) scales dequantize an int8 cache."""
    b, h, d = q.shape
    kvh = cfg.n_kv_heads
    lens = torch.broadcast_to(torch.as_tensor(length, device=q.device), (b,))
    out = ref_decode_attention(q.reshape(b, kvh, h // kvh, d), k_cache,
                               v_cache, lens[:, None], k_scale, v_scale)
    return out.reshape(b, h, d).to(q.dtype)


def attention_chunk_merge(q, k_pfx, v_pfx, k_chunk, v_chunk,
                          cfg: AttnConfig, q_pos, pfx_valid, chunk_valid,
                          pfx_state=None) -> torch.Tensor:
    """Chunked-prefill attention: a fixed-extent prefix segment merged with
    the chunk's own keys by exact softmax renormalization.

    q: (B, C, H, D) pre-scaled queries at global positions ``q_pos``
    (B, C); k/v_chunk: (B, C, KVH, D), live where ``chunk_valid`` (B, C);
    k/v_pfx: (B, P, KVH, D), pool row t at global position t, live where
    ``pfx_valid`` (B, P).  ``pfx_state`` replaces the prefix segment with a
    precomputed flash state (out (B, C, H, D), m and l (B, H, C, 1)), the
    layout ``kernels.ops.paged_prefill_attention`` returns; k/v_pfx and
    pfx_valid may then be None.

    The two segments merge as ``w_p * out_p + w_c * out_c`` with
    ``w = alpha * l / (alpha_p l_p + alpha_c l_c)``.  An empty prefix
    (m = -1e30, l = 0) gives ``w_p == 0`` and ``w_c == 1`` exactly, so a
    zero-offset row equals plain causal attention over the chunk.  The
    chunk segment is causal; prefix keys lie strictly below every live
    query position, so their validity already implies causality."""
    b, c, h, d = q.shape
    kvh = cfg.n_kv_heads
    hq = h // kvh
    qc = min(cfg.q_chunk, c)
    while c % qc:
        qc -= 1

    kgc = torch.repeat_interleave(k_chunk, hq, dim=2).to(q.dtype)
    vgc = torch.repeat_interleave(v_chunk, hq, dim=2).to(q.dtype)
    if pfx_state is None:
        kgp = torch.repeat_interleave(k_pfx, hq, dim=2).to(q.dtype)
        vgp = torch.repeat_interleave(v_pfx, hq, dim=2).to(q.dtype)
        k_pos_p = torch.arange(k_pfx.shape[1], device=q.device)[None]

    def segment(qi, qpos, kg, vg, k_pos, k_valid, causal):
        scores = torch.einsum("bqhd,bthd->bhqt", qi.float(), kg.float())
        mask = k_valid[:, None, :]
        if causal:
            mask = mask & (k_pos[:, None, :] <= qpos[:, :, None])
        scores = torch.where(mask[:, None], scores,
                             torch.full_like(scores, NEG_INF))
        m = torch.amax(scores, dim=-1, keepdim=True)
        e = torch.exp(scores - m)
        l = torch.sum(e, dim=-1, keepdim=True)
        # p rounded to q's dtype as the reference rounds it; the product
        # sums in f32 and rounds once, as XLA computes a bf16 dot (and
        # PyTorch's own bf16 CPU product may split its sum by thread)
        out = torch.einsum("bhqt,bthd->bqhd", (e / l).to(q.dtype).float(),
                           vg.float()).to(q.dtype)
        return out, m, l

    def merge(out_c, m_c, l_c, out_p, m_p, l_p):
        m = torch.maximum(m_p, m_c)
        a_p = torch.exp(m_p - m) * l_p
        a_c = torch.exp(m_c - m) * l_c
        l = a_p + a_c
        w_p = (a_p / l).transpose(1, 2)           # (B, qc, H, 1)
        w_c = (a_c / l).transpose(1, 2)
        return w_p * out_p + w_c * out_c

    outs = []
    for s in range(0, c, qc):
        qi, qpos = q[:, s:s + qc], q_pos[:, s:s + qc]
        out_c, m_c, l_c = segment(qi, qpos, kgc, vgc, q_pos, chunk_valid,
                                  True)
        if pfx_state is None:
            out_p, m_p, l_p = segment(qi, qpos, kgp, vgp, k_pos_p, pfx_valid,
                                      False)
        else:
            out_p = pfx_state[0][:, s:s + qc]
            m_p = pfx_state[1][:, :, s:s + qc]
            l_p = pfx_state[2][:, :, s:s + qc]
        outs.append(merge(out_c, m_c, l_c, out_p, m_p, l_p))
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# MLP, embedding
# ---------------------------------------------------------------------------


def swiglu_mlp(p, x, gamma, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with ``gamma``, then SwiGLU on the fused ``w13 = [w1; w3]``
    (or separate w1/w3) and w2.  ``x`` is the pre-norm input; the norm
    feeds ``w13`` through ``norm_qdot`` (one fused norm-and-quantize
    launch under the kernel strategy)."""
    if "w13" in p:
        h13 = norm_qdot(x, gamma, eps, p["w13"])
        f = h13.shape[-1] // 2
        h = torch.nn.functional.silu(h13[..., :f]) * h13[..., f:]
    else:
        hn = rms_norm(x, gamma, eps)
        h = torch.nn.functional.silu(qdot(hn, p["w1"])) * qdot(hn, p["w3"])
    return qdot(h.to(x.dtype), p["w2"]).to(x.dtype)


def gelu_mlp(p, x) -> torch.Tensor:
    """Whisper's MLP on the normed x: w1 (F, D), the GELU in its tanh form
    (``jax.nn.gelu``'s default; PyTorch's default is the exact erf form),
    w2 (D, F); both products through ``qdot``."""
    h = torch.nn.functional.gelu(qdot(x, p["w1"]), approximate="tanh")
    return qdot(h.to(x.dtype), p["w2"]).to(x.dtype)


# ---------------------------------------------------------------------------
# Mixture of Experts (GShard-style grouped einsum dispatch)
# ---------------------------------------------------------------------------


def router_logits(x: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) -> f32 router logits (B, S, E) against ``router`` (E, D)."""
    return torch.einsum("bsd,ed->bse", x.float(), router.float())


def moe_route(x: torch.Tensor, router: torch.Tensor, top_k: int):
    """Token-choice routing: (gates (B, S, K) f32, idx (B, S, K) int64).

    The experts are ``lax.top_k``'s: the largest logits first, ties to the
    lower expert index (a stable descending sort; ``torch.topk`` breaks
    ties otherwise); the gates a softmax over the chosen logits.  The one
    place ``moe_mlp`` routes, so that a caller can record or replay the
    routes by patching it."""
    logits = router_logits(x, router)
    idx = torch.sort(logits, dim=-1, descending=True,
                     stable=True).indices[..., :top_k]
    gates = torch.softmax(torch.gather(logits, -1, idx), dim=-1)
    return gates, idx


def expert_ffn(p, xin: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU on their capacity slots: xin (E, G, C, D) ->
    (E, G, C, D) f32, expert e of w1 / w3 (E, F, D) and w2 (E, D, F) on
    its slots alone, each bank dequantized to f32 (``as_float``)."""
    h1 = torch.einsum("egcd,efd->egcf", xin.float(), as_float(p["w1"]))
    h3 = torch.einsum("egcd,efd->egcf", xin.float(), as_float(p["w3"]))
    hh = torch.nn.functional.silu(h1) * h3
    return torch.einsum("egcf,edf->egcd", hh, as_float(p["w2"]))


def moe_mlp(p, x, *, n_experts: int, top_k: int, group_size: int = 512,
            capacity_factor: float = 1.25,
            dense_dispatch: bool = False, experts=None) -> torch.Tensor:
    """Token-choice MoE: the counterpart of the reference's ``moe_mlp``.

    p: router (E, D) f32; w1 / w3 (E, F, D), w2 (E, D, F), float or
    quantized; x (B, S, D).  Every expert product is f32 on dequantized
    weights, as in the reference, whatever the qlinear strategy.

    ``dense_dispatch`` (the decode step) computes every expert for every
    token and mixes them by a combine weight that is 0 off the top k: no
    capacity limit.  Otherwise tokens are cut into groups of ``group_size``
    (lowered until it divides S, so a group never crosses a row) and each
    expert takes at most ``cap`` tokens a group, in token order and then
    choice order; a dropped (token, choice) pair gets gate 0, the others
    are not renormalized.  Dispatch and combine are one-hot einsums, as in
    the reference (no float scatter-add, so the card repeats bitwise).
    Where one contracts only the top-1 choice dim, which torch computes
    as a multiply, it is counted as the reference's dot
    (``flops.product``).  ``experts(p, xin, combine)``, where given, takes
    the grouped dispatch's expert products and combine in their place:
    xin (E, G, C, D) and combine (G, Sg, E, C) -> (G, Sg, D) f32 (a rank
    of a train mesh holds a shard of the banks, ``transformer._TrainTP``);
    by default ``expert_ffn`` and the combine einsum."""
    b, s, d = x.shape
    e = n_experts
    gates, idx = moe_route(x, p["router"], top_k)

    def k1(out, *operands):
        return product(out, *operands) if top_k == 1 else out

    if dense_dispatch:
        xf = x.float()
        onehot = torch.nn.functional.one_hot(idx, e).float()     # (B,S,K,E)
        combine = k1(torch.einsum("bske,bsk->bse", onehot, gates), onehot,
                     gates)
        h1 = torch.einsum("bsd,efd->bsef", xf, as_float(p["w1"]))
        h3 = torch.einsum("bsd,efd->bsef", xf, as_float(p["w3"]))
        hh = torch.nn.functional.silu(h1) * h3
        ye = torch.einsum("bsef,edf->bsed", hh, as_float(p["w2"]))
        return torch.einsum("bsed,bse->bsd", ye, combine).to(x.dtype)

    g_sz = min(group_size, s)
    while s % g_sz:
        g_sz -= 1
    g = (b * s) // g_sz
    cap = max(int(capacity_factor * g_sz * top_k / e), 1)
    cap = (cap + 3) & ~3            # a multiple of 4, as the reference

    xg = x.reshape(g, g_sz, d)
    oh_e = torch.nn.functional.one_hot(idx.reshape(g, g_sz, top_k), e)
    # each (token, choice)'s place in its expert's queue, in token order
    flat = oh_e.reshape(g, g_sz * top_k, e)
    pos = ((torch.cumsum(flat, dim=1) - flat) * flat).sum(-1)
    pos = pos.reshape(g, g_sz, top_k)
    keep = pos < cap
    gates_kept = torch.where(keep, gates.reshape(g, g_sz, top_k),
                             torch.zeros((), device=x.device))

    oh_e = oh_e.float()                                       # (G,Sg,K,E)
    # a dropped pair's one-hot slot is the extra class cap, cut off
    oh_c = torch.nn.functional.one_hot(
        torch.where(keep, pos, cap), cap + 1)[..., :cap].float()
    disp = k1(torch.einsum("gske,gskc->gsec", oh_e, oh_c), oh_e, oh_c)
    # "gske,gskc,gsk->gsec" in the reference's pairs: the gates onto the
    # slots first (a product that contracts nothing)
    gated = product(oh_c * gates_kept[..., None], oh_c, gates_kept)
    combine = k1(torch.einsum("gske,gskc->gsec", oh_e, gated), oh_e, gated)

    xin = torch.einsum("gsec,gsd->egcd", disp.to(x.dtype), xg)  # (E,G,C,D)
    if experts is None:
        y = torch.einsum("gsec,egcd->gsd", combine, expert_ffn(p, xin))
    else:
        y = experts(p, xin, combine)
    return y.reshape(b, s, d).to(x.dtype)


def embed_lookup(table, tokens: torch.Tensor) -> torch.Tensor:
    """table (V, D), possibly quantized; tokens (...,) int."""
    tokens = tokens.long()
    if isinstance(table, QuantizedTensor):
        q = table.q[tokens]                  # (..., D) int8 / (..., D/2) Q4
        if table.bits == 4:
            q = _unpack_nibbles(q)
        s = table.scale[tokens]
        g = table.orig_dim // table.group_size
        qf = q.reshape(*q.shape[:-1], g, table.group_size).float()
        return (qf * s[..., None]).reshape(*qf.shape[:-2], table.orig_dim)
    return table[tokens]
