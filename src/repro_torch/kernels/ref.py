"""Plain PyTorch versions of the port's CUDA kernels.

Each function computes what its kernel computes, with plain tensor ops and
the signature of ``repro/kernels/ref.py``.  The kernel wrappers in
:mod:`repro_torch.kernels.ops` run these for CPU tensors; the CPU tests hold
them against the JAX package, and ``chip_smoke.py`` holds each kernel against
them on the card.  Nothing on the CUDA main path calls them.
"""

from __future__ import annotations

import torch

from repro_torch.core.quantization import _unpack_nibbles, quantize

NEG_INF = -1e30


def ref_q8_matmul(xq: torch.Tensor, xs: torch.Tensor, wq: torch.Tensor,
                  ws: torch.Tensor, group_size: int = 64) -> torch.Tensor:
    """Integer-exact grouped matmul: (M,K)i8,(M,G)f32 x (N,K)i8,(N,G)f32.

    Each group's int8 dot products run as an f32 product of the codes,
    which is exact: a group's partial sums are integers below
    64*127*127 < 2**24 (CUDA has no int32 matmul).  Groups fold into f32 one
    by one as ``acc + (part * xs) * ws``, the reference's integer-strategy
    order."""
    m, k = xq.shape
    n = wq.shape[0]
    g = k // group_size
    xg = xq.reshape(m, g, group_size).float()
    wg = wq.reshape(n, g, group_size).float()
    acc = torch.zeros((m, n), dtype=torch.float32, device=xq.device)
    for i in range(g):
        part = torch.matmul(xg[:, i], wg[:, i].T)
        acc = acc + part * xs[:, i, None] * ws[None, :, i]
    return acc


def ref_q4_matvec(xq, xs, wq_packed, ws, group_size: int = 64):
    """Q8_0 activations (M, K) x packed Q4_0 weights (N, K/2): the nibbles
    unpack (low = even index, sign-extended) and the Q8 function runs."""
    return ref_q8_matmul(xq, xs, _unpack_nibbles(wq_packed), ws, group_size)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """The model's RMSNorm (``layers.rms_norm``), and the norm half of
    :func:`ref_rmsnorm_quant`."""
    x32 = x.float()
    ms = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    # gamma stays f32: the paper keeps RMSNorm parameters unquantized
    return (x32 * torch.rsqrt(ms + eps) * gamma.float()).to(x.dtype)


def ref_rmsnorm_quant(x, gamma, eps: float = 1e-5, group_size: int = 64):
    """RMSNorm with f32 ``gamma`` then Q8_0 per group of ``group_size``:
    (M, K) f32 -> (codes (M, K) int8, scales (M, K / group_size) f32).  The
    port's own pair, :func:`rms_norm` then ``quantization.quantize``, so
    the fused and the unfused paths agree bit for bit on the CPU."""
    t = quantize(rms_norm(x, gamma, eps), group_size=group_size, bits=8)
    return t.q, t.scale


def ref_rope(x, cos, sin):
    """x (B, H, D); cos/sin (B, D) broadcast over the heads:
    ``x * cos + [-x2, x1] * sin``."""
    d = x.shape[-1]
    x32 = x.float()
    rot = torch.cat([-x32[..., d // 2:], x32[..., : d // 2]], dim=-1)
    return (x32 * cos[:, None] + rot * sin[:, None]).to(x.dtype)


def ref_flash_prefill(q, k, v, causal: bool = True, q_offset=None,
                      q_lens=None, k_lens=None, scale=None):
    """Flash-prefill attention as one softmax, in f32.  q (B, Sq, H, D)
    scaled by ``scale`` here, as the kernel does (None: D^-1/2; 1.0 for a
    q the caller pre-scaled); k/v (B, Sk, KVH, D), kv
    head ``h // (H / KVH)``.  Row b's query i sits at position
    ``q_offset[b] + i`` and attends keys ``< k_lens[b]`` (and ``<=`` its
    position when causal); queries at or past ``q_lens[b]``, and queries
    with no live key, are 0.  ``q_offset``/``q_lens``/``k_lens`` are (B,)
    int32 or None (0, Sq, Sk)."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    dev = q.device

    def per_row(x, fill):
        return (torch.full((b,), fill, dtype=torch.int32, device=dev)
                if x is None else x.reshape(b).to(dev))

    off, ql, kl = per_row(q_offset, 0), per_row(q_lens, sq), per_row(k_lens,
                                                                     sk)
    kr = torch.repeat_interleave(k.float(), h // kvh, dim=2)
    vr = torch.repeat_interleave(v.float(), h // kvh, dim=2)
    scale = d ** -0.5 if scale is None else scale
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, kr)
    kpos = torch.arange(sk, device=dev)
    qi = torch.arange(sq, device=dev)
    mask = (kpos[None, None] < kl[:, None, None]) \
        & (qi[None, :, None] < ql[:, None, None])           # (B, Sq, Sk)
    if causal:
        qpos = off[:, None] + qi[None]                       # (B, Sq)
        mask = mask & (kpos[None, None] <= qpos[..., None])
    mask = mask[:, None]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    m = torch.amax(scores, dim=-1, keepdim=True)
    e = torch.where(mask, torch.exp(scores - m), torch.zeros_like(scores))
    l = torch.sum(e, dim=-1, keepdim=True)
    p = e / torch.where(l > 0, l, torch.ones_like(l))
    return torch.einsum("bhqk,bkhd->bqhd", p, vr)


def ref_decode_attention(q, k, v, lens, k_scale=None, v_scale=None):
    """q: (B, KVH, HQ, D) pre-scaled; k/v: (B, S, KVH, D) f32, bf16 or
    int8 codes with k/v_scale (B, S, KVH); lens (B, 1).  Computed in
    f32."""
    s = k.shape[1]
    kf = k.float()
    vf = v.float()
    if k_scale is not None:
        kf = kf * k_scale[..., None]
        vf = vf * v_scale[..., None]
    # K as (B, KVH, D, S) in one contiguous layout: the product then takes
    # one path whatever the head count, so a head's scores are the same
    # bits in a call over one KV head as over all of them (a mesh rank's
    # slice; the einsum took a transposed path for a lone head)
    scores = torch.matmul(q.float(), kf.permute(0, 2, 3, 1).contiguous())
    pos = torch.arange(s, device=q.device)[None, None, None, :]
    mask = pos < lens[:, None, None, :]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    p = torch.where(mask, p, torch.zeros_like(p))
    return torch.einsum("bhqs,bshd->bhqd", p, vf)


def gather_rows(pool, page_table):
    """(NB, BS, ...) pool -> each row's (B, MB*BS, ...) contiguous view
    through the page table; -1 entries read block 0, as the reference's do
    (callers mask by length only)."""
    b, mb = page_table.shape
    safe = torch.clamp(page_table.long(), min=0)
    g = pool[safe]                                  # (B, MB, BS, ...)
    return g.reshape(b, mb * pool.shape[1], *pool.shape[2:])


def ref_paged_decode_attention(q, k_pool, v_pool, page_table, lens,
                               ks_pool=None, vs_pool=None):
    """Gather-then-dense plain version of the paged decode kernel.

    q: (B, KVH, HQ, D) pre-scaled; k/v_pool: (NB, BS, KVH, D);
    page_table: (B, MB) int32 (-1 = unassigned); lens: (B,) int32."""
    b = page_table.shape[0]
    k = gather_rows(k_pool, page_table)
    v = gather_rows(v_pool, page_table)
    ks = vs = None
    if ks_pool is not None:
        ks = gather_rows(ks_pool, page_table)
        vs = gather_rows(vs_pool, page_table)
    return ref_decode_attention(q, k, v, lens.reshape(b, 1), ks, vs)


def ref_paged_prefill_attention(q, k_pool, v_pool, page_table, pfx_lens,
                                ks_pool=None, vs_pool=None):
    """Gather-then-dense plain version of the paged prefix-attention kernel.

    q: (B, C, H, D) pre-scaled; k/v_pool: (NB, BS, KVH, D); page_table
    (B, MB) int32; pfx_lens (B,) int32.  Returns the segment's flash state
    in the merge layout: out (B, C, H, D), m (B, H, C, 1), l (B, H, C, 1).
    An empty prefix gives exactly (0, -1e30, 0)."""
    b, mb = page_table.shape
    bs, kvh = k_pool.shape[1], k_pool.shape[2]
    h = q.shape[2]
    k = gather_rows(k_pool, page_table).float()
    v = gather_rows(v_pool, page_table).float()
    if ks_pool is not None:
        k = k * gather_rows(ks_pool, page_table)[..., None]
        v = v * gather_rows(vs_pool, page_table)[..., None]
    kr = torch.repeat_interleave(k, h // kvh, dim=2)
    vr = torch.repeat_interleave(v, h // kvh, dim=2)
    scores = torch.einsum("bchd,bshd->bhcs", q.float(), kr)
    valid = (torch.arange(mb * bs, device=q.device)[None]
             < pfx_lens.reshape(b)[:, None])[:, None, None, :]
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    m = torch.amax(scores, dim=-1, keepdim=True)
    e = torch.where(valid, torch.exp(scores - m), torch.zeros_like(scores))
    l = torch.sum(e, dim=-1, keepdim=True)
    out = torch.einsum("bhcs,bshd->bchd",
                       e / torch.where(l > 0, l, torch.ones_like(l)), vr)
    return out, m, l
