"""Plain PyTorch versions of the port's CUDA kernels.

Each function computes what its kernel computes, with plain tensor ops and
the signature of ``repro/kernels/ref.py``.  The kernel wrappers in
:mod:`repro_torch.kernels.ops` run these for CPU tensors; the CPU tests hold
them against the JAX package, and ``chip_smoke.py`` holds each kernel against
them on the card.  Nothing on the CUDA main path calls them.
"""

from __future__ import annotations

import torch

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


def ref_decode_attention(q, k, v, lens, k_scale=None, v_scale=None):
    """q: (B, KVH, HQ, D) pre-scaled; k/v: (B, S, KVH, D); lens (B, 1)."""
    s = k.shape[1]
    kf = k.float()
    vf = v.float()
    if k_scale is not None:
        kf = kf * k_scale[..., None]
        vf = vf * v_scale[..., None]
    scores = torch.einsum("bhqd,bshd->bhqs", q.float(), kf)
    pos = torch.arange(s, device=q.device)[None, None, None, :]
    mask = pos < lens[:, None, None, :]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    p = torch.where(mask, p, torch.zeros_like(p))
    return torch.einsum("bhqs,bshd->bhqd", p, vf)


def gather_rows(pool, page_table):
    """(NB, BS, ...) pool -> each row's (B, MB*BS, ...) contiguous view
    through the page table; -1 entries read block 0 (callers mask them)."""
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
