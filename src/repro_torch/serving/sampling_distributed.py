"""Communication-avoiding sampling over vocab-sharded logits.

PyTorch counterpart of ``repro/serving/sampling_distributed.py``; the draws
are ``core/prng``'s threefry ``uniform`` and ``categorical``, so one key
gives JAX's token.

``gumbel_argmax``   temperature sampling by the Gumbel-max trick:
                    argmax_v (logits/T + g_v).  The noise of each element
                    is keyed on its *global* vocab index, so a sharded and
                    an unsharded draw from one key give one token.

``topk_candidates`` the k best (value, global index) pairs of each row,
                    ties to the lower index, as ``lax.top_k`` orders them:
                    nucleus sampling on the strip is exact for the mass
                    the strip covers.

With ``mesh`` (``launch/mesh.Mesh``) each rank passes its own slice of the
vocab, ``vocab_range(vocab_size, mesh)`` of it: each rank perturbs its
slice with the noise of the global indices and reduces it locally, and the
ranks exchange (B,) winners (or the (B, k) candidate strips) by
all-gather.  A tie goes to the lowest global index, as ``argmax`` breaks
it, so the sharded tokens equal the unsharded ones bitwise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import prng
from repro_torch.distribution import collectives as C


def vocab_range(vocab_size: int, mesh) -> Tuple[int, int]:
    """(start, length) of this rank's vocab slice on the ``model`` axis:
    contiguous slices of ``ceil(V / n)`` in rank order, the last one
    shorter when n does not divide V."""
    n, r = mesh.shape["model"], mesh.coords["model"]
    per = -(-vocab_size // n)
    start = min(r * per, vocab_size)
    return start, min(per, vocab_size - start)


def _exchange(t: torch.Tensor, mesh) -> torch.Tensor:
    """(n, *t.shape): every rank's ``t`` along the model axis, rank order."""
    group, n = mesh.groups.get("model"), mesh.shape["model"]
    if n == 1:
        return t[None]
    parts = [torch.empty_like(t) for _ in range(n)]
    C.record("all-gather", n * C.nbytes(t), n)
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.stack(parts)


def _gumbel_at(key: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    u = prng.uniform_at(key.to(index.device), index, 1e-20, 1.0)
    return -prng.log(-prng.log(u))


def gumbel_argmax(key: torch.Tensor, logits: torch.Tensor,
                  temperature: float = 1.0, mesh=None,
                  vocab_size: Optional[int] = None,
                  row_start: int = 0) -> torch.Tensor:
    """(B, V) -> (B,) int32 sample ~ softmax(logits / T); ``temperature <=
    0`` takes the argmax.  With ``mesh``, ``logits`` is this rank's
    (B, length) slice of ``vocab_range(vocab_size, mesh)``.  ``row_start``:
    the global index of the first row, where the batch is split over data
    ranks (the noise is keyed on global rows too)."""
    b, vl = logits.shape
    v = vl if mesh is None else vocab_size
    start = 0 if mesh is None else vocab_range(v, mesh)[0]
    if temperature <= 0.0:
        vals = logits
    else:
        cols = torch.arange(start, start + vl, dtype=torch.int64,
                            device=logits.device)
        rows = torch.arange(row_start, row_start + b, dtype=torch.int64,
                            device=logits.device)
        g = _gumbel_at(key, rows[:, None] * v + cols[None])
        vals = logits / temperature + g
    best, at = torch.max(vals, dim=-1)
    if mesh is None:
        return at.to(torch.int32)
    bests = _exchange(best, mesh)                        # (n, B)
    idx = _exchange(at + start, mesh)
    top = torch.amax(bests, dim=0)
    idx = torch.where(bests == top, idx, torch.full_like(idx, v))
    return torch.amin(idx, dim=0).to(torch.int32)


def topk_candidates(logits: torch.Tensor, k: int = 64, mesh=None,
                    vocab_size: Optional[int] = None):
    """(B, V) -> (values (B, k), indices (B, k) int32), values descending
    and ties to the lower index.  With ``mesh``, ``logits`` is this rank's
    vocab slice: each rank's k best, gathered, and the k best of the
    strip."""
    srt = torch.sort(logits, dim=-1, descending=True, stable=True)
    vals, idx = srt.values[:, :k], srt.indices[:, :k]
    if mesh is None:
        return vals, idx.to(torch.int32)
    idx = idx + vocab_range(vocab_size, mesh)[0]
    # rank order is index order: a stable sort keeps ties to the lower one
    vals = torch.cat(list(_exchange(vals, mesh)), dim=-1)
    idx = torch.cat(list(_exchange(idx, mesh)), dim=-1)
    srt = torch.sort(vals, dim=-1, descending=True, stable=True)
    return (srt.values[:, :k],
            torch.gather(idx, -1, srt.indices[:, :k]).to(torch.int32))


def sample_topp_from_candidates(key: torch.Tensor, vals: torch.Tensor,
                                idx: torch.Tensor, temperature: float = 1.0,
                                top_p: float = 1.0) -> torch.Tensor:
    """Nucleus sampling on a (B, k) candidate strip -> (B,) token ids."""
    if temperature <= 0.0:
        return idx[:, 0]
    logits = vals / temperature
    probs = torch.softmax(logits, dim=-1)              # sorted descending
    csum = torch.cumsum(probs, dim=-1)
    keep = (csum - probs) < top_p                       # first always kept
    logits = torch.where(keep, logits, torch.full_like(logits,
                                                       -float("inf")))
    choice = prng.categorical(key.to(logits.device), logits)
    return torch.gather(idx, -1, choice[:, None])[:, 0]


def distributed_sample(key: torch.Tensor, logits: torch.Tensor,
                       temperature: float = 1.0, top_p: float = 1.0,
                       k: int = 64, mesh=None,
                       vocab_size: Optional[int] = None) -> torch.Tensor:
    """Sampling over (possibly vocab-sharded) logits without gathering
    them: ``gumbel_argmax`` at top-p 1, else nucleus sampling on the
    ``topk_candidates`` strip."""
    if top_p >= 1.0:
        return gumbel_argmax(key, logits, temperature, mesh, vocab_size)
    vals, idx = topk_candidates(logits, k, mesh, vocab_size)
    return sample_topp_from_candidates(key, vals, idx, temperature, top_p)
