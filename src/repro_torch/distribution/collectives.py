"""Collectives over one mesh axis, with gradients: the operators of a
training forward on a mesh, and the gradient reductions of its step.

A JAX mesh is single-controller: GSPMD partitions the reference's plain
functions and inserts their collectives (``repro/launch/steps.py``'s
``jit_train_step``).  A mesh of the port is one process a rank
(``launch/mesh.py``), so the collectives are written out, as Megatron-LM
writes them for tensor parallelism:

* :func:`copy_to` (Megatron's *f*): identity forward, all-reduce
  backward; it opens a column-parallel product, whose ranks each hand
  back their part of the input's gradient.
* :func:`reduce_from` (Megatron's *g*): all-reduce forward, identity
  backward; it closes a row-parallel product, whose ranks each hold a
  partial sum.
* :func:`gather_from`: all-gather forward, the rank's own slice backward;
  for a leaf stored sharded but computed replicated, where every rank
  computes the same whole gradient.  :func:`gather_sum` is the same
  gather whose backward sums the ranks' gradients before taking the
  slice (a reduce-scatter): along an axis whose ranks hold other rows of
  the batch.
* :func:`split_to`: the rank's own slice forward, all-gather backward.
* :func:`all_reduce` and :func:`reduce_scatter_dim`: the gradients' sum
  over the data axes (no autograd); :func:`all_reduce_max`, a row
  maximum that no gradient goes through.

Every operator takes the axis's process group and size.  On a group of
one (``group`` None, or ``n`` 1) each returns its input as it is and calls
nothing, so a mesh of one adds no arithmetic and changes no bit.

The collective tally: inside :func:`tally`, every collective the port
calls (these operators, ``sharding.all_gather_dim``, the sampler's winner
exchange, the engine's plan broadcast, the checkpoint's barrier and the
mesh's handshake) adds one (kind, output bytes, group size) entry
(:func:`record`); ``launch/collective_cost.py`` prices the entries per
device.  A collective that is skipped (a group of one) adds nothing.
"""

from __future__ import annotations

import contextlib
from typing import Any, List, Tuple

import torch
import torch.distributed as dist

# the tallies now open, innermost last; each entry (kind, output bytes,
# group size), the kinds named as the reference's HLO names them
# (``all-reduce``, ``all-gather``, ``reduce-scatter``), with ``broadcast``
# and ``barrier`` besides
_TALLIES: List[List[Tuple[str, int, int]]] = []


@contextlib.contextmanager
def tally():
    """Collect the collectives called inside: yields the list of their
    (kind, output bytes, group size) entries, in call order."""
    calls: List[Tuple[str, int, int]] = []
    _TALLIES.append(calls)
    try:
        yield calls
    finally:
        _TALLIES.remove(calls)


def tallying() -> bool:
    return bool(_TALLIES)


def record(kind: str, out_bytes: int, group_size: int) -> None:
    """Add one collective to every open tally."""
    for calls in _TALLIES:
        calls.append((kind, int(out_bytes), int(group_size)))


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _one(group, n: int) -> bool:
    return group is None or n <= 1


def _all_gather(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    record("all-gather", n * nbytes(x), n)
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _slice(x: torch.Tensor, dim: int, n: int, index: int) -> torch.Tensor:
    size = x.shape[dim] // n
    return x.narrow(dim, index * size, size).contiguous()


def _reduce_scatter(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    parts = [p.contiguous() for p in x.chunk(n, dim=dim)]
    out = torch.empty_like(parts[0])
    record("reduce-scatter", nbytes(out), n)
    dist.reduce_scatter(out, parts, group=group)
    return out


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        record("all-reduce", nbytes(g), ctx.n)
        dist.all_reduce(g, group=ctx.group)
        return g, None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        y = x.contiguous().clone()
        record("all-reduce", nbytes(y), n)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n, index, summed):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        ctx.index, ctx.summed = index, summed
        return _all_gather(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            out = _reduce_scatter(g, ctx.dim, ctx.group, ctx.n)
        else:
            out = _slice(g, ctx.dim, ctx.n, ctx.index)
        return out, None, None, None, None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n, index):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        return _slice(x, dim, n, index)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group, ctx.n), None, None, None, None


def copy_to(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """Megatron's *f*: ``x`` as it is; its gradient all-reduced."""
    return x if _one(group, n) else _Copy.apply(x, group, n)


def reduce_from(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """Megatron's *g*: ``x`` all-reduced (summed); its gradient as it
    is."""
    return x if _one(group, n) else _Reduce.apply(x, group, n)


def gather_from(x: torch.Tensor, dim: int, group, n: int,
                index: int) -> torch.Tensor:
    """The ``n`` ranks' ``x`` concatenated along ``dim``; the gradient is
    the slice of rank ``index`` (this rank's place along the axis)."""
    if _one(group, n):
        return x
    return _Gather.apply(x, dim, group, n, index, False)


def gather_sum(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """As :func:`gather_from`, the gradient summed over the ranks first
    (a reduce-scatter)."""
    if _one(group, n):
        return x
    return _Gather.apply(x, dim, group, n, 0, True)


def split_to(x: torch.Tensor, dim: int, group, n: int,
             index: int) -> torch.Tensor:
    """Rank ``index``'s slice of ``x`` along ``dim``; the gradient the
    ranks' slices' gradients all-gathered."""
    if _one(group, n):
        return x
    return _Split.apply(x, dim, group, n, index)


@torch.no_grad()
def all_reduce(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """``x`` summed over the group, in place (no gradient)."""
    if not _one(group, n):
        record("all-reduce", nbytes(x), n)
        dist.all_reduce(x, group=group)
    return x


@torch.no_grad()
def all_reduce_max(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the group, a new tensor that
    no gradient goes through."""
    if _one(group, n):
        return x.detach()
    y = x.detach().contiguous().clone()
    record("all-reduce", nbytes(y), n)
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    return y


@torch.no_grad()
def reduce_scatter_dim(x: torch.Tensor, dim: int, group,
                       n: int) -> torch.Tensor:
    """``x`` summed over the group, and this rank's ``1/n`` of it along
    ``dim`` (the ranks' parts in rank order)."""
    return x if _one(group, n) else _reduce_scatter(x, dim, group, n)


def axis(mesh: Any, name: str):
    """(process group, size, this rank's index) of one axis of a mesh."""
    return mesh.groups.get(name), mesh.shape[name], mesh.coords[name]
