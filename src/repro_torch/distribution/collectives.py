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
  computes the same whole gradient.
* :func:`split_to`: the rank's own slice forward, all-gather backward.
* :func:`to_owners` and :func:`from_owners`: the two all-to-alls of
  expert parallelism (GShard's dispatch and return), each the other's
  backward: a rank's capacity slots of every expert go to the rank that
  holds the expert, and its results come back.
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
import pickle
from typing import Any, List, Tuple

import torch
import torch.distributed as dist

# the tallies now open, innermost last; each entry (kind, output bytes,
# group size), the kinds named as the reference's HLO names them
# (``all-reduce``, ``all-gather``, ``reduce-scatter``, ``all-to-all``),
# with ``broadcast`` and ``barrier`` besides
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
    def forward(ctx, x, dim, group, n, index):
        ctx.dim, ctx.group, ctx.n, ctx.index = dim, group, n, index
        return _all_gather(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.dim, ctx.n, ctx.index), None, None, None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n, index):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        return _slice(x, dim, n, index)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group, ctx.n), None, None, None, None


def _exchange(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """x (n, ...): part k goes to rank k of the group; the result's part k
    is what rank k sent this rank (an all-to-all)."""
    x = x.contiguous()
    out = torch.empty_like(x)
    record("all-to-all", nbytes(out), n)
    dist.all_to_all_single(out, x, group=group)
    return out


def _send_slots(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """xin (E, G, C, ...) -> (E/n, n*G, C, ...): the slots of experts
    [k*E/n, (k+1)*E/n) go to rank k, and the rank's own experts take the
    n ranks' groups, in rank order."""
    e, g = x.shape[:2]
    got = _exchange(x.reshape(n, e // n, *x.shape[1:]), group, n)
    return got.transpose(0, 1).reshape(e // n, n * g, *x.shape[2:])


def _return_slots(y: torch.Tensor, group, n: int) -> torch.Tensor:
    """(E/n, n*G, C, ...) -> (E, G, C, ...): :func:`_send_slots` undone,
    each rank's groups back to it with every expert's results."""
    el, ng = y.shape[:2]
    parts = y.reshape(el, n, ng // n, *y.shape[2:]).transpose(0, 1)
    return _exchange(parts, group, n).reshape(n * el, ng // n, *y.shape[2:])


class _ToOwners(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _send_slots(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return _return_slots(g, ctx.group, ctx.n), None, None


class _FromOwners(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group, n):
        ctx.group, ctx.n = group, n
        return _return_slots(y, group, n)

    @staticmethod
    def backward(ctx, g):
        return _send_slots(g, ctx.group, ctx.n), None, None


def to_owners(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """Expert parallelism's dispatch over an axis of ``n`` ranks that hold
    other rows and ``E/n`` experts each: this rank's capacity buffer
    (E, G, C, D) -> its experts' slots from every rank (E/n, n*G, C, D),
    the groups in rank order.  The backward is :func:`from_owners`."""
    return x if _one(group, n) else _ToOwners.apply(x, group, n)


def from_owners(y: torch.Tensor, group, n: int) -> torch.Tensor:
    """The return of :func:`to_owners`: the rank's experts' results on
    every rank's slots (E/n, n*G, C, D) -> this rank's slots of every
    expert (E, G, C, D).  The backward is :func:`to_owners`."""
    return y if _one(group, n) else _FromOwners.apply(y, group, n)


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
    return _Gather.apply(x, dim, group, n, index)


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


def from_rank0(obj: Any, mesh: Any) -> Any:
    """Rank 0's picklable ``obj`` on every rank of ``mesh`` (one broadcast
    on the host, over the mesh's ``host_group`` where it has one, else its
    gloo ``group``; tallied as ``broadcast``), so that it never waits for
    work queued on the card; ``obj`` itself on a mesh of one.  A rank
    other than 0 may pass anything: its ``obj`` is not sent."""
    if mesh is None or mesh.size == 1:
        return obj
    box = [obj if mesh.rank == 0 else None]
    if mesh.host_group is None:
        group, dev = mesh.group, mesh.device
    else:
        group, dev = mesh.host_group, torch.device("cpu")
    dist.broadcast_object_list(box, src=0, group=group, device=dev)
    if tallying():
        record("broadcast", len(pickle.dumps(box[0])), mesh.size)
    return box[0]


def axis(mesh: Any, name: str):
    """(process group, size, this rank's index) of one axis of a mesh."""
    return mesh.groups.get(name), mesh.shape[name], mesh.coords[name]
