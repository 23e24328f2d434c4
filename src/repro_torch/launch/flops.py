"""Exact algorithmic operation counts of a step, by watching its ATen ops.

PyTorch counterpart of ``repro/launch/flops.py``.  The reference walks a
jaxpr and counts every ``dot_general`` as 2 x (output elements) x (the
product of its contracted dims) and every ``conv_general_dilated`` by
``_conv_flops``'s rule; here :class:`Counter`, a ``TorchDispatchMode``,
sees each ATen op as it runs and counts the contractions the same way:
``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``mv``, ``addmv``, ``dot`` (and
``einsum`` / ``matmul``, which reach ATen as these) at 2 x (output
elements) x K, ``convolution`` at the reference's conv rule.  Nothing
else is counted: an elementwise product and its sum add nothing, as in
the reference.

Nothing like the reference's scan trip-count correction is needed: a
Python loop runs every iteration under the mode, so each is counted.
Work done in a backward pass is counted because it runs inside the mode,
``torch.utils.checkpoint``'s recompute included (the counterpart of the
reference's remat, whose recompute appears in its VJP jaxpr).

The port's kernel wrappers (``kernels/ops.py``) do not reach ATen with
their products: each reports what the reference's walker counts for the
jnp twin of its computation (:func:`report`), and on the CPU runs its
plain version with the count paused (:func:`paused`), so nothing is
counted twice.  On ``meta`` tensors nothing is computed: a step traced on
meta counts exactly what it counts on the card.

A :class:`Counter` built with ``track_memory`` also follows the bytes of
the storages the step allocates while it runs (meta ones included) and
keeps their peak: ``launch/dryrun.py``'s ``temp_bytes``.
"""

from __future__ import annotations

import contextlib
import math
import weakref
from typing import List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

aten = torch.ops.aten

# the counters now active, innermost last; a kernel wrapper's report goes
# to each
_ACTIVE: List["Counter"] = []


def counting() -> bool:
    """Whether a counter is active: the one test a kernel wrapper makes on
    the card."""
    return bool(_ACTIVE)


def report(flops: float) -> None:
    """Add ``flops`` to every active counter (a kernel wrapper's product,
    which no ATen op shows)."""
    for c in _ACTIVE:
        c.flops += flops


@contextlib.contextmanager
def paused():
    """No ATen op is counted inside: a kernel's plain version, whose
    operations its wrapper has already reported."""
    was = [c._paused for c in _ACTIVE]
    for c in _ACTIVE:
        c._paused = True
    try:
        yield
    finally:
        for c, w in zip(_ACTIVE, was):
            c._paused = w


class _Product(torch.autograd.Function):
    """Identity, whose backward reports the transposes of a counted
    product (:func:`product`)."""

    @staticmethod
    def forward(ctx, out, bwd):
        ctx.bwd = bwd
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        report(ctx.bwd)
        return g, None


def product(out: torch.Tensor, *operands: torch.Tensor) -> torch.Tensor:
    """``out``, a product of ``operands`` that contracts nothing (a
    broadcast multiply, or an einsum whose summed dims have size 1, which
    torch computes with ``mul``) where the reference's ``jnp.einsum`` makes
    a ``dot_general``: counted as the walker counts that dot, 2 x output
    elements, and in the backward pass 2 x output elements for each operand
    that takes a gradient (its transpose).  ``out`` itself when no counter
    is active."""
    if not _ACTIVE:
        return out
    n = 2.0 * out.numel()
    report(n)
    grads = sum(t.requires_grad for t in operands)
    if grads and torch.is_grad_enabled():
        return _Product.apply(out, n * grads)
    return out


def _numel(shape) -> int:
    return math.prod(shape)


def _contraction(func, args, out) -> float:
    """2 x output elements x K of one ATen contraction, else 0."""
    if func in (aten.mm.default, aten.bmm.default, aten.mv.default,
                aten.dot.default, aten.vdot.default):
        a = args[0]
    elif func in (aten.addmm.default, aten.baddbmm.default,
                  aten.addmv.default):
        a = args[1]
    elif func is aten.convolution.default:
        return _conv_flops(args[1], out, args[8])
    else:
        return 0.0
    return 2.0 * _numel(out.shape) * a.shape[-1]


def _conv_flops(weight, out, groups) -> float:
    """The reference's ``_conv_flops``: 2 x output elements x (the kernel's
    input-channel dim x its spatial size), over the group count."""
    kernel = _numel(weight.shape[2:]) if weight.dim() > 2 else 1
    return 2.0 * _numel(out.shape) * weight.shape[1] * kernel / max(groups, 1)


_COUNTED = frozenset([
    aten.mm.default, aten.bmm.default, aten.mv.default, aten.dot.default,
    aten.vdot.default, aten.addmm.default, aten.baddbmm.default,
    aten.addmv.default, aten.convolution.default])


class Counter(TorchDispatchMode):
    """Counts the contractions of every ATen op run inside (``flops``);
    with ``track_memory``, also the bytes of the storages made inside that
    are alive (``live_bytes``) and their peak (``peak_bytes``)."""

    def __init__(self, track_memory: bool = False):
        super().__init__()
        self.flops = 0.0
        self.track_memory = track_memory
        self.live_bytes = 0
        self.peak_bytes = 0
        self._paused = False
        self._seen: set = set()

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def _track(self, args, kwargs, out) -> None:
        """Each storage first seen in an op's output that is none of its
        inputs' (a view or an in-place result shares its input's) was made
        by the op: count its bytes until it is freed."""
        inputs = {t.untyped_storage()._cdata
                  for t in tree_leaves((args, kwargs))
                  if isinstance(t, torch.Tensor)}
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            s = t.untyped_storage()
            key = s._cdata
            if key in self._seen or key in inputs:
                continue
            self._seen.add(key)
            n = s.nbytes()
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(s, self._free, key, n)

    def _free(self, key, n) -> None:
        self._seen.discard(key)
        self.live_bytes -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self._paused and func in _COUNTED:
            self.flops += _contraction(func, args, out)
        if self.track_memory:
            self._track(args, kwargs, out)
        return out


def count_flops(fn, *args) -> float:
    """Algorithmic operations of ``fn(*args)`` (the args may be meta
    tensors: nothing is computed then)."""
    with Counter() as c:
        fn(*args)
    return c.flops
