"""AdamW with a warmup-then-cosine schedule, global-norm clipping and the
(beyond-paper) Q8_0 gradient compression with error feedback.

PyTorch counterpart of ``repro/optim/adamw.py``, in the reference's order of
operations: the step counter moves first and sets the learning rate; the
gradients are clipped by ``min(1, clip / (norm + 1e-9))``; the moments are
updated in f32 and bias-corrected; weight decay joins the update on the f32
parameter; the result is cast back to the parameter's dtype.  The optimizer
state mirrors the parameters: ``m`` and ``v`` f32 trees and an int32 step.

Unlike the reference, which returns new trees, ``apply_updates`` writes the
parameters and the moments in place (a few pieces of ``_PIECE`` values at a
time, so its temporaries stay small beside llama3.2-3b's 51 GB of weights,
gradients and moments) and returns the same tensors.

``compress_decompress`` is the reference's model of a compressed
all-reduce; as there, ``apply_updates`` applies it only when it is given
``compress_err`` and ``grad_compress_bits`` is 8, and the train step gives
none.

On a train mesh (``launch/steps.py``'s ``jit_train_step``) each rank holds
its shards of the state specs (``train_state_specs``): the gradient norm
sums each element once over the ranks, and under ZeRO-1 a rank updates
only its slice of ``m`` / ``v`` and of the parameter along the dim the
data axes split, then the parameter is all-gathered whole over them.  On a
mesh of one both are the unsharded code, bit for bit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from repro_torch.core.tree import leaves, map_tree
from repro_torch.distribution import collectives as C
from repro_torch.distribution import sharding as sh

# values of one leaf updated at a time (64 MB of f32)
_PIECE = 1 << 24


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    lr_min: float = 3e-5
    warmup_steps: int = 100
    decay_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    grad_compress_bits: int = 0    # 0 = off; 8 = int8 error feedback


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup to ``lr_peak``, then cosine decay to ``lr_min`` at
    ``decay_steps``: a 0-d f32 tensor (on ``step``'s device)."""
    step = torch.as_tensor(step).float()
    warm = cfg.lr_peak * step / max(cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.lr_min + 0.5 * (cfg.lr_peak - cfg.lr_min) * (
        1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_state(params: Any) -> dict:
    """Zero f32 moments shaped as the parameters and step 0 (int32)."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = leaves(params)[0].device
    return {"m": map_tree(zeros, params), "v": map_tree(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: Any, specs: Any = None, mesh=None) -> torch.Tensor:
    """sqrt of the sum over the leaves (in the reference's order) of each
    leaf's f32 sum of squares.  On a ``mesh`` ``tree`` holds the rank's
    shards under ``specs``: each leaf's sum of squares is summed over the
    axes that split it (the leaves split alike in one all-reduce), so each
    element counts once and every rank gets the whole tree's norm."""
    parts = [torch.sum(torch.square(x.float())) for x in leaves(tree)]
    if mesh is not None:
        by_axes = {}
        for i, spec in enumerate(leaves(specs)):
            axes = tuple(a for e in spec for a in sh.live_axes(e, mesh))
            if axes:
                by_axes.setdefault(axes, []).append(i)
        for axes, idx in by_axes.items():
            summed = torch.stack([parts[i] for i in idx])
            for a in axes:
                group, n, _ = C.axis(mesh, a)
                C.all_reduce(summed, group, n)
            for j, i in enumerate(idx):
                parts[i] = summed[j]
    return torch.sqrt(sum(parts))


def compress_decompress(g: torch.Tensor, err: torch.Tensor,
                        group: int = 256):
    """Q8_0 round trip with error feedback, the model of a compressed
    all-reduce: what survives the wire is the int8 codes and one f32 scale
    per ``group`` values.  Returns (the dequantized gradient in g's dtype,
    the new f32 error)."""
    flat = (g.float() + err).reshape(-1)
    n = flat.shape[0]
    fp = torch.nn.functional.pad(flat, (0, (-n) % group)).reshape(-1, group)
    absmax = torch.amax(torch.abs(fp), dim=-1, keepdim=True)
    scale = absmax / 127.0
    inv = torch.where(absmax > 0, 127.0 / absmax, torch.zeros_like(absmax))
    q = torch.clamp(torch.round(fp * inv), -127, 127)
    deq = (q * scale).reshape(-1)[:n].reshape(g.shape)
    new_err = flat[:n].reshape(g.shape) - deq
    return deq.to(g.dtype), new_err


def _pieces(*ts: torch.Tensor):
    """Matching flat pieces (views) of same-shaped contiguous tensors."""
    flat = [t.view(-1) for t in ts]
    for i in range(0, flat[0].numel(), _PIECE):
        yield tuple(f[i:i + _PIECE] for f in flat)


def zero_dim(pspec, ospec, mesh):
    """(dim, spec entry) of the dim ZeRO-1 splits in a moment's spec
    ``ospec`` over live data axes where the parameter's ``pspec`` leaves
    it whole, or None."""
    for d, (pe, oe) in enumerate(zip(pspec, ospec)):
        if pe is None and sh.live_axes(oe, mesh):
            return d, oe
    return None


def gather_zero(p: torch.Tensor, part: torch.Tensor, dim: int, entry,
                mesh) -> None:
    """Write the updated slices ``part`` of every data rank into ``p``
    whole: an all-gather along ``dim`` over the axes of ``entry``."""
    p.copy_(sh.gather(part, (None,) * dim + (entry,), mesh))


@torch.no_grad()
def apply_updates(params: Any, opt_state: dict, grads: Any,
                  cfg: AdamWConfig, compress_err: Optional[Any] = None,
                  mesh=None, specs: Optional[dict] = None):
    """One AdamW step.  Returns (params, opt_state, metrics, new_err):
    ``params`` and the moments updated in place, a new step counter,
    metrics ``lr``, ``grad_norm`` (before clipping) and ``step`` as 0-d
    tensors, and the compression error, ``compress_err`` updated in place
    (as given when compression is off).  Each leaf is clipped, compressed
    and updated ``_PIECE`` values at a time: compression's groups of 256
    never cross a piece, so the pieces compute what whole leaves would.

    On a ``mesh`` every tree holds the rank's shards of ``specs`` (the
    state specs of ``launch/steps.py``'s ``train_state_specs``) and
    ``grads`` the layout of the moments: a leaf ZeRO-1 splits over the
    data axes (``zero_dim``) is updated on the rank's slice alone, then
    gathered whole (``gather_zero``)."""
    step = opt_state["step"] + 1
    lr = lr_schedule(cfg, step)

    ospecs = None if mesh is None else specs["opt"]["m"]
    gnorm = global_norm(grads, ospecs, mesh)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    compress = cfg.grad_compress_bits == 8 and compress_err is not None

    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(b1, step.float())
    bc2 = 1 - torch.pow(b2, step.float())

    trees = [params, grads, opt_state["m"], opt_state["v"]]
    if compress:
        trees.append(compress_err)
    zeros = ([None] * len(leaves(params)) if mesh is None else
             [zero_dim(ps, os_, mesh) for ps, os_ in
              zip(leaves(specs["params"]), leaves(ospecs))])
    for z, (leaf_p, leaf_g, *rest) in zip(zeros, zip(*map(leaves, trees))):
        whole = leaf_p
        if z is not None:
            start, n = sh.shard_range(leaf_p.shape[z[0]], z[1], mesh)
            leaf_p = leaf_p.narrow(z[0], start, n).contiguous()
        for p, g, m, v, *err in _pieces(leaf_p, leaf_g.contiguous(), *rest):
            g = g * scale
            if compress:
                g, e = compress_decompress(g, err[0])
                err[0].copy_(e)
            g32 = g.float()
            m2 = b1 * m + (1 - b1) * g32
            v2 = b2 * v + (1 - b2) * torch.square(g32)
            mh = m2 / bc1
            vh = v2 / bc2
            delta = mh / (torch.sqrt(vh) + cfg.eps) \
                + cfg.weight_decay * p.float()
            p.copy_((p.float() - lr * delta).to(p.dtype))
            m.copy_(m2)
            v.copy_(v2)
        if z is not None:
            gather_zero(whole, leaf_p, z[0], z[1], mesh)
    metrics = {"lr": lr, "grad_norm": gnorm, "step": step}
    return params, {"m": opt_state["m"], "v": opt_state["v"],
                    "step": step}, metrics, compress_err
