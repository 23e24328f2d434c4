"""Train, prefill and serve steps.

PyTorch counterpart of the step bodies of ``repro/launch/steps.py``
(``make_train_step``, ``make_prefill_step``, ``make_serve_step``).  The
reference's GSPMD wrappers (``jit_train_step``, ``train_state_specs``,
``pick_microbatches``) shard these bodies over a mesh and wait for the
port's mesh (ROADMAP, queue A); on one device the reference computes the
same function, replicated.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.core.quantization import QuantizedTensor
from repro_torch.core.tree import leaves, map_tree, unflatten
from repro_torch.models.model import Model
from repro_torch.optim import adamw


def value_and_grad(model: Model, params: Any,
                   batch: Dict[str, Any]) -> Tuple[torch.Tensor, Any]:
    """(loss, gradients): ``model.loss`` of ``batch`` (detached) and its
    gradient with respect to every leaf of ``params``, a tree shaped as
    ``params`` in each leaf's dtype, zeros for a leaf the loss does not
    read (as ``jax.value_and_grad`` gives).  The leaves are marked to
    require gradients only for the call."""
    ws = leaves(params)
    if any(isinstance(w, QuantizedTensor) for w in ws):
        raise TypeError("training needs float parameters: a quantized "
                        "leaf has no gradient")
    for w in ws:
        w.requires_grad_(True)
    try:
        loss = model.loss(params, batch)
        gs = torch.autograd.grad(loss, ws, allow_unused=True)
    finally:
        for w in ws:
            w.requires_grad_(False)
    gs = [torch.zeros_like(w) if g is None else g for w, g in zip(ws, gs)]
    return loss.detach(), unflatten(params, gs)


def make_train_step(model: Model, ocfg: adamw.AdamWConfig,
                    microbatches: int = 1):
    """``train_step(state, batch) -> (state, metrics)``: the loss and its
    gradients, then one AdamW step (``adamw.apply_updates``, in place; no
    compression error is passed, as in the reference, so
    ``grad_compress_bits`` changes nothing).  With ``microbatches`` k > 1
    the batch is cut into k sequential slices along its first axis, the
    gradients summed in f32 and divided by k, the loss the mean: one
    microbatch's activations at a time, the same effective batch.
    ``metrics``: ``loss``, ``lr``, ``grad_norm`` and ``step``, 0-d
    tensors."""

    def train_step(state, batch):
        params = state["params"]
        if microbatches == 1:
            loss, grads = value_and_grad(model, params, batch)
        else:
            n = next(iter(batch.values())).shape[0] // microbatches
            grads, loss = None, None
            for i in range(microbatches):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                lo, g = value_and_grad(model, params, mb)
                g = map_tree(lambda x: x.float(), g)
                grads = g if grads is None else map_tree(torch.add, grads, g)
                loss = lo if loss is None else loss + lo
            k = float(microbatches)
            grads = map_tree(lambda g: g / k, grads)
            loss = loss / k
        params, opt, metrics, _ = adamw.apply_updates(
            params, state["opt"], grads, ocfg)
        metrics["loss"] = loss
        return {"params": params, "opt": opt}, metrics

    return train_step


def make_prefill_step(model: Model, max_seq: int):
    def prefill_step(params, batch):
        return model.prefill(params, batch, max_seq=max_seq)
    return prefill_step


def make_serve_step(model: Model):
    def serve_step(params, cache, tokens):
        return model.decode_step(params, cache, tokens)
    return serve_step
