"""The port's training loss and gradients at the configs' own bf16 compute:
the attention families (llama3.2-3b, qwen2-vl-7b, qwen3-moe-30b-a3b, the
llama4 interleave); the SSM, hybrid and audio families are in
``test_torch_train_loss_ssm.py``.

Seven of the eight reduced configs of ``test_torch_train_loss.py`` compute
in bf16 (llama2-110m computes in f32).  There every op rounds to bf16, and
XLA may keep f32 excess precision inside its fusions where PyTorch rounds
each op, so the two packages' bf16 gradients part by a few percent of
their norm (up to ~10% on the MoE and hybrid configs' 2-layer trees).  So
the port is held to the reference's own bf16 error: against the JAX
gradients of the same weights and batch in f32 compute (the truth), the
port's loss is within ``BF16_RATIO`` times the JAX bf16 loss's error plus
``BF16_LOSS_FLOOR``, and each leaf's gradient within ``BF16_RATIO`` times
the JAX bf16 gradient's relative error (in norm) plus ``BF16_GRAD_FLOOR``.
Measured: gradient ratios 0.9-2.05.  The loss is one number, whose bf16
error may by chance be near 0 in one package (qwen2-vl-7b's JAX loss is
7e-6 from its f32 loss, the port's 1.6e-4): its floor is 1e-3 (1.6e-4 of
the loss), the MoE configs' measured error being 2e-3 in both.

Also, at each config's own dtypes (llama2-110m's f32 here too): autograd
reaches every parameter leaf (none None, all finite), and a leaf's
gradient is all zeros only where the reference's is (``check_every_leaf``;
the SSM, hybrid and audio configs' in ``test_torch_train_loss_ssm.py``).
"""

import functools

import numpy as np
import pytest
import torch

from repro_torch.core.tree import items, keystr
from test_torch_train_loss import jax_value_and_grad, make_batch, models

torch.set_num_threads(2)

BF16_RATIO = 3.0
BF16_LOSS_FLOOR = 1e-3
BF16_GRAD_FLOOR = 1e-3


@functools.lru_cache(maxsize=None)
def port_raw_grads(arch):
    """(loss, [(name, gradient or None)]) of the port at the config's own
    dtypes, straight from ``torch.autograd.grad``."""
    jm, _, tm, tparams = models(arch)
    ws = [w for _, w in items(tparams)]
    for w in ws:
        w.requires_grad_(True)
    try:
        loss = tm.loss(tparams, make_batch(jm.cfg))
        gs = torch.autograd.grad(loss, ws, allow_unused=True)
    finally:
        for w in ws:
            w.requires_grad_(False)
    names = [keystr(p) for p, _ in items(tparams)]
    return float(loss.detach()), list(zip(names, gs))


def check_bf16(arch):
    assert models(arch)[0].cfg.compute_dtype == "bfloat16"
    truth_loss, truth = jax_value_and_grad(arch, "float32")
    jax_loss, jax_g = jax_value_and_grad(arch)
    loss, got = port_raw_grads(arch)
    assert abs(loss - truth_loss) <= (
        BF16_RATIO * abs(jax_loss - truth_loss) + BF16_LOSS_FLOOR), \
        (loss, jax_loss, truth_loss)
    for name, g in got:
        t = truth[name]
        n = np.linalg.norm(t)
        if n == 0:                      # llama4's router: zero in both
            assert not g.any() and not np.any(jax_g[name]), name
            continue
        err = np.linalg.norm(g.float().numpy() - t) / n
        ref = np.linalg.norm(jax_g[name] - t) / n
        assert err <= BF16_RATIO * ref + BF16_GRAD_FLOOR, (name, err, ref)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen2-vl-7b",
                                  "qwen3-moe-30b-a3b",
                                  "llama4-maverick-400b-a17b"])
def test_bf16_loss_and_grads_as_close_as_the_reference(arch):
    check_bf16(arch)


def check_every_leaf(arch):
    """No leaf's gradient is None, each is finite, and it is all zeros
    only at llama4's router (``test_torch_train_loss.py`` holds that set
    against JAX: its top-1 gate is a softmax over one logit, 1 whatever
    the router)."""
    zero = ({"['blocks_moe']['moe']['router']"}
            if arch == "llama4-maverick-400b-a17b" else set())
    _, got = port_raw_grads(arch)
    for name, g in got:
        assert g is not None, name
        assert torch.isfinite(g).all(), name
        assert bool(g.abs().max() > 0) != (name in zero), name


@pytest.mark.parametrize("arch", ["llama2-110m", "llama3.2-3b",
                                  "qwen2-vl-7b", "qwen3-moe-30b-a3b",
                                  "llama4-maverick-400b-a17b"])
def test_every_leaf_gets_a_gradient(arch):
    check_every_leaf(arch)
