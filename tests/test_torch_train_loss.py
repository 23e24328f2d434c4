"""The port's training loss and its gradients against the JAX package.

Both packages get the same weights (JAX ``init``, carried across by
``repro_torch.bridge``) and the same seeded batch; ``Model.loss`` and
``steps.value_and_grad`` against ``jax.value_and_grad(model.loss)``, for
the eight reduced configs of every family: dense (llama2-110m,
llama3.2-3b), vlm (qwen2-vl-7b on ``embeds``, M-RoPE), MoE
(qwen3-moe-30b-a3b, grouped dispatch), the llama4 interleave, ssm
(mamba2-370m), hybrid (zamba2-1.2b) and audio (whisper-small).

Here every config runs in f32 compute, so the two differ only by f32
summation order: the loss within ``LOSS_ATOL``, each gradient leaf within
``GRAD_RTOL`` of that leaf's largest reference magnitude (``BF16_LEAF_RTOL``
for a leaf stored in bf16: the MoE configs' params, whose gradients round
to bf16 once); so a leaf's gradient is all zeros exactly where the
reference's is (only llama4's router: its top-1 gate is a softmax over one
logit, 1 whatever the router).  The configs' own bf16 compute is held in
``test_torch_train_loss_bf16.py`` (the attention families) and
``test_torch_train_loss_ssm.py`` (the SSM, hybrid and audio families, and
the check that every leaf gets a gradient).  Also: the
loss never reaches a CUDA kernel's entry (the one-shot prefill's
``flash_prefill`` has no backward), and the reference's
``test_microbatched_matches_full_batch``.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import build_model as jax_build_model
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax
from repro_torch.core.tree import items, keystr
from repro_torch.kernels import build, ops
from repro_torch.launch import steps as tsteps
from repro_torch.models.model import build_model
from repro_torch.optim import adamw as tadamw

torch.set_num_threads(2)

ARCHS = ["llama2-110m", "llama3.2-3b", "qwen2-vl-7b", "qwen3-moe-30b-a3b",
         "llama4-maverick-400b-a17b", "mamba2-370m", "zamba2-1.2b",
         "whisper-small"]
LOSS_ATOL = 1e-5
GRAD_RTOL = 1e-4
BF16_LEAF_RTOL = 2.0 ** -7


def make_batch(jcfg, b=2, s=64, seed=0):
    """Labels with tokens, a vlm frontend's embeds, or frames and tokens
    (audio), drawn with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    batch = {"labels": rng.integers(0, jcfg.vocab_size, (b, s)).astype(
        np.int32)}
    if jcfg.family == "vlm":
        batch["embeds"] = rng.standard_normal(
            (b, s, jcfg.d_model)).astype(np.float32)
    else:
        batch["tokens"] = rng.integers(0, jcfg.vocab_size, (b, s)).astype(
            np.int32)
    if jcfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (b, jcfg.enc_seq, jcfg.d_model)).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def models(arch, compute_dtype=None):
    """(JAX model, its init at key 0, the port's model, the same weights in
    the port), the compute dtype replaced when given."""
    jcfg = reduced(get_config(arch))
    tcfg = tconfigs.reduced(tconfigs.get_config(arch))
    if compute_dtype:
        jcfg = jcfg.with_(compute_dtype=compute_dtype)
        tcfg = tcfg.with_(compute_dtype=compute_dtype)
    jm = jax_build_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return jm, jparams, build_model(tcfg), tparams


@functools.lru_cache(maxsize=None)
def jax_value_and_grad(arch, compute_dtype=None):
    jm, jparams, _, _ = models(arch, compute_dtype)
    batch = make_batch(jm.cfg)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, batch)))(jparams)
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    return float(loss), {jax.tree_util.keystr(p): np.asarray(g, np.float32)
                         for p, g in flat}


def port_value_and_grad(arch, compute_dtype=None):
    jm, _, tm, tparams = models(arch, compute_dtype)
    loss, grads = tsteps.value_and_grad(tm, tparams, make_batch(jm.cfg))
    return float(loss), {keystr(p): g for p, g in items(grads)}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax_in_f32(arch):
    want_loss, want = jax_value_and_grad(arch, "float32")
    got_loss, got = port_value_and_grad(arch, "float32")
    assert abs(got_loss - want_loss) <= LOSS_ATOL, (got_loss, want_loss)
    assert set(got) == set(want)
    # all zeros only where the top-1 gate is a softmax over one logit
    assert {k for k, w in want.items() if not np.any(w)} == (
        {"['blocks_moe']['moe']['router']"}
        if arch == "llama4-maverick-400b-a17b" else set())
    for name, g in got.items():
        rtol = BF16_LEAF_RTOL if g.dtype == torch.bfloat16 else GRAD_RTOL
        w = want[name]
        err = np.abs(g.float().numpy() - w).max()
        assert err <= rtol * np.abs(w).max(), (name, err, np.abs(w).max())


@pytest.mark.parametrize("arch", ["llama2-110m", "whisper-small"])
def test_training_never_reaches_a_kernel_entry(arch, monkeypatch):
    """The loss runs the reference's jnp attention
    (``layers.attention_scores_blockwise``), never ``ops.flash_prefill``,
    whose CUDA kernel has no backward; and no entry counts a launch."""
    def refuse(*a, **k):
        raise AssertionError("the training forward reached flash_prefill")
    monkeypatch.setattr(ops, "flash_prefill", refuse)
    build.reset_launches()
    jm, _, tm, tparams = models(arch)
    loss, _ = tsteps.value_and_grad(tm, tparams, make_batch(jm.cfg))
    assert torch.isfinite(loss)
    assert all(v == 0 for v in build.LAUNCHES.values())


def test_microbatched_matches_full_batch():
    """The reference's test on the port: grad accumulation over 4
    microbatches gives the same first-step loss and update as one batch."""
    cfg = tconfigs.reduced(tconfigs.get_config("llama2-110m")).with_(
        compute_dtype="float32", remat="none")
    model = build_model(cfg)
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, 32)),
             "labels": rng.integers(0, cfg.vocab_size, (4, 32))}
    ocfg = tadamw.AdamWConfig()
    out = []
    for k in (1, 4):
        params = model.init(0, device="cpu")
        state = {"params": params, "opt": tadamw.init_state(params)}
        out.append(tsteps.make_train_step(model, ocfg, microbatches=k)(
            state, batch))
    (s1, m1), (s2, m2) = out
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5)
    w1 = items(s1["params"])[0][1].numpy()
    w2 = items(s2["params"])[0][1].numpy()
    np.testing.assert_allclose(w1, w2, rtol=1e-4, atol=1e-5)
