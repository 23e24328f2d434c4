"""The port's optimizer and data pipeline against the JAX package.

``optim/adamw.py``: the schedule, the global norm, clipping, compression
and several AdamW steps against the reference's on the same trees and
gradients.  The port updates in place and in pieces, the reference
functionally in one expression per leaf; both compute each value in f32 in
the same order, but XLA may contract a product and a sum into one rounding
where PyTorch rounds twice, so values are held to ``F32_RTOL`` (the
moments, the parameters, the learning rate and the norm), the step counter
exactly; the compression error to the rounding of the clipped gradient.
With compression a code may round the other way where its input lies
within an ulp of a rounding boundary: at most 1e-3 of the elements may
then part, by at most two learning rates a step.
``compress_decompress`` is held to 1e-6 of the gradient's scale in its
dequantized values and its error.

``data/pipeline.py`` is the reference's numpy code: batches, ``state()``,
``restore()`` (across the two packages, both ways) and ``eval_batches`` are
held bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as jdata
from repro.optim import adamw as jadamw
from repro_torch.data import pipeline as tdata
from repro_torch.optim import adamw as tadamw

F32_RTOL = 2e-6


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((8, 8)).astype(np.float32) * scale,
            "b": rng.standard_normal((8,)).astype(np.float32) * scale,
            "blk": {"big": rng.standard_normal((300, 70)).astype(
                np.float32) * scale}}


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(tree):
    return jax.tree_util.tree_map(torch.from_numpy, tree)


def _close(got, want, rtol=F32_RTOL, flips=0.0, flip_atol=0.0):
    """Leaves within rtol (of each leaf's largest magnitude too); with
    ``flips``, that share of the elements may part by up to ``flip_atol``
    instead."""
    g = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda t: t.numpy(), got))
    w = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, want))
    assert len(g) == len(w)
    for a, b in zip(g, w):
        d = np.abs(a - b)
        off = d > rtol * np.abs(b) + rtol * np.abs(b).max()
        assert off.mean() <= flips and (d[off].max(initial=0) <= flip_atol
                                        or not off.any()), (off.sum(), d.max())


@pytest.mark.parametrize("cfg", [
    jadamw.AdamWConfig(lr_peak=1e-3, lr_min=1e-5, warmup_steps=10,
                       decay_steps=100),
    jadamw.AdamWConfig(warmup_steps=7, decay_steps=30),
    jadamw.AdamWConfig(warmup_steps=1, decay_steps=2)], ids=str)
def test_schedule_matches_jax(cfg):
    tcfg = tadamw.AdamWConfig(**dataclasses.asdict(cfg))
    for s in [0, 1, 5, 6, 7, 10, 29, 30, 50, 100, 1000]:
        want = float(jadamw.lr_schedule(cfg, jnp.asarray(s)))
        got = float(tadamw.lr_schedule(tcfg, torch.tensor(s)))
        assert got == pytest.approx(want, rel=F32_RTOL), s


def test_global_norm_and_clip_match_jax():
    g = _tree(3, 1e6)
    assert float(tadamw.global_norm(_t(g))) == pytest.approx(
        float(jadamw.global_norm(_j(g))), rel=F32_RTOL)
    # the reference's test_clip_norm: the raw norm is reported
    cfg = tadamw.AdamWConfig(clip_norm=1e-3)
    params = _t(_tree(1))
    _, _, metrics, _ = tadamw.apply_updates(
        params, tadamw.init_state(params), _t(g), cfg)
    assert float(metrics["grad_norm"]) > 1e3


@pytest.mark.parametrize("compress", [False, True])
def test_apply_updates_matches_jax_over_steps(compress):
    """Six steps of gradients of 1e-3..1e3 (clipping on and off), both
    packages from the same params; with ``compress`` each step passes the
    error-feedback state, as a compressed all-reduce would."""
    cfg = jadamw.AdamWConfig(lr_peak=1e-2, warmup_steps=2, decay_steps=6,
                             grad_compress_bits=8 if compress else 0)
    tcfg = tadamw.AdamWConfig(**dataclasses.asdict(cfg))
    jp, tp = _j(_tree(0)), _t(_tree(0))
    jo, to = jadamw.init_state(jp), tadamw.init_state(tp)
    je = jax.tree_util.tree_map(jnp.zeros_like, jp) if compress else None
    te = jax.tree_util.tree_map(torch.zeros_like, tp) if compress else None
    for step, scale in enumerate([1e-3, 1e-1, 1.0, 10.0, 1e3, 0.5]):
        g = _tree(10 + step, scale)
        jp, jo, jm, je = jadamw.apply_updates(jp, jo, _j(g), cfg, je)
        tp2, to, tm, te = tadamw.apply_updates(tp, to, _t(g), tcfg, te)
        assert tp2 is tp                          # updated in place
        assert int(tm["step"]) == int(jm["step"]) == step + 1
        assert int(to["step"]) == step + 1
        for k in ("lr", "grad_norm"):
            assert float(tm[k]) == pytest.approx(float(jm[k]),
                                                 rel=F32_RTOL), k
        # compressed: a code rounds the other way where (g + err) lies
        # within an ulp of a rounding boundary; such an element's update
        # parts by at most 2 lr a step, and its moments keep the change
        kw = dict(flips=1e-3, flip_atol=2 * cfg.lr_peak * (step + 1)) \
            if compress else {}
        _close(tp, jp, **kw)
        _close(to["m"], jo["m"], **kw)
        _close(to["v"], jo["v"], **kw)
        if compress:
            # the error is a small difference of f32 values of the clipped
            # gradient's size: held to their rounding, not its own
            clip = min(1.0, cfg.clip_norm / float(jm["grad_norm"]))
            for a, b, x in zip(jax.tree_util.tree_leaves(te),
                               jax.tree_util.tree_leaves(je),
                               jax.tree_util.tree_leaves(g)):
                d = np.abs(a.numpy() - np.asarray(b))
                off = d > F32_RTOL * clip * np.abs(x).max()
                assert off.mean() <= 1e-3, off.sum()


def test_train_step_passes_no_compression_error():
    """The reference fact the port keeps: ``apply_updates`` without an
    error state compresses nothing, so ``grad_compress_bits`` 8 gives the
    update of 0."""
    out = []
    for bits in (0, 8):
        cfg = tadamw.AdamWConfig(grad_compress_bits=bits)
        p = _t(_tree(0))
        tadamw.apply_updates(p, tadamw.init_state(p), _t(_tree(5)), cfg)
        out.append(p)
    for a, b in zip(jax.tree_util.tree_leaves(out[0]),
                    jax.tree_util.tree_leaves(out[1])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n,scale", [(64, 1e-4), (1000, 1.0), (257, 3e3),
                                     (4096, 1e4)])
def test_compress_decompress_matches_jax(n, scale):
    g = np.random.default_rng(n).standard_normal(n).astype(np.float32) \
        * scale
    err_j, err_t = jnp.zeros(n), torch.zeros(n)
    sent_j = sent_t = 0
    for _ in range(8):
        dj, err_j = jadamw.compress_decompress(jnp.asarray(g), err_j)
        dt, err_t = tadamw.compress_decompress(torch.from_numpy(g), err_t)
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj),
                                   rtol=0, atol=1e-6 * scale)
        np.testing.assert_allclose(err_t.numpy(), np.asarray(err_j),
                                   rtol=0, atol=1e-6 * scale)
        sent_t = sent_t + dt.numpy()
    # the reference's error-feedback property: 8 rounds send ~8 g
    rel = np.linalg.norm(sent_t / 8 - g) / np.linalg.norm(g)
    assert rel < 0.02


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

DATA = [dict(vocab_size=512, seq_len=64, batch_size=2, seed=7),
        dict(vocab_size=32000, seq_len=128, batch_size=2),
        dict(vocab_size=300, seq_len=33, batch_size=3, host_id=1,
             n_hosts=2)]


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("kw", DATA, ids=lambda kw: str(kw["vocab_size"]))
def test_batches_and_state_bitwise(kw):
    jd = jdata.SyntheticTinyStories(jdata.DataConfig(**kw))
    td = tdata.SyntheticTinyStories(tdata.DataConfig(**kw))
    ji, ti = jd.batches(), td.batches()
    for _ in range(3):
        _same(next(ti), next(ji))
        assert td.state() == jd.state()
    assert (tdata.PAD, tdata.BOS, tdata.EOS, tdata.SEP) == (
        jdata.PAD, jdata.BOS, jdata.EOS, jdata.SEP)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_state_restores_across_packages(writer):
    kw = DATA[0]
    src = (jdata if writer == "jax" else tdata).SyntheticTinyStories(
        (jdata if writer == "jax" else tdata).DataConfig(**kw))
    it = src.batches()
    next(it)
    st = src.state()
    want = next(it)
    dst_mod = tdata if writer == "jax" else jdata
    dst = dst_mod.SyntheticTinyStories(dst_mod.DataConfig(**kw))
    dst.restore(st)
    _same(next(dst.batches()), want)


def test_eval_batches_bitwise():
    for kw in DATA[:2]:
        for a, b in zip(tdata.eval_batches(tdata.DataConfig(**kw), 2),
                        jdata.eval_batches(jdata.DataConfig(**kw), 2)):
            _same(a, b)
