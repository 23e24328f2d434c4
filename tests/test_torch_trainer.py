"""The port's trainer (``repro_torch.launch.train``) on the CPU, with the
reference's ``test_system.py`` and ``test_elastic.py`` cases, and against
the JAX trainer.

The reduced llama2-110m computes in f32: a JAX-written checkpoint resumed
by the port's trainer gives the JAX trainer's next losses within
``RESUME_ATOL`` (the same parameters, moments, schedule and data state; the
two differ by f32 summation order only).  ``--grad-compress`` changes no
loss in either package (the reference's train step passes no compression
error).  The two trainers' fresh runs draw different inits (each package
its own generator), so only a restored run is compared across them.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.launch import train as jtrain
from repro_torch.checkpoint import store
from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import DataConfig, SyntheticTinyStories
from repro_torch.kernels import build
from repro_torch.launch import steps as steplib
from repro_torch.launch import train
from repro_torch.models.model import build_model
from repro_torch.optim import adamw
from repro_torch.runtime.health import HeartbeatMonitor, plan_elastic

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
RESUME_ATOL = 1e-4


def test_train_loss_decreases(tmp_path):
    build.reset_launches()
    losses = train.run(arch="llama2-110m", steps=30, batch=4, seq=128,
                       use_reduced=True, ckpt_dir=str(tmp_path),
                       ckpt_every=15, log_every=100, device="cpu")
    assert len(losses) == 30
    assert losses[-1] < losses[0]          # synthetic language is learnable
    assert all(np.isfinite(l) for l in losses)
    assert all(v == 0 for v in build.LAUNCHES.values())   # no kernel entry
    assert store.latest_step(tmp_path) == 30


def test_train_resume_continues(tmp_path):
    recs = []
    train.run(arch="llama2-110m", steps=20, batch=2, seq=64,
              ckpt_dir=str(tmp_path), ckpt_every=10, log_every=100,
              device="cpu")
    l2 = train.run(arch="llama2-110m", steps=30, batch=2, seq=64,
                   ckpt_dir=str(tmp_path), ckpt_every=10, log_every=100,
                   device="cpu", on_step=recs.append)
    # the resumed run starts at step 20 and runs only 10 more
    assert len(l2) == 10 and [r["step"] for r in recs] == list(range(20, 30))


def test_resume_draws_the_uninterrupted_batches(tmp_path):
    """A 15-step run checkpointing at step 10, then a run resumed from that
    checkpoint: steps 10-14 on the uninterrupted run's batches bitwise, and
    its losses to f32 order (here, on the CPU, exactly)."""
    kw = dict(arch="llama2-110m", steps=15, batch=2, seq=64, ckpt_every=10,
              log_every=100, device="cpu", ckpt_dir=str(tmp_path))
    whole, rest = [], []
    train.run(**kw, on_step=whole.append)
    assert store.latest_step(tmp_path) == 10
    train.run(**kw, on_step=rest.append)
    assert [r["step"] for r in rest] == list(range(10, 15))
    for got, want in zip(rest, whole[10:]):
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got["batch"][k], want["batch"][k])
        assert got["loss"] == pytest.approx(want["loss"], abs=RESUME_ATOL)


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """The JAX trainer's step-10 checkpoint, resumed by the port's trainer,
    gives the JAX trainer's losses of steps 10-19."""
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    want = jtrain.run(arch="llama2-110m", steps=20, batch=2, seq=64,
                      ckpt_dir=str(jdir), ckpt_every=10, log_every=100)
    tdir.mkdir()
    shutil.copytree(jdir / "step_00000010", tdir / "step_00000010")
    got = train.run(arch="llama2-110m", steps=20, batch=2, seq=64,
                    ckpt_dir=str(tdir), ckpt_every=10, log_every=100,
                    device="cpu")
    assert len(got) == 10
    np.testing.assert_allclose(got, want[10:], rtol=0, atol=RESUME_ATOL)


def test_grad_compress_changes_no_loss_in_either_package():
    kw = dict(arch="llama2-110m", steps=4, batch=2, seq=64, log_every=100)
    port = [train.run(**kw, grad_compress=c, device="cpu")
            for c in (False, True)]
    assert port[0] == port[1]
    ref = [jtrain.run(**kw, grad_compress=c) for c in (False, True)]
    assert ref[0] == ref[1]


def test_elastic_shrink_and_resume(tmp_path):
    """The reference's test_elastic.py on the port: train 10 steps at
    batch 8, checkpoint, lose host 5, plan a data axis of 4, resume at
    batch 4 from the same checkpoint and keep training."""
    cfg = reduced(get_config("llama2-110m"))
    model = build_model(cfg)
    ocfg = adamw.AdamWConfig(lr_peak=5e-4, warmup_steps=5, decay_steps=60)
    params = model.init(0, device="cpu")
    state = {"params": params, "opt": adamw.init_state(params)}
    step8 = steplib.make_train_step(model, ocfg)
    data = SyntheticTinyStories(DataConfig(vocab_size=cfg.vocab_size,
                                           seq_len=64, batch_size=8))
    it = data.batches()
    for _ in range(10):
        state, m = step8(state, next(it))
    loss_before = float(m["loss"])
    store.save(tmp_path, 10, state, extra={"data_state": data.state()})

    clock = [0.0]
    hb = HeartbeatMonitor(8, timeout_s=30, clock=lambda: clock[0])
    for h in range(8):
        hb.beat(h, 10)
    clock[0] = 60.0
    for h in range(8):
        if h != 5:
            hb.beat(h, 11)
    assert hb.dead_hosts() == {5} and hb.max_step() == 11
    plan = plan_elastic(n_pods=1, hosts_per_pod=8, model_hosts=1,
                        dead=hb.dead_hosts())
    assert plan is not None and plan.new_data_size == 4

    restored, step, extra = store.restore(tmp_path, state, device="cpu")
    assert step == 10
    data2 = SyntheticTinyStories(DataConfig(vocab_size=cfg.vocab_size,
                                            seq_len=64, batch_size=4))
    data2.restore(extra["data_state"])
    it2 = data2.batches()
    losses = []
    for _ in range(10):
        restored, m2 = step8(restored, next(it2))
        losses.append(float(m2["loss"]))
    assert all(np.isfinite(l) for l in losses)
    assert np.mean(losses[-3:]) < loss_before + 0.3


def test_module_entry_point_trains_on_the_cpu_and_needs_a_card_else():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--steps", "3", "--batch", "2", "--seq", "32"],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr
    assert "[train] step     2 loss" in out.stdout
    assert "data" in out.stdout and "final loss" in out.stdout
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train.run(steps=1, batch=1, seq=8)
