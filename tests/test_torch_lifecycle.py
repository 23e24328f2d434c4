"""The paper's lifecycle on the port, on the CPU: train, checkpoint,
restore, quantize to Q8_0, serve (``serve.py --ckpt-dir``), export to GGML
blocks, each step held against the JAX package's on the same checkpoint.

The port's trainer writes the checkpoint; both packages' ``serve.py``
restore it (``_load_params``) and quantize it (``QuantPolicy(bits=8,
min_size=512)``) into bitwise the same codes and scales; both serve it at
the CLI's sampling (temperature 1.0, top-p 1.0, keys from the seed, the
noise bitwise the reference's) with one qlinear strategy pinned on both
sides, ``dequant``, where the two packages' logits agree to ~1e-6 (see
test_torch_model.py): the streams are equal.  The port's CLI runs the
``kernel`` strategy itself; here it is pinned to ``dequant`` (on the CPU
``kernel`` is the paper's integer arithmetic, whose requantized codes can
flip at an f32 rounding boundary and part a sampled stream).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import ggml_export as jggml
from repro.configs import get_config, reduced
from repro.core import QuantPolicy as JQuantPolicy
from repro.launch import serve as jserve
from repro.models import build_model as jax_build_model
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax
from repro_torch.checkpoint import ggml_export as tggml
from repro_torch.core import qlinear
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.quantization import tree_differs
from repro_torch.kernels import build
from repro_torch.launch import serve, train
from repro_torch.models.model import build_model

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
SERVE = dict(use_reduced=True, requests=4, slots=2, max_seq=96, max_new=12)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    train.run(arch="llama2-110m", steps=10, batch=2, seq=64,
              ckpt_dir=str(d), ckpt_every=5, log_every=100, device="cpu")
    return d


def _quantized(ckpt):
    """Both packages' served Q8_0 trees from ``ckpt``, the JAX one carried
    into the port's tensors, and the JAX one itself."""
    jcfg = reduced(get_config("llama2-110m"))
    jm = jax_build_model(jcfg)
    jq = jm.quantize(jserve._load_params(jm, jcfg, str(ckpt), 0),
                     JQuantPolicy(bits=8, min_size=512))
    tm = build_model(tconfigs.reduced(tconfigs.get_config("llama2-110m")))
    tq = tm.quantize(serve._load_params(tm, str(ckpt), 0,
                                        torch.device("cpu")),
                     QuantPolicy(bits=8, min_size=512))
    bridged = params_from_jax(jax.tree_util.tree_map(np.asarray, jq),
                              device="cpu")
    return tq, bridged, jq


def test_ckpt_dir_restores_the_latest_step_and_quantizes_bitwise(ckpt):
    tq, bridged, _ = _quantized(ckpt)
    assert tree_differs(tq, bridged) == []


def test_ckpt_dir_serves_the_reference_streams(ckpt, monkeypatch):
    _, jdone = jserve.run(**SERVE, ckpt_dir=str(ckpt))
    pin = qlinear.set_default_strategy
    monkeypatch.setattr(qlinear, "set_default_strategy", lambda s: pin(
        "dequant" if s == "kernel" else s))
    build.reset_launches()
    _, done = serve.run(**SERVE, ckpt_dir=str(ckpt), device="cpu")
    assert all(v == 0 for v in build.LAUNCHES.values())   # CPU: plain
    assert all(r.error is None for r in done)
    assert [r.output for r in done] == [r.output for r in jdone]


def test_ckpt_dir_refuses_a_stale_step(ckpt, monkeypatch):
    """A restore that lands on an older step than the latest on disk fails
    rather than serving old weights."""
    from repro_torch.checkpoint import store
    tm = build_model(tconfigs.reduced(tconfigs.get_config("llama2-110m")))
    real = store.restore
    monkeypatch.setattr(store, "restore", lambda d, like, device=None: real(
        d, like, step=5, device=device))
    with pytest.raises(RuntimeError, match="latest on disk is 10"):
        serve._load_params(tm, str(ckpt), 0, torch.device("cpu"))


def test_ggml_export_of_the_served_tree(ckpt, tmp_path):
    tq, _, jq = _quantized(ckpt)
    tggml.export(str(tmp_path / "port.rpq8"), tq)
    jggml.export(str(tmp_path / "jax.rpq8"), jq)
    assert (tmp_path / "port.rpq8").read_bytes() == \
        (tmp_path / "jax.rpq8").read_bytes()


def test_module_entry_point_serves_a_checkpoint(ckpt):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--ckpt-dir",
         str(ckpt), "--requests", "3", "--slots", "2", "--max-seq", "64",
         "--max-new", "6", "--device", "cpu"], capture_output=True,
        text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr
    assert "[serve] restored checkpoint step 10" in out.stdout
    assert "[serve] 3/3 requests" in out.stdout
