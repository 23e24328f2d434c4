"""The port's ``launch/serve.py`` against the reference CLI, on the CPU.

Same seeded prompts, the same argparse surface and defaults (the port adds
``--device``), a closed batch served at the reference's default sampling
(temperature 1.0, top-p 1.0) on the reduced config, the open loop
(``--open-loop``), and a ``NotImplementedError`` for every flag whose path
is not ported yet.
"""

import argparse
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.launch import serve as jserve
from repro_torch import configs as tconfigs
from repro_torch.core import qlinear
from repro_torch.kernels import build
from repro_torch.launch import serve

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("seed", [0, 3])
def test_make_prompts_match_the_reference(seed):
    want = jserve._make_prompts(np.random.default_rng(seed),
                                reduced(get_config("llama2-110m")), 16)
    got = serve._make_prompts(np.random.default_rng(seed), tconfigs.reduced(
        tconfigs.get_config("llama2-110m")), 16)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_argparse_defaults_match_the_reference(monkeypatch):
    """Every flag of the reference CLI exists in the port with the same
    default."""
    seen = {}
    parse = argparse.ArgumentParser.parse_args

    def grab(self, args=None, namespace=None):
        seen["ns"] = parse(self, [], namespace)
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(SystemExit):
        jserve.main()
    monkeypatch.undo()
    want = vars(seen["ns"])
    got = vars(serve.build_parser().parse_args([]))
    assert {k: got.get(k, "<missing>") for k in want} == want
    assert set(got) - set(want) == {"device"}
    assert got["device"] is None


@pytest.mark.parametrize("flags", [["--mesh", "2"], ["--ckpt-dir", "x"]],
                         ids=lambda f: f[0])
def test_unported_flags_raise(flags, tmp_path):
    """Both flags are ported and raise where the reference raises:
    ``--mesh 2`` in a world of one process is past the devices there
    (``make_serve_mesh``'s ``ValueError``, before any process group is
    started); ``--ckpt-dir`` pointed at a directory holding no checkpoint
    raises rather than serving fresh weights."""
    if flags[0] == "--ckpt-dir":
        with pytest.raises(FileNotFoundError, match="no checkpoint"):
            serve.main(["--ckpt-dir", str(tmp_path / flags[1]), "--device",
                        "cpu", "--requests", "1"])
        return
    with pytest.raises(ValueError, match="mesh model_size=2 needs 1..1"):
        serve.main(flags + ["--device", "cpu", "--requests", "1"])


@pytest.mark.parametrize("kw", [dict(), dict(kv_int8=True, bits=4),
                                dict(arch="llama3.2-3b"),
                                dict(arch="llama3.2-3b", kv_int8=True)],
                         ids=["q8-f32", "q4-int8", "llama3.2-3b-bf16",
                              "llama3.2-3b-int8"])
def test_run_serves_every_request_at_the_default_sampling(kw):
    build.reset_launches()
    before = qlinear.default_strategy()
    eng, done = serve.run(use_reduced=True, requests=6, slots=2, max_seq=96,
                          max_new=12, device="cpu", **kw)
    assert qlinear.default_strategy() == before
    assert len(done) == 6 and all(r.error is None for r in done)
    assert all(r.temperature == 1.0 and r.top_p == 1.0 for r in done)
    assert all(1 <= len(r.output) <= 12 for r in done)
    assert eng.metrics["decode_steps"] > 0
    assert all(v == 0 for v in build.LAUNCHES.values())   # CPU: plain
    again, done2 = serve.run(use_reduced=True, requests=6, slots=2,
                             max_seq=96, max_new=12, device="cpu", **kw)
    assert [r.output for r in done2] == [r.output for r in done]


def test_module_entry_point_runs_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--requests", "3",
         "--slots", "2", "--max-seq", "64", "--max-new", "6", "--device",
         "cpu"], capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr
    assert "[serve] 3/3 requests" in out.stdout
    assert "TTFT p50" in out.stdout


def test_open_loop_serves_every_request_at_a_fixed_rate(capsys):
    """``--open-loop --rate 50``: seeded Poisson arrivals served while
    earlier requests decode; every request completes, the report's
    latencies are charged from true arrival and none is negative, and the
    streams equal the closed batch's (same seeds, same order)."""
    build.reset_launches()
    args = ["--requests", "4", "--slots", "2", "--max-seq", "64",
            "--max-new", "6", "--device", "cpu"]
    serve.main(args + ["--open-loop", "--rate", "50", "--stream"])
    out = capsys.readouterr().out
    assert "[serve] open loop: 4/4 ok (0 failed)" in out
    assert "TTFT p50" in out and "goodput" in out
    assert out.count(" done (ok)") == 4
    assert all(v == 0 for v in build.LAUNCHES.values())   # CPU: plain
    eng, reqs = serve.run(use_reduced=True, requests=4, slots=2, max_seq=64,
                          max_new=6, device="cpu", open_loop=True, rate=50.0)
    assert all(r.error is None and 1 <= len(r.output) <= 6 for r in reqs)
    assert all(r.t_first_token >= r.t_enqueue for r in reqs)
    assert all(rc == 0 for rc in eng.pager.refcount)
