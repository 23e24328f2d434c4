"""The dry run (``launch/dryrun.py``) and its roofline
(``launch/roofline.py``'s ``analytic_bytes`` / ``assemble``) against the
JAX package's.

* ``analytic_bytes`` equals the reference's for the same inputs;
* ``assemble``'s record equals the reference's with the reference's
  constants set to the card's (the port adds two keys);
* one full-size cell through the CLI, llama3.2-3b decode_32k on the
  16 x 16 production mesh of a fake world of 256 ranks, writes a record
  with every key of the reference's; a cell that fails is listed and the
  CLI exits 1;
* whisper-small train_4k on the 2 x 16 x 16 mesh of 512 ranks: its batch
  of 256 splits over (data, model) as the reference's ``data_specs``
  splits it, replicated over ``pod``, where the step once refused it;
* ``argument_bytes`` equals ``per_device_bytes`` of the executor's specs,
  and qwen2-vl-7b's prefill traces on meta (``_torch_dryrun_worker.py``);
* importing the module starts no process group and registers no backend.

Every fake world runs in a subprocess of its own.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.configs.base import get_config as jax_get_config
from repro.launch import roofline as jroof
from repro_torch.configs import get_config
from repro_torch.configs.base import shapes_for
from repro_torch.launch import roofline

ROOT = Path(__file__).resolve().parents[1]

# analyse's and run_cell's keys besides assemble's, in the reference
REFERENCE_EXTRA = {"collective_breakdown", "param_bytes_global",
                   "cache_bytes_global", "microbatches", "memory_analysis",
                   "compile_s", "multi_pod"}


def _env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))


ARCHS = ("llama3.2-3b", "qwen3-moe-30b-a3b", "mamba2-370m", "whisper-small")


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_bytes_are_the_reference_s(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for cell in shapes_for(cfg):
        for n_dev in (256, 512):
            for kw in ({}, {"microbatches": 4, "param_bytes_per_dev": 123.5},
                       {"cache_bytes_global": 10 ** 11}):
                args = (cell, n_dev, 7_000_000_000)
                assert roofline.analytic_bytes(cfg, *args, **kw) == \
                    jroof.analytic_bytes(jcfg, *args, **kw)


def _reference_keys():
    cfg = jax_get_config("llama3.2-3b")
    cell = shapes_for(get_config("llama3.2-3b"))[0]
    rec = jroof.assemble(cfg, cell, 256, 1.0, 1.0, {"total": 1.0}, 1.0, {})
    return set(rec) | REFERENCE_EXTRA


@pytest.mark.parametrize("cell_i", range(3))
def test_assemble_is_the_reference_s_at_the_card_s_constants(
        monkeypatch, cell_i):
    monkeypatch.setattr(jroof, "PEAK_FLOPS_BF16", roofline.PEAK_BF16_FLOPS)
    monkeypatch.setattr(jroof, "HBM_BW", roofline.HBM_BW)
    monkeypatch.setattr(jroof, "ICI_BW", roofline.NVLINK_BW)
    cfg, jcfg = get_config("glm4-9b"), jax_get_config("glm4-9b")
    cell = shapes_for(cfg)[cell_i]
    mem = roofline.analytic_bytes(cfg, cell, 256, 18_000_000_000,
                                  cell.global_batch * 10 ** 9)
    for coll in (0.0, 3e9, 3e12):
        args = (cell, 256, 4.1e16, 3.3e16, mem, coll, {"x": 1.0})
        got = roofline.assemble(cfg, *args, flops_dev_executed=2.5e15)
        want = jroof.assemble(jcfg, *args)
        assert {k: got[k] for k in want} == want
        assert got["flops_dev_executed"] == 2.5e15
        assert got["t_compute_executed_s"] == 2.5e15 / 989e12
        assert "flops_dev_executed" not in roofline.assemble(cfg, *args)


def test_constants_are_the_card_s():
    assert roofline.PEAK_BF16_FLOPS == 989e12
    assert roofline.NVLINK_BW == 450e9
    assert roofline.HBM_BW == 3.35e12
    for tpu in (197e12, 819e9, 50e9):
        assert tpu not in vars(roofline).values()


def test_cli_writes_the_reference_s_record(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "llama3.2-3b", "--shape", "decode_32k", "--out", str(tmp_path)],
        env=_env(), capture_output=True, text=True, timeout=180, cwd=ROOT)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    rec = json.loads((tmp_path / "llama3.2-3b__decode_32k__1pod.json")
                     .read_text())
    assert _reference_keys() <= set(rec)
    assert set(rec["memory_analysis"]) == {"argument_bytes", "output_bytes",
                                           "temp_bytes"}
    assert rec["devices"] == 256 and rec["multi_pod"] is False
    # the serve executors compute replicated over the model axis of 16:
    # a rank executes the global count over the 16 data ranks
    assert rec["flops_dev_executed"] == rec["algo_flops_global"] / 16
    assert rec["collective_breakdown"]["total"] == \
        rec["collective_bytes_dev"] > 0
    assert 0 < rec["memory_analysis"]["argument_bytes"] < 80e9
    assert rec["dominant"] in ("compute", "memory", "collective")


def test_whisper_train_cell_on_two_pods_splits_its_batch(tmp_path):
    """The multi-pod cell the train executor once refused: a global batch
    of 256 over (data, model), one row a rank, the same rows on both
    pods."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "whisper-small", "--shape", "train_4k", "--multi-pod", "multi",
         "--out", str(tmp_path)],
        env=_env(), capture_output=True, text=True, timeout=180, cwd=ROOT)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    rec = json.loads((tmp_path / "whisper-small__train_4k__2pod.json")
                     .read_text())
    assert rec["devices"] == 512 and rec["multi_pod"] is True
    assert rec["microbatches"] == 1
    assert 0 < rec["memory_analysis"]["argument_bytes"] < 80e9
    assert rec["collective_breakdown"]["total"] > 0


def test_cli_lists_a_failed_cell_and_exits_1(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "no-such-arch", "--shape", "decode_32k", "--out", str(tmp_path)],
        env=_env(), capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 1
    assert "1 FAILURES" in out.stdout and "no-such-arch" in out.stdout


def test_argument_bytes_and_qwen2_vl_prefill_on_meta():
    out = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_torch_dryrun_worker.py"),
         "cells"], env=_env(), capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["argument_bytes"] == got["per_device_bytes"] > 0
    assert got["vl_flops"] > 0 and got["vl_dev"] == got["vl_flops"] / 16


def test_importing_the_dry_run_starts_nothing():
    code = ("import os, torch.distributed as dist\n"
            "env = dict(os.environ)\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.flops\n"
            "import repro_torch.launch.collective_cost\n"
            "assert not dist.is_initialized()\n"
            "assert dist.Backend.default_device_backend_map.get('meta') "
            "is None\n"
            "assert dict(os.environ) == env\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-4000:]
