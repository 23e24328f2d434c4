"""The collective tally (``distribution/collectives.tally``) and its
pricing (``launch/collective_cost.py``).

* the ring factors are the reference's ``hlo_cost._wire_bytes`` over a
  grid of (kind, bytes, group size); that module imports no JAX;
* the executors' tally on a real gloo mesh equals a dry run's on meta
  tensors in a fake world of the same mesh, by kind, bytes and calls,
  exactly: ``jit_serve_step``, ``jit_prefill_step`` and ``jit_train_step``
  of the reduced llama2-110m at 1 x 2 and 2 x 2 (real ranks spawned by
  ``_torch_mesh_worker.Lane``, the fake world in a subprocess of its own,
  ``_torch_dryrun_worker.py``).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import _torch_mesh_worker as lane_mod
from repro.launch import hlo_cost
from repro_torch.distribution import collectives as C
from repro_torch.launch import collective_cost

ROOT = Path(__file__).resolve().parents[1]
MESHES = ((1, 2), (2, 2))
DEADLINE_S = 150


@pytest.mark.parametrize("kind", ["all-reduce", "all-gather",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute"])
def test_ring_factors_are_the_reference_s(kind):
    for nbytes in (0, 1, 4096, 3 * 1000003):
        for g in (1, 2, 3, 4, 8, 16, 256):
            assert collective_cost.wire_bytes(kind, nbytes, g) == \
                hlo_cost._wire_bytes(kind, nbytes, g), (nbytes, g)


def test_port_only_kinds_and_totals():
    calls = [("all-reduce", 100, 4), ("all-gather", 64, 2),
             ("broadcast", 30, 3), ("barrier", 0, 5), ("all-reduce", 8, 1)]
    got = collective_cost.collective_wire_bytes(calls)
    assert got == {"all-reduce": 150.0, "all-gather": 32.0,
                   "broadcast": 20.0, "barrier": 0.0, "total": 202.0}
    assert collective_cost.summarize(calls)["all-reduce"] == \
        {"calls": 2, "bytes": 108}
    with pytest.raises(ValueError, match="unknown"):
        collective_cost.wire_bytes("scatter", 1, 2)


def test_tally_records_only_inside_and_skips_groups_of_one():
    import torch
    C.record("all-reduce", 4, 2)                # no tally open: dropped
    with C.tally() as outer:
        with C.tally() as inner:
            C.record("all-gather", 8, 2)
        x = torch.ones(3)
        assert C.all_reduce(x, None, 1) is x    # a group of one: no call
        assert C.gather_from(x, 0, None, 4, 0) is x
    assert inner == [("all-gather", 8, 2)] and outer == inner
    assert not C.tallying()


@pytest.fixture(scope="module")
def tallies(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tally")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    fakes = {m: subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_dryrun_worker.py"),
         "fake", str(m[0]), str(m[1])], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for m in MESHES}
    lanes = {m: lane_mod.Lane("_torch_dryrun_worker:tally", m[0] * m[1],
                              tmp / f"{m[0]}x{m[1]}", data=m[0], model=m[1])
             for m in MESHES}
    out = {}
    for m in MESHES:
        ranks = [o["result"] for o in lanes[m].finish(DEADLINE_S)]
        stdout, err = fakes[m].communicate(timeout=DEADLINE_S)
        assert fakes[m].returncode == 0, err[-4000:]
        out[m] = (ranks, json.loads(stdout.strip().splitlines()[-1]))
    return out


@pytest.mark.parametrize("kind", ["decode", "prefill", "train"])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_real_tally_equals_the_dry_run_s(tallies, mesh, kind):
    ranks, fake = tallies[mesh]
    assert ranks[0][kind] == fake[kind]
    assert fake[kind], "a mesh of more than one rank calls collectives"
    # every rank calls the same collectives (rank 0 stands for each)
    assert all(r[kind] == ranks[0][kind] for r in ranks)
