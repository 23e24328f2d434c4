"""Training on a mesh: the port's ``jit_train_step`` against the JAX
package's, over gloo on the CPU.

The port trains on a (data, model) mesh with Megatron tensor parallelism
over ``model`` and ZeRO-1 data parallelism over ``data``
(``launch/steps.py``, ``models/transformer.py``'s ``_TrainTP``); each
mesh is a world of spawned processes (``_torch_train_worker``, run by
``_torch_mesh_worker.Lane``).  The reduced llama2-110m in f32, its vocab
raised to 8192 so that the tied embedding (8192 x 128, 1 << 20 values)
reaches ZeRO-1's size threshold and its moments really split over
``data``, on meshes of 1 x 2, 2 x 1, 2 x 2 and 1 x 4, from the same seeded
weights and batches as the references:

* the first step's loss within ``LOSS_ATOL`` and every gradient leaf
  within ``GRAD_RTOL`` of the JAX package's unsharded step (the constants
  of ``test_torch_train_loss.py``);
* five steps' losses and the final parameters within ``LOSS_BOUND`` /
  ``PARAM_BOUND`` (fixed before the first run against JAX) of the JAX
  package's own ``jit_train_step`` on a host mesh of the same shape, run
  in a subprocess under ``XLA_FLAGS=--xla_force_host_platform_device_count=4``
  (``_jax_train_mesh_ref.py``);
* four planted faults (``_torch_train_worker.FAULTS``) each past 3x the
  bound;
* every rank's losses equal, and the bytes it holds ``per_device_bytes``
  of ``train_state_specs``.

A world of one (``make_host_mesh`` in this process, a gloo group of one)
is ``make_train_step`` bit for bit.  Checkpoints cross between a mesh of 2
and a world of one bit for bit, a resumed run repeats the uninterrupted
one, and ``train.main`` runs on two ranks (rank 0 prints).
``test_torch_train_mesh_families.py`` holds the other attention layouts
and families.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_mesh_worker as lane_mod
import _torch_train_worker as worker
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models.model import build_model as jax_build_model
from repro_torch.checkpoint import store
from repro_torch.configs import ShapeCell
from repro_torch.core.tree import items, keystr
from repro_torch.distribution import sharding as sh
from repro_torch.launch import steps, train
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.model import build_model
from repro_torch.optim import adamw

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
ARCH, OVER = "llama2-110m", {"vocab_size": 8192}
MESHES = {"1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2), "1x4": (1, 4)}
LOSS_ATOL = 1e-5            # test_torch_train_loss.py
GRAD_RTOL = 1e-4            # test_torch_train_loss.py
# five steps against JAX's jit_train_step on the same mesh, fixed before
# the first run: each loss within LOSS_BOUND, and each parameter leaf's
# distance from JAX's within PARAM_BOUND of the distance JAX's moved it
LOSS_BOUND = 1e-4
PARAM_BOUND = 1e-2
FAULT_FACTOR = 3.0
RESUME_ATOL = 1e-4          # test_torch_trainer.py
LANE_DEADLINE_S = 240


def jax_reference(cases, tmp):
    """Start ``_jax_train_mesh_ref.py`` on ``cases`` (each ``(name, arch,
    overrides, shape[, batch, zero])``: ``shape`` (data, model) or (pod,
    data, model), batches of ``batch`` rows (4 by default), ZeRO-1 on by
    default; the weights and batches ``_torch_train_worker``'s) in a
    subprocess of 4 host devices; returns a function that waits for it and
    gives its results."""
    full = []
    for name, arch, over, shape, *rest in cases:
        batch, zero = (*rest, *(4, True)[len(rest):])
        cfg = worker.config(arch, **over)
        full.append((name, arch, over, shape, worker.init_numpy(arch, **over),
                     worker.batches_for(cfg, batch), zero))
    src, dst = tmp / "jax_cases.pkl", tmp / "jax_out.pkl"
    with open(src, "wb") as f:
        pickle.dump(full, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_jax_train_mesh_ref.py"),
         str(src), str(dst)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)

    def wait():
        _, err = proc.communicate(timeout=LANE_DEADLINE_S)
        assert proc.returncode == 0, err[-4000:]
        with open(dst, "rb") as f:
            return pickle.load(f)
    return wait


def flat(tree):
    return {keystr(p): np.asarray(v) for p, v in items(tree)}


def divergence(got, want, start):
    """(worst loss difference, worst leaf's parameter distance over the
    distance the reference moved it) of a run against a reference run
    from the parameters ``start``."""
    dl = max(abs(a - b) for a, b in zip(got["losses"], want["losses"]))
    g, w, s = flat(got["params"]), flat(want["params"]), flat(start)
    assert set(g) == set(w)
    dp = max(np.linalg.norm(g[k] - w[k]) / np.linalg.norm(w[k] - s[k])
             for k in w)
    return dl, dp


def times_bound(dl, dp) -> float:
    return max(dl / LOSS_BOUND, dp / PARAM_BOUND)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The meshes and the faults over spawned ranks, JAX's meshes in a
    subprocess, the lifecycle lane (checkpoints, resume, the CLI), and
    meanwhile here the JAX package's unsharded first step."""
    tmp = tmp_path_factory.mktemp("train_mesh")
    cases = [(n, ARCH, OVER, shape) for n, shape in MESHES.items()]
    jax_wait = jax_reference(cases, tmp)
    two = lane_mod.Lane("_torch_train_worker:train", 2, tmp, cases=[
        (n, ARCH, OVER, MESHES[n], True, None) for n in ("1x2", "2x1")])
    four = lane_mod.Lane("_torch_train_worker:train", 4, tmp, cases=[
        (n, ARCH, OVER, MESHES[n], True, None) for n in ("2x2", "1x4")] + [
        (f, ARCH, OVER, (2, 2), True, f) for f in worker.FAULTS])
    # the lifecycle lane: a world of one's checkpoint to restore on 1 x 2
    cfg = worker.config("llama2-110m")
    params_np, batches = worker.init_numpy("llama2-110m"), \
        worker.batches_for(cfg)
    whole_dir, mesh_dir = tmp / "whole", tmp / "mesh"
    model = build_model(cfg)
    params = worker.tensors(params_np)
    state = {"params": params, "opt": adamw.init_state(params)}
    step = steps.make_train_step(model, worker.ocfg())
    for bt in batches[:2]:
        state, _ = step(state, bt)
    store.save(whole_dir, 2, state)
    run_kw = dict(arch="llama2-110m", steps=8, batch=4, seq=32,
                  ckpt_dir=str(tmp / "run"), ckpt_every=5, log_every=100)
    argv = ["--device", "cpu", "--steps", "3", "--batch", "2", "--seq",
            "32"]
    life = lane_mod.Lane("_torch_train_worker:lifecycle", 2, tmp,
                         params_np=params_np, batches=batches,
                         whole_dir=str(whole_dir), mesh_dir=str(mesh_dir),
                         run_kw=run_kw, argv=argv)
    # JAX's unsharded first step on the same weights and batch
    jcfg = jax_reduced(jax_get_config(ARCH)).with_(
        compute_dtype="float32", param_dtype="float32", **OVER)
    jm = jax_build_model(jcfg)
    start = worker.init_numpy(ARCH, **OVER)
    b0 = worker.batches_for(worker.config(ARCH, **OVER))[0]
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, b0)))(start)
    unsharded = (float(loss), {jax.tree_util.keystr(p): np.asarray(g)
                               for p, g in jax.tree_util.tree_flatten_with_path(
                                   grads)[0]})
    outs = [o["result"] for o in two.finish(LANE_DEADLINE_S)], \
        [o["result"] for o in four.finish(LANE_DEADLINE_S)]
    by_name = {}
    for ranks in outs:
        for name in ranks[0]:
            by_name[name] = [r[name] for r in ranks]
    return {"port": by_name, "jax": jax_wait(), "unsharded": unsharded,
            "start": start, "life": [o["result"] for o in
                                     life.finish(LANE_DEADLINE_S)],
            "whole_state": state, "mesh_dir": mesh_dir, "run_kw": run_kw,
            "tmp": tmp}


# ---------------------------------------------------------------------------
# a world of one
# ---------------------------------------------------------------------------


@pytest.fixture
def world_of_one():
    """``make_host_mesh`` on the CPU: a gloo world of one started here,
    ended after the test."""
    assert not dist.is_initialized()
    mesh = make_host_mesh(device="cpu")
    yield mesh
    dist.destroy_process_group()


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("zero", [True, False])
def test_world_of_one_is_make_train_step_bitwise(world_of_one, zero,
                                                 microbatches):
    """Five steps from the same weights: the losses, learning rates,
    gradient norms, parameters, moments and step counter bitwise equal."""
    assert world_of_one.size == 1 and dist.get_world_size() == 1
    cfg = worker.config("llama2-110m")
    model = build_model(cfg)
    batches = worker.batches_for(cfg)
    got = []
    for mesh in (None, world_of_one):
        params = model.init(0, device="cpu")
        state = {"params": params, "opt": adamw.init_state(params)}
        if mesh is None:
            step = steps.make_train_step(model, worker.ocfg(), microbatches)
        else:
            step, _, _, (sspecs, bspecs) = steps.jit_train_step(
                model, mesh, worker.ocfg(), ShapeCell("t", 32, 4, "train"),
                zero=zero, microbatches=microbatches)
            state = sh.shard(state, sspecs, mesh)
        metrics = []
        for bt in batches:
            if mesh is not None:
                bt = steps.shard_batch(bt, bspecs, mesh)
            state, m = step(state, bt)
            metrics.append({k: v.clone() for k, v in m.items()})
        got.append((state, metrics))
    (s0, m0), (s1, m1) = got
    assert all(torch.equal(a[k], b[k]) for a, b in zip(m0, m1) for k in a)
    assert [keystr(p) for p, _ in items(s0)] == [keystr(p) for p, _ in
                                                 items(s1)]
    for (p, a), (_, b) in zip(items(s0), items(s1)):
        assert torch.equal(a, b), keystr(p)


def test_pick_microbatches_sets_the_step(world_of_one):
    """``microbatches=0`` takes the reference's ``pick_microbatches``, and
    a batch that does not split over the data ranks is refused."""
    model = build_model(worker.config("llama2-110m"))
    cell = ShapeCell("t", 32, 8, "train")
    assert steps.pick_microbatches(cell, world_of_one) == 4
    steps.jit_train_step(model, world_of_one, worker.ocfg(), cell)
    with pytest.raises(ValueError, match="does not split"):
        steps.jit_train_step(model, world_of_one, worker.ocfg(),
                             ShapeCell("t", 32, 6, "train"), microbatches=4)


def test_a_loss_on_a_mesh_needs_the_batch_axes(world_of_one):
    """The axes a batch splits over come from its spec
    (``sharding.train_batch_axes``): a loss on a mesh called without them
    is refused, never summed over every batch axis."""
    model = build_model(worker.config("llama2-110m"))
    _, _, _, (sspecs, bspecs) = steps.jit_train_step(
        model, world_of_one, worker.ocfg(), ShapeCell("t", 32, 4, "train"))
    params = sh.shard(model.init(0, device="cpu"), sspecs["params"],
                      world_of_one)
    batch = steps.shard_batch(worker.batches_for(model.cfg)[0], bspecs,
                              world_of_one)
    with pytest.raises(ValueError, match="batch spec's axes"):
        model.loss(params, batch, mesh=world_of_one, specs=sspecs["params"])
    with pytest.raises(ValueError, match="batch spec's axes"):
        steps.train_grads(model, params, batch, 1, world_of_one, sspecs)


# ---------------------------------------------------------------------------
# meshes of 2 and 4 against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(MESHES))
def test_first_step_matches_unsharded_jax(runs, name):
    got = runs["port"][name][0]
    want_loss, want = runs["unsharded"]
    assert abs(got["losses"][0] - want_loss) <= LOSS_ATOL
    g = flat(got["grads"])
    assert set(g) == set(want)
    for k, w in want.items():
        err = np.abs(g[k] - w).max()
        assert err <= GRAD_RTOL * np.abs(w).max(), (k, err)


@pytest.mark.parametrize("name", list(MESHES))
def test_five_steps_match_jax_on_the_same_mesh(runs, name):
    dl, dp = divergence(runs["port"][name][0], runs["jax"][name],
                        runs["start"])
    print(f"{name}: loss {dl:.3g}, parameters {dp:.3g} "
          f"({times_bound(dl, dp):.3g} of the bound)")
    assert dl <= LOSS_BOUND and dp <= PARAM_BOUND, (dl, dp)


@pytest.mark.parametrize("name", list(MESHES))
def test_every_rank_logs_the_same_losses(runs, name):
    ranks = runs["port"][name]
    assert len(ranks) == MESHES[name][0] * MESHES[name][1]
    assert all(r["losses"] == ranks[0]["losses"] for r in ranks)


@pytest.mark.parametrize("fault", list(worker.FAULTS))
def test_planted_fault_exceeds_the_bound(runs, fault):
    """Each fault on the 2 x 2 mesh parts from JAX's 2 x 2 run by at least
    ``FAULT_FACTOR`` times the bound."""
    dl, dp = divergence(runs["port"][fault][0], runs["jax"]["2x2"],
                        runs["start"])
    print(f"{fault}: loss {dl:.3g}, parameters {dp:.3g} "
          f"({times_bound(dl, dp):.3g} times the bound)")
    assert times_bound(dl, dp) >= FAULT_FACTOR, (dl, dp)


@pytest.mark.parametrize("name", list(MESHES))
def test_held_bytes_are_per_device_bytes(runs, name):
    """Each rank holds its shards of ``train_state_specs``: the bytes
    ``per_device_bytes`` of the state's specs gives, before and after."""
    for r in runs["port"][name]:
        held, reckoned = r["bytes"]
        assert held == reckoned


@pytest.mark.parametrize("name", list(MESHES))
def test_zero_one_splits_over_data_only(runs, name):
    """ZeRO-1 splits the embedding's moments where the data axis has more
    than one rank, and a step then moves each split leaf by one
    reduce-scatter and one all-gather; the step's collectives a step by
    kind are printed."""
    got = runs["port"][name][0]
    data = MESHES[name][0]
    assert got["zero_split"] == (["('embed',)"] if data > 1 else [])
    c = got["collectives"]
    assert c["reduce_scatter"] == c["all_gather"] == len(got["zero_split"])
    assert c["all_reduce"] > 0 and c["barrier"] == 0
    print(f"{name}: collectives a step {c}")


# ---------------------------------------------------------------------------
# checkpoints, resume, the CLI
# ---------------------------------------------------------------------------


def test_mesh_checkpoint_restores_in_a_world_of_one_bitwise(runs):
    got = runs["life"][0]["ckpt"]
    like = {"params": build_model(worker.config("llama2-110m")).init_meta()}
    like["opt"] = adamw.init_state(like["params"])
    back, at, _ = store.restore(runs["mesh_dir"], like, device="cpu")
    assert at == 3
    want = flat(got["whole"])
    for p, t in items(back):
        assert np.array_equal(t.numpy(), want[keystr(p)]), keystr(p)


def test_world_of_one_checkpoint_restores_on_a_mesh_bitwise(runs):
    for r in runs["life"]:
        ck = r["ckpt"]
        assert ck["restored_step"] == 2 and ck["restored_shards_equal"]
        assert ck["split_leaves"] > 0


def test_resumed_mesh_run_repeats_the_uninterrupted_one(runs):
    """``train.run`` on two ranks, 8 steps with a checkpoint at step 5,
    then again on the same directory: it resumes at 5 and repeats steps
    5-7; a world of one resumed from the mesh's step-5 checkpoint gives
    the same losses."""
    whole, again = runs["life"][0]["runs"]
    assert whole["steps"] == list(range(8))
    assert again["steps"] == [5, 6, 7]
    np.testing.assert_allclose(again["losses"], whole["losses"][5:],
                               rtol=0, atol=RESUME_ATOL)
    assert runs["life"][1]["runs"][0]["losses"] == whole["losses"]
    mine = runs["tmp"] / "resume_one"
    mine.mkdir()
    import shutil
    shutil.copytree(Path(runs["run_kw"]["ckpt_dir"]) / "step_00000005",
                    mine / "step_00000005")
    one = train.run(**{**runs["run_kw"], "ckpt_dir": str(mine)},
                    device="cpu")
    assert not dist.is_initialized()
    np.testing.assert_allclose(one, whole["losses"][5:], rtol=0,
                               atol=RESUME_ATOL)


def test_cli_trains_on_two_ranks_and_rank_0_prints(runs):
    """``train.main(["--device", "cpu", ...])`` on a world of two: rank 0
    prints the mesh and each step, rank 1 nothing; the final loss is a
    world of one's."""
    out0, out1 = (r["stdout"] for r in runs["life"])
    assert "on a model=2 mesh" in out0
    assert "[train] step     2 loss" in out0 and "final loss" in out0
    assert out1 == ""
    want = train.run(steps=3, batch=2, seq=32, log_every=100, device="cpu")
    final = float(out0.split("final loss ")[1].split()[0])
    assert abs(final - want[-1]) <= 1e-4
