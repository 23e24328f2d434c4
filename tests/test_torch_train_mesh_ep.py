"""Expert-parallel training of the MoE family: the port's ``jit_train_step``
against the JAX package's on a host mesh of the same shape, over gloo on
the CPU (``test_torch_train_mesh.py``'s bound, reference and lanes), each
config reduced and in f32.

The experts train on their shards (``transformer._TrainTP.experts``): with
``moe_shard="ep_data"`` (w1 / w3 (E@data, F@model, D), w2 (E@data, D,
F@model)) each rank routes and dispatches its own rows, an all-to-all over
``data`` takes each expert's capacity slots to the rank that holds it,
which computes them on its d_ff slice (*f* / *g* over ``model``), and a
second all-to-all brings the results back; with ``moe_shard="model"``
each ``model`` rank computes its experts on the shared rows (*f* on the
slots and the combine weights) and *g* sums the combine.  The cases:

* qwen3-moe-30b-a3b (8 experts, top 2) at 2 x 2 and 4 x 1 (``ep_data``)
  and at 1 x 2 (``moe_shard="model"``);
* the same at 2 x 2 with its vocab at 8192 and d_ff at 512, so that the
  embedding's moments split over ``data`` under ZeRO-1 and the expert
  banks reach its size threshold (1 << 20 values) without being split
  again, with ``zero=True`` and ``zero=False``;
* llama4-maverick-400b-a17b (a dense layer, then an MoE layer of top 1)
  at 2 x 2.

Each within ``LOSS_BOUND`` / ``PARAM_BOUND`` of JAX after five steps from
one numpy init; every rank's losses equal, each holding
``per_device_bytes`` of its specs; every expert bank and its gradient of
its shard's shape through the step; the collective tally of the step's
gradients with its all-to-alls and no all-gather of a whole bank.  Each planted expert fault
(``_torch_train_worker.EXPERT_FAULTS``) parts from JAX's 2 x 2 run by at
least ``FAULT_FACTOR`` times the bound.  A world of one is
``make_train_step`` bit for bit.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_mesh_worker as lane_mod
import _torch_train_worker as worker
from test_torch_train_mesh import (LANE_DEADLINE_S, LOSS_BOUND, PARAM_BOUND,
                                   divergence, jax_reference, times_bound)
from repro_torch.configs import ShapeCell
from repro_torch.core.tree import items, keystr
from repro_torch.distribution import sharding as sh
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer
from repro_torch.models.model import build_model
from repro_torch.optim import adamw

torch.set_num_threads(2)
FAULT_FACTOR = 10.0
MOE = "qwen3-moe-30b-a3b"
ZERO_OVER = {"vocab_size": 8192, "d_ff": 512}
# name -> (arch, overrides, (data, model), zero)
CASES = {"2x2": (MOE, {}, (2, 2), True),
         "4x1": (MOE, {}, (4, 1), True),
         "model_1x2": (MOE, {"moe_shard": "model"}, (1, 2), True),
         "zero_2x2": (MOE, ZERO_OVER, (2, 2), True),
         "no_zero_2x2": (MOE, ZERO_OVER, (2, 2), False),
         "llama4_2x2": ("llama4-maverick-400b-a17b", {}, (2, 2), True)}
# the axis each case's experts are split over
EXPERT_AXIS = {"2x2": "data", "4x1": "data", "model_1x2": "model",
               "zero_2x2": "data", "no_zero_2x2": "data",
               "llama4_2x2": "data"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_mesh_ep")
    jax_wait = jax_reference([(n, a, o, s, 4, z)
                              for n, (a, o, s, z) in CASES.items()], tmp)
    faults = [(f, *CASES["2x2"], f) for f in worker.EXPERT_FAULTS]
    lanes = [lane_mod.Lane("_torch_train_worker:train", world, tmp, cases=[
        (n, *CASES[n], None) for n in names] + more)
        for world, names, more in (
            (4, ("2x2", "4x1", "zero_2x2", "no_zero_2x2", "llama4_2x2"),
             faults),
            (2, ("model_1x2",), []))]
    port = {}
    for lane in lanes:
        ranks = [o["result"] for o in lane.finish(LANE_DEADLINE_S)]
        for name in ranks[0]:
            port[name] = [r[name] for r in ranks]
    return port, jax_wait()


@pytest.mark.parametrize("name", list(CASES))
def test_five_steps_match_jax_on_the_same_mesh(runs, name):
    arch, over, _, _ = CASES[name]
    dl, dp = divergence(runs[0][name][0], runs[1][name],
                        worker.init_numpy(arch, **over))
    print(f"{name}: loss {dl:.3g}, parameters {dp:.3g} "
          f"({times_bound(dl, dp):.3g} of the bound)")
    assert dl <= LOSS_BOUND and dp <= PARAM_BOUND, (dl, dp)


@pytest.mark.parametrize("name", list(CASES))
def test_every_rank_logs_the_same_losses_and_holds_its_specs(runs, name):
    data, model = CASES[name][2]
    ranks = runs[0][name]
    assert len(ranks) == data * model
    assert runs[0][name][0]["expert_axis"] == EXPERT_AXIS[name]
    for r in ranks:
        assert r["losses"] == ranks[0]["losses"]
        held, reckoned = r["bytes"]
        assert held == reckoned


@pytest.mark.parametrize("name", list(CASES))
def test_expert_banks_and_their_gradients_keep_their_shard(runs, name):
    """On every rank each expert bank (w1, w3, w2), before the steps,
    after them and its step-1 gradient, has its shard's shape, smaller
    than the bank's."""
    for r in runs[0][name]:
        ex = r["experts"]
        assert set(ex["start"]) == set(ex["grad"]) == set(ex["end"])
        assert len(ex["start"]) == 3
        for when in ("start", "grad", "end"):
            for k, (held, want) in ex[when].items():
                assert held == want, (when, k, held, want)
        whole = worker.init_numpy(CASES[name][0], **CASES[name][1])
        flat = {keystr(p): v for p, v in items(whole)}
        for k, (held, _) in ex["start"].items():
            assert np.prod(held) < flat[k].size, k


@pytest.mark.parametrize("name", list(CASES))
def test_tally_has_all_to_alls_and_gathers_no_bank(runs, name):
    """The collective tally of the step-1 gradients on rank 0 (the
    forward, the backward and their reduction): two all-to-alls forward
    and two backward an MoE layer where the experts' axis splits the rows
    (none where they are shared), and no all-gather whose output is as
    large as one layer's expert bank."""
    got = runs[0][name][0]
    cfg = worker.config(CASES[name][0], **CASES[name][1])
    bank = cfg.n_experts * cfg.d_ff * cfg.d_model * 4
    kinds = [k for k, _, _ in got["grad_tally"]]
    moe_layers = cfg.n_layers // cfg.moe_every
    # the forward runs twice under remat: 2 x (2 forward) + 2 backward
    want = 6 * moe_layers if EXPERT_AXIS[name] == "data" else 0
    assert kinds.count("all-to-all") == want
    gathers = [b for k, b, _ in got["grad_tally"] if k == "all-gather"]
    assert all(b < bank for b in gathers), (max(gathers), bank)


def test_zero_one_leaves_the_expert_moments_alone(runs):
    """ZeRO-1 splits the embedding's moments over ``data``; the expert
    banks, split over ``data`` already, keep the parameters' specs."""
    for name, want in (("zero_2x2", ["('embed',)"]), ("no_zero_2x2", [])):
        got = runs[0][name][0]
        assert got["zero_split"] == want, name
    cfg = worker.config(MOE, **ZERO_OVER)
    assert cfg.n_layers * cfg.n_experts * cfg.d_ff * cfg.d_model >= 1 << 20


@pytest.mark.parametrize("fault", list(worker.EXPERT_FAULTS))
def test_planted_expert_fault_exceeds_the_bound(runs, fault):
    dl, dp = divergence(runs[0][fault][0], runs[1]["2x2"],
                        worker.init_numpy(MOE))
    print(f"{fault}: loss {dl:.3g}, parameters {dp:.3g} "
          f"({times_bound(dl, dp):.3g} of the bound)")
    assert times_bound(dl, dp) >= FAULT_FACTOR, (dl, dp)


@pytest.mark.parametrize("arch", [MOE, "llama4-maverick-400b-a17b"])
def test_world_of_one_is_make_train_step_bitwise(arch, monkeypatch):
    """A gloo world of one: every collective skipped, five steps' metrics
    and the whole state bitwise ``make_train_step``'s; the mesh step's
    experts run through ``_TrainTP.experts``, the plain step's through
    ``moe_mlp``'s own expert products."""
    calls = []
    real = transformer._TrainTP.experts

    def spy(self, *a):
        calls[-1] += 1
        return real(self, *a)
    monkeypatch.setattr(transformer._TrainTP, "experts", spy)
    assert not dist.is_initialized()
    mesh = make_host_mesh(device="cpu")
    try:
        cfg = worker.config(arch)
        model = build_model(cfg)
        batches = worker.batches_for(cfg)
        got = []
        for on in (None, mesh):
            calls.append(0)
            params = model.init(0, device="cpu")
            state = {"params": params, "opt": adamw.init_state(params)}
            if on is None:
                step = steps.make_train_step(model, worker.ocfg())
            else:
                step, _, _, (sspecs, bspecs) = steps.jit_train_step(
                    model, on, worker.ocfg(), ShapeCell("t", 32, 4, "train"),
                    microbatches=1)
                state = sh.shard(state, sspecs, on)
            metrics = []
            for bt in batches:
                if on is not None:
                    bt = steps.shard_batch(bt, bspecs, on)
                state, m = step(state, bt)
                metrics.append({k: v.clone() for k, v in m.items()})
            got.append((state, metrics))
    finally:
        dist.destroy_process_group()
    assert calls[0] == 0 and calls[1] > 0, calls
    (s0, m0), (s1, m1) = got
    assert all(torch.equal(a[k], b[k]) for a, b in zip(m0, m1) for k in a)
    for (p, a), (_, b) in zip(items(s0), items(s1)):
        assert torch.equal(a, b), keystr(p)
