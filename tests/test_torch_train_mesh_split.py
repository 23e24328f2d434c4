"""Training on a mesh: the vlm family's tensor parallelism and the batch
split of the reference, the port's ``jit_train_step`` against the JAX
package's on a host mesh of the same shape, over gloo on the CPU
(``test_torch_train_mesh.py``'s bound, reference and lanes), each config
reduced and in f32:

* qwen2-vl-7b at 1 x 2 and 2 x 2: the dense blocks with M-RoPE, on stub
  patch embeddings, its attention, MLP and vocab split over ``model``
  (``transformer._TrainTP``; before, the family computed replicated on
  leaves gathered whole);
* whisper-small (``train_shard="dp"``) on (pod 2, data 1, model 2) with a
  global batch of 2: the batch splits over (data, model), the axes
  ``data_specs`` picks (``sharding._best_batch_spec``), and is the same on
  both pods, so the gradients and the loss are summed over (data, model)
  alone (before, the step refused a batch that does not split over all
  four ranks).

Each within ``LOSS_BOUND`` / ``PARAM_BOUND`` of JAX after five steps from
one numpy init, every rank's losses equal, each rank holding
``per_device_bytes`` of its specs.
"""

import pytest
import torch

import _torch_mesh_worker as lane_mod
import _torch_train_worker as worker
from test_torch_train_mesh import (LANE_DEADLINE_S, LOSS_BOUND, PARAM_BOUND,
                                   divergence, jax_reference, times_bound)
from repro_torch.configs import ShapeCell
from repro_torch.distribution import sharding as sh
from repro_torch.launch import steps
from repro_torch.models.model import build_model

torch.set_num_threads(2)
VLM = "qwen2-vl-7b"
# name -> (arch, overrides, mesh shape, zero, global batch)
CASES = {"vlm_1x2": (VLM, {}, (1, 2), True, 4),
         "vlm_2x2": (VLM, {}, (2, 2), True, 4),
         "whisper_pod": ("whisper-small", {}, (2, 1, 2), True, 2)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_mesh_split")
    jax_wait = jax_reference([(n, a, o, s, b, z) for n, (a, o, s, z, b)
                              in CASES.items()], tmp)
    lanes = [lane_mod.Lane("_torch_train_worker:train", world, tmp, cases=[
        (n, *CASES[n][:4], None, CASES[n][4]) for n in names])
        for world, names in ((4, ("vlm_2x2", "whisper_pod")),
                             (2, ("vlm_1x2",)))]
    port = {}
    for lane in lanes:
        ranks = [o["result"] for o in lane.finish(LANE_DEADLINE_S)]
        for name in ranks[0]:
            port[name] = [r[name] for r in ranks]
    return port, jax_wait()


@pytest.mark.parametrize("name", list(CASES))
def test_five_steps_match_jax_on_the_same_mesh(runs, name):
    arch, over = CASES[name][:2]
    dl, dp = divergence(runs[0][name][0], runs[1][name],
                        worker.init_numpy(arch, **over))
    print(f"{name}: loss {dl:.3g}, parameters {dp:.3g} "
          f"({times_bound(dl, dp):.3g} of the bound)")
    assert dl <= LOSS_BOUND and dp <= PARAM_BOUND, (dl, dp)


@pytest.mark.parametrize("name", list(CASES))
def test_every_rank_logs_the_same_losses_and_holds_its_specs(runs, name):
    ranks = runs[0][name]
    n = 1
    for size in CASES[name][2]:
        n *= size
    assert len(ranks) == n
    for r in ranks:
        assert r["losses"] == ranks[0]["losses"]
        held, reckoned = r["bytes"]
        assert held == reckoned


@pytest.mark.parametrize("name", ["vlm_1x2", "vlm_2x2"])
def test_vlm_splits_its_attention_mlp_and_vocab(runs, name):
    """Query and KV heads, the MLP and the vocab split over ``model``
    (4 query heads over 2 KV heads at model 2), on leaves held split."""
    got = runs[0][name][0]
    assert got["split_leaves"] > 0
    assert got["layout"] == ("heads", False, True, True)


def test_whisper_batch_splits_over_data_and_model_alone(runs):
    """The batch of 2 splits over (data, model), as the reference's
    ``data_specs`` splits it; ``pod`` holds the same rows twice."""
    got = runs[0]["whisper_pod"][0]
    assert got["batch_axes"] == ("data", "model")
    assert got["split_leaves"] == 0


def test_batch_axes_are_the_batch_spec_s():
    """``train_batch_axes`` is the axes of ``data_specs``' batch spec; the
    ZeRO-1 moments split over those axes alone."""
    class Mesh:
        axis_names = ("pod", "data", "model")
        shape = {"pod": 2, "data": 1, "model": 2}
    cfg = worker.config("whisper-small")
    assert sh.train_batch_axes(cfg, Mesh, 2) == ("data", "model")
    assert sh.train_batch_axes(cfg, Mesh, 4) == ("pod", "data", "model")
    assert sh.train_batch_axes(cfg, Mesh, 3) == ()
    specs = sh.data_specs(cfg, steps.input_specs(
        cfg, ShapeCell("t", 32, 2, "train")), Mesh)
    assert sh.spec_axes(specs["labels"][0]) == ("data", "model")
    model = build_model(cfg.with_(d_model=1024, vocab_size=1024))
    pstruct = steps.params_struct(model)
    pspecs = sh.param_specs(model.cfg, pstruct, Mesh)
    sspecs = steps.train_state_specs(model.cfg, pspecs, Mesh, pstruct,
                                     batch_axes=("data", "model"))
    assert sspecs["opt"]["m"]["embed"] == (("data", "model"), None)
    ref = steps.train_state_specs(model.cfg, pspecs, Mesh, pstruct)
    assert ref["opt"]["m"]["embed"] == (("pod", "data", "model"), None)
