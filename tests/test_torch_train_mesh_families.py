"""Training on a mesh, the other layouts and families: the port's
``jit_train_step`` against the JAX package's on a host mesh of the same
shape (``test_torch_train_mesh.py``'s bound, reference and lanes), over
gloo on the CPU, each config reduced and in f32:

* llama3.2-3b (4 query heads over 2 KV heads) at model 4: the query
  heads split and the KV heads do not, so each rank projects the KV head
  its query head reads from the whole ``wk`` / ``wv``;
* llama2-110m with 6 heads at model 4: neither head count divides the
  axis, so q, k and v split their head dim (the reference's fallback);
* whisper-small (``train_shard="dp"``) at 1 x 2: its leaves whole, the
  batch split over both axes;
* qwen3-moe-30b-a3b (``moe_shard="ep_data"``) at 1 x 2 and at 2 x 2: its
  attention and embedding split over ``model``, its experts' d_ff over
  ``model`` and, at 2 x 2, the experts over ``data``, their capacity slots
  sent to their owners by all-to-alls (``test_torch_train_mesh_ep.py``
  holds the other expert layouts).

Each within ``LOSS_BOUND`` / ``PARAM_BOUND`` of JAX, every rank's losses
equal, and each rank holding ``per_device_bytes`` of its specs.  The
experts' planted faults (``_torch_train_worker.EXPERT_FAULTS``) part from
JAX's 2 x 2 run by at least ``FAULT_FACTOR`` times the bound.
"""

import pytest

import _torch_mesh_worker as lane_mod
from test_torch_train_mesh import (FAULT_FACTOR, LANE_DEADLINE_S,
                                   LOSS_BOUND, PARAM_BOUND, divergence,
                                   jax_reference, times_bound)
import _torch_train_worker as worker

CASES = {"gqa": ("llama3.2-3b", {}, (1, 4)),
         "six_heads": ("llama2-110m", {"n_heads": 6, "n_kv_heads": 6},
                       (1, 4)),
         "whisper": ("whisper-small", {}, (1, 2)),
         "moe": ("qwen3-moe-30b-a3b", {}, (1, 2)),
         "moe_2x2": ("qwen3-moe-30b-a3b", {}, (2, 2))}
# the attention layout each dense case takes: (attention split by, KV
# heads whole, MLP split, vocab split)
LAYOUTS = {"gqa": ("heads", True, True, True),
           "six_heads": ("hd", False, True, True)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_mesh_families")
    jax_wait = jax_reference([(n, *c) for n, c in CASES.items()], tmp)
    faults = [(f, *CASES["moe_2x2"], True, f) for f in worker.EXPERT_FAULTS]
    lanes = [lane_mod.Lane("_torch_train_worker:train", world, tmp, cases=[
        (n, *CASES[n], True, None) for n in names] + more)
        for world, names, more in ((4, ("gqa", "six_heads", "moe_2x2"),
                                    faults),
                                   (2, ("whisper", "moe"), []))]
    port = {}
    for lane in lanes:
        ranks = [o["result"] for o in lane.finish(LANE_DEADLINE_S)]
        for name in ranks[0]:
            port[name] = [r[name] for r in ranks]
    return port, jax_wait()


@pytest.mark.parametrize("name", list(CASES))
def test_five_steps_match_jax_on_the_same_mesh(runs, name):
    arch, over, _ = CASES[name]
    dl, dp = divergence(runs[0][name][0], runs[1][name],
                        worker.init_numpy(arch, **over))
    print(f"{name}: loss {dl:.3g}, parameters {dp:.3g} "
          f"({times_bound(dl, dp):.3g} of the bound)")
    assert dl <= LOSS_BOUND and dp <= PARAM_BOUND, (dl, dp)


@pytest.mark.parametrize("name", list(CASES))
def test_every_rank_logs_the_same_losses_and_holds_its_specs(runs, name):
    shape = CASES[name][2]
    ranks = runs[0][name]
    assert len(ranks) == shape[0] * shape[1]
    for r in ranks:
        assert r["losses"] == ranks[0]["losses"]
        held, reckoned = r["bytes"]
        assert held == reckoned


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_dense_case_takes_its_attention_layout(runs, name):
    assert runs[0][name][0]["layout"] == LAYOUTS[name]


@pytest.mark.parametrize("fault", list(worker.EXPERT_FAULTS))
def test_planted_expert_fault_exceeds_the_bound(runs, fault):
    dl, dp = divergence(runs[0][fault][0], runs[1]["moe_2x2"],
                        worker.init_numpy(CASES["moe_2x2"][0]))
    print(f"{fault}: loss {dl:.3g}, parameters {dp:.3g} "
          f"({times_bound(dl, dp):.3g} of the bound)")
    assert times_bound(dl, dp) >= FAULT_FACTOR, (dl, dp)
