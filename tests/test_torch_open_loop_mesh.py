"""The open loop on a mesh of more than one, over gloo on the CPU.

Each rank of a ``torch.distributed`` mesh runs its own ``AsyncServer`` over
its own ``Engine(mesh=)``, each reading its own clock.  Rank 0's clock
releases the arrivals on every rank (``serving/async_serving.py``: one
broadcast a turn), so the ranks' plans stay equal however their clocks
part (``_torch_open_loop_worker``: simulated clocks of 1 ms a read,
rank 1's jumping ``OFFSET_S`` ahead once the run has started):

* at worlds of 2 and 4 every rank's plan log, streams and arrival stamps
  are bitwise those of the unsharded open loop on rank 0's clock (run in
  a process of its own, as each rank runs in one: a plan's compile count
  is its process's);
* the control: with the release broadcast patched out, the same skew
  parts rank 1's plan from rank 0's, and the engine's per-step check
  (``Engine._agree``) raises ``RuntimeError``;
* ``serve.run(open_loop=True, mesh_size=2)`` on two ranks completes the
  same requests with the same streams as ``mesh_size=0`` here (the
  calibrated arrival rate is rank 0's).
"""

import pytest
import torch

import _torch_mesh_worker as lane_mod
import _torch_open_loop_worker as worker
from repro_torch.launch import serve

torch.set_num_threads(2)
OFFSET_S = 0.02
LANE_DEADLINE_S = 240
CLI_KW = dict(requests=4, max_new=6, max_seq=96, seed=3)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("open_loop_mesh")
    lanes = {world: lane_mod.Lane("_torch_open_loop_worker:open_loop",
                                  world, tmp, offset=OFFSET_S)
             for world in (2, 4)}
    alone = lane_mod.Lane("_torch_open_loop_worker:unsharded", 1, tmp)
    want = alone.finish(LANE_DEADLINE_S)[0]["result"]
    return want, {w: [o["result"] for o in lane.finish(LANE_DEADLINE_S)]
                  for w, lane in lanes.items()}


@pytest.mark.parametrize("world", [2, 4])
def test_every_rank_serves_the_unsharded_open_loop(runs, world):
    want, got = runs
    assert want["completed_ok"] == len(worker.workload())
    assert want["midflight_submits"] > 0
    assert len(got[world]) == world
    for rank in got[world]:
        for key in ("plan_log", "streams", "t_enqueue", "completed_ok"):
            assert rank[key] == want[key], key


@pytest.mark.parametrize("world", [2, 4])
def test_one_release_broadcast_a_turn(runs, world):
    """The unsharded run broadcasts nothing; on the mesh every rank
    tallies the same broadcasts: the engine's plan, one a step, and the
    releases, one a turn."""
    want, got = runs
    assert want["broadcasts"] == 0
    counts = {rank["broadcasts"] for rank in got[world]}
    assert len(counts) == 1 and counts.pop() > len(want["plan_log"])


def test_without_the_release_broadcast_the_plans_part(tmp_path):
    lane = lane_mod.Lane("_torch_open_loop_worker:open_loop", 2, tmp_path,
                         offset=OFFSET_S, share=False)
    with pytest.raises(RuntimeError, match="rank 1 planned step"):
        lane.finish(LANE_DEADLINE_S)


def test_serve_run_open_loop_on_two_ranks(tmp_path):
    lane = lane_mod.Lane("_torch_open_loop_worker:cli", 2, tmp_path,
                         kw=CLI_KW)
    want = worker.cli_result(serve.run(open_loop=True, mesh_size=0,
                                       device="cpu", **CLI_KW)[1])
    got = [o["result"] for o in lane.finish(LANE_DEADLINE_S)]
    assert want["completed"] == CLI_KW["requests"]
    for rank in got:
        assert rank == want
