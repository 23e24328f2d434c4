"""Tensor-parallel sharded serving of the port, over gloo on the CPU.

The port's counterpart of ``tests/test_sharded_serving.py`` and of the
reference CI's multi-device lane: ``Engine(mesh=make_serve_mesh(n))`` at
n = 1, 2 and 4, each mesh a world of n spawned processes
(``_torch_mesh_worker``), must emit bitwise the token streams of the
port's unsharded engine, greedy and sampled, for f32 weights with an f32
pool and Q8_0 weights with an int8 pool, through prefix-cache warm hits,
fork/COW parallel sampling and preemption-resume, with the same metrics;
the f32 greedy streams equal the JAX engine's on the same weights (the
JAX prefix read on its plain reference, ``REPRO_FUSED_PREFILL=oracle``);
each rank holds the bytes ``per_device_bytes`` of its specs says, and no
rank calls a float reduction.  The scheme (storage-sharded,
compute-replicated; ``transformer._ServeMesh``) moves data only by
all-gathers and the plan's broadcast.
"""

import jax
import numpy as np
import pytest
import torch

import _torch_mesh_worker as worker
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import build_model as jax_build_model
from repro.serving.engine import Engine as JaxEngine
from repro_torch.bridge import params_from_jax
from repro_torch.launch.mesh import Mesh, make_serve_mesh
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.engine import Engine
from repro_torch.serving.faults import ERR_DEADLINE

MESH_SIZES = (1, 2, 4)
KINDS = ("f32", "int8")
LANE_DEADLINE_S = 300


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.numpy()


@pytest.fixture(scope="module")
def lane(tmp_path_factory, monkeypatch_module):
    """Start the four worlds (three meshes and the CLI's), then compute
    the references while they serve: the port's unsharded engine (every
    case, both kinds) and the JAX engine (the f32 greedy cases) on the
    same weights."""
    jcfg = jax_reduced(jax_get_config("llama2-110m")).with_(
        compute_dtype="float32")
    jm = jax_build_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    params_np = _np(params_from_jax(jparams, device="cpu"))
    d = tmp_path_factory.mktemp("serving_lane")
    lanes = {n: worker.Lane("serving", n, d, params_np=params_np)
             for n in MESH_SIZES}
    # the CLI in a world of its own: what its ranks hold is theirs alone
    cli_lane = worker.Lane("cli", 2, d)
    ref = {}
    for kind in (*KINDS, "gqa"):
        model, params = worker.model_for(kind, params_np)
        ref[kind] = {name: worker.case_record(
            *worker.serve(model, params, None, **kw))
            for name, kw in worker.CASES.items()
            if kind != "gqa" or name in worker.GQA_CASES}
    monkeypatch_module.setenv("REPRO_FUSED_PREFILL", "oracle")
    jax_ref = {name: worker.serve(
        jm, jparams, None, engine=JaxEngine, **worker.CASES[name])[0]
        for name in ("greedy", "warm", "preempt")}
    cli_ref = _cli(0)
    outs = {n: lanes[n].finish(LANE_DEADLINE_S) for n in MESH_SIZES}
    clis = [out["result"] for out in cli_lane.finish(LANE_DEADLINE_S)]
    return outs, ref, jax_ref, cli_ref, clis


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


def _cli(mesh_size):
    return worker.cli_job(mesh_size)


def _rank0(lane, n, kind):
    return lane[0][n][0]["result"][kind]


@pytest.mark.parametrize("case", ["greedy", "sampled"])
@pytest.mark.parametrize("n", MESH_SIZES)
@pytest.mark.parametrize("kind", KINDS)
def test_streams_match_unsharded(lane, kind, n, case):
    got, want = _rank0(lane, n, kind)[case], lane[1][kind][case]
    assert got["streams"] == want["streams"]
    # zero leaks: every lease back, the whole pool reclaimable
    assert got["leaks"] == 0 and got["free"] and got["audit_clean"]


@pytest.mark.parametrize("n", MESH_SIZES)
@pytest.mark.parametrize("kind", KINDS)
def test_prefix_cache_warm_hit_sharded(lane, kind, n):
    """A warm resubmission hits the prefix index under a mesh
    (registration hashes host-side tokens) and streams bitwise."""
    got, want = _rank0(lane, n, kind)["warm"], lane[1][kind]["warm"]
    assert got["streams"] == want["streams"]
    assert got["metrics"]["prefix_hits"] > 0
    for k in ("prefix_hits", "prefix_cached_tokens"):
        assert got["metrics"][k] == want["metrics"][k]


@pytest.mark.parametrize("n", MESH_SIZES)
@pytest.mark.parametrize("kind", KINDS)
def test_fork_cow_parallel_sampling_sharded(lane, kind, n):
    """Best-of-3 over fork/COW: the device half of COW copies blocks of
    each rank's own pool slice; the sibling streams are the unsharded
    engine's."""
    got, want = _rank0(lane, n, kind)["fork"], lane[1][kind]["fork"]
    assert got["streams"] == want["streams"]
    assert got["metrics"]["fanouts"] > 0
    assert got["metrics"]["cow_copies"] == want["metrics"]["cow_copies"]


@pytest.mark.parametrize("n", MESH_SIZES)
@pytest.mark.parametrize("kind", KINDS)
def test_preemption_resume_sharded(lane, kind, n):
    """A pool far below demand preempts; the resumed KV is rebuilt through
    the sharded chunk step and the streams still match."""
    got, want = _rank0(lane, n, kind)["preempt"], lane[1][kind]["preempt"]
    assert got["streams"] == want["streams"]
    assert got["metrics"]["preemptions"] > 0, \
        "pool sizing no longer forces preemption; test is vacuous"
    assert got["metrics"]["preemptions"] == want["metrics"]["preemptions"]


@pytest.mark.parametrize("n", MESH_SIZES)
@pytest.mark.parametrize("kind", KINDS)
def test_every_rank_serves_the_unsharded_metrics(lane, kind, n):
    """Every rank: each case's streams and every metric that reads no
    clock (tokens, steps, prefix bytes, the roofline energy) equal to the
    unsharded engine's."""
    for out in lane[0][n]:
        for case, want in lane[1][kind].items():
            got = out["result"][kind][case]
            assert got["streams"] == want["streams"], (out["rank"], case)
            assert got["metrics"] == want["metrics"], (out["rank"], case)


@pytest.mark.parametrize("n", MESH_SIZES)
@pytest.mark.parametrize("kind", KINDS)
def test_one_chunk_shape_per_mesh(lane, kind, n):
    """The chunk step's shape count for this (pool key, mesh shape) grows
    by at most one for a fresh pool key and not at all for a second engine
    on the same one."""
    c0, c1, c2 = _rank0(lane, n, kind)["compiles"]
    assert c1 - c0 <= 1
    assert c2 == c1


@pytest.mark.parametrize("n", MESH_SIZES)
@pytest.mark.parametrize("kind", KINDS)
def test_held_bytes_are_per_device_bytes(lane, kind, n):
    """Each rank holds its specs' share: the weights' serve-mode shards
    (replicated at model size 1) and the pool's KV-head slice (the whole
    pool at size 1)."""
    for out in lane[0][n]:
        b = out["result"][kind]["bytes"]
        assert b["params_held"] == b["params_specs"]
        assert b["pool_held"] == b["pool_specs"] == b["pool_full"] / n


@pytest.mark.parametrize("case", worker.GQA_CASES)
@pytest.mark.parametrize("n", MESH_SIZES)
def test_gqa_streams_match_unsharded(lane, n, case):
    """4 query heads over 2 KV heads: at model size 2 each rank attends
    one KV head and its two query heads; at 4 the KV heads do not divide
    the axis, so every rank holds the whole pool and attends every head
    while the weights stay sharded (``sanitize`` degrades, never raises).
    Every rank streams as the unsharded engine."""
    for out in lane[0][n]:
        got = out["result"]["gqa"]
        assert got["pool_split"] == (n == 2)
        assert got[case]["streams"] == lane[1]["gqa"][case]["streams"]
        assert got[case]["metrics"] == lane[1]["gqa"][case]["metrics"]


@pytest.mark.parametrize("n", MESH_SIZES)
def test_no_float_reduction_on_any_rank(lane, n):
    for out in lane[0][n]:
        assert not any(out["reductions"].values()), out["reductions"]


@pytest.mark.parametrize("case", ["greedy", "warm", "preempt"])
@pytest.mark.parametrize("n", MESH_SIZES)
def test_f32_greedy_streams_match_jax_engine(lane, n, case):
    assert _rank0(lane, n, "f32")[case]["streams"] == lane[2][case]


def test_serve_cli_mesh_two_prints_the_unsharded_streams(lane):
    """``serve.main(["--mesh", "2", ...])`` under two gloo ranks serves
    the requests of ``--mesh 0`` to the same streams; rank 0 prints the
    tensor-parallel line, rank 1 nothing."""
    got, want = lane[4][0], lane[3]
    assert got["streams"] == want["streams"]
    assert "tensor-parallel mesh: model=2 (2 devices" in got["stdout"]
    line = [ln for ln in got["stdout"].splitlines() if "requests," in ln]
    assert line and line[0].split(" in ")[0] in want["stdout"]
    assert lane[4][1]["stdout"] == ""


def test_serve_cli_mesh_two_holds_its_shards_alone(lane):
    """``serve.py --mesh 2`` draws the tree on the host and cuts it there:
    as the engine starts to run, no whole copy of a leaf the specs split
    is alive on either rank, the rank holds its shards' bytes, and those
    are the bytes ``serve.py`` checked against the device before the
    draw, less than the whole tree's."""
    for out in lane[4]:
        m = out["memory"]
        assert m["split_leaves"] > 0
        assert m["whole_alive"] == 0
        assert m["held"] == m["checked"] < m["whole_tree"]


def _one_rank_mesh(n=1, rank=0):
    return Mesh(("data", "model"), {"data": 1, "model": n},
                {"data": 0, "model": rank}, {"data": None, "model": None},
                None, torch.device("cpu"))


def _reduced():
    model, params = worker.model_for(
        "f32", _np(params_from_jax(jax_build_model(jax_reduced(
            jax_get_config("llama2-110m")).with_(
                compute_dtype="float32")).init(jax.random.PRNGKey(0)),
            device="cpu")))
    return model, params


def test_mesh_requires_the_paged_cache():
    model, params = _reduced()
    with pytest.raises(ValueError, match="paged"):
        Engine(model, params, cache_kind="dense", mesh=_one_rank_mesh())


def test_serve_mesh_validates_size():
    """Past the world (one process, no group) or below 1: ``ValueError``
    before any process group is started."""
    import torch.distributed as dist
    for n in (0, 2):
        with pytest.raises(ValueError, match="needs 1..1 devices"):
            make_serve_mesh(n, device="cpu")
    assert not dist.is_initialized()


def _rank_one_engine(monkeypatch, theirs):
    """An engine on rank 1 of a two-rank mesh whose broadcast delivers
    ``theirs(mine)`` as rank 0's (plan, verdicts)."""
    model, params = _reduced()
    eng = Engine(model, params, max_slots=2, max_seq=32, page_size=4,
                 prefill_chunk_tokens=8, mesh=_one_rank_mesh(2, 1))

    def broadcast(box, src, group, device):
        assert src == 0 and box == [None]
        box[0] = theirs()
    monkeypatch.setattr(torch.distributed, "broadcast_object_list",
                        broadcast)
    return eng


def test_a_rank_whose_plan_parts_from_rank_0_raises(monkeypatch):
    """The ranks check their plan against rank 0's every step: a rank that
    parted raises, where it would otherwise wait in a collective."""
    eng = _rank_one_engine(monkeypatch, lambda: (
        (1, {"prefills": [], "decodes": [], "verifies": [],
             "preempted": [], "rejected": [], "cows": [], "cached": [],
             "admitted": []}), []))
    eng.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=2,
               temperature=0.0)
    with pytest.raises(RuntimeError, match="rank 0 planned step 1"):
        eng.step()


def test_rank_0s_deadline_verdicts_bind_every_rank(monkeypatch):
    """Deadlines read the clock: rank 0's verdicts, not this rank's own
    clock, fail a request."""
    plans = []
    real = engine_mod.Engine._agree

    def spy(self, plan, verdicts):
        plans.append((self._step, plan.summary()))
        return real(self, plan, verdicts)
    monkeypatch.setattr(engine_mod.Engine, "_agree", spy)
    eng = _rank_one_engine(
        monkeypatch, lambda: (plans[-1], [(1, "total", 5.0, 12.5)]))
    eng.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=4,
               temperature=0.0, deadline_ms=1e9)
    done = eng.step()
    assert [(r.uid, r.error_kind) for r in done] == [(1, ERR_DEADLINE)]
    assert "5 ms exceeded (12.5 ms since submit)" in done[0].error
    assert eng.metrics["deadline_misses"] == 1


@pytest.mark.parametrize("kvh,hq,d,kind", [
    (12, 1, 64, "f32"), (12, 1, 64, "int8"), (8, 3, 128, "bf16"),
    (8, 3, 128, "int8"), (4, 1, 32, "f32")],
    ids=["llama2-f32", "llama2-int8", "llama3-bf16", "llama3-int8",
         "reduced-f32"])
def test_plain_paged_attentions_are_bitwise_per_head_slice(kvh, hq, d, kind):
    """On the CPU the kernels' plain versions (batched products) give a
    head the same bits whatever other heads share the call: every KV-head
    slice of a mesh of 2 and of 4, each with its own copy of q and the
    pool, against the same heads of one call over every head.  The
    reduced config's 4 KV heads leave one a rank at 4, the case where a
    product of other layouts would take another path."""
    from repro_torch.core.quantization import quantize_rows
    from repro_torch.kernels import ops
    gen = torch.Generator().manual_seed(kvh * d)
    b, bs, mb, c = 3, 8, 4, 6
    nb = b * mb
    k = torch.randn((nb, bs, kvh, d), generator=gen)
    v = torch.randn((nb, bs, kvh, d), generator=gen)
    ks = vs = None
    if kind == "int8":
        (k, ks), (v, vs) = quantize_rows(k), quantize_rows(v)
    elif kind == "bf16":
        k, v = k.bfloat16(), v.bfloat16()
    pt = torch.randperm(nb, generator=gen)[:b * mb].reshape(b, mb).int()
    lens = torch.tensor([1, 13, 32], dtype=torch.int32)
    pfx = torch.tensor([0, 9, 26], dtype=torch.int32)
    qlens = torch.tensor([6, 4, 0], dtype=torch.int32)
    q = torch.randn((b, kvh, hq, d), generator=gen)
    qp = torch.randn((b, c, kvh, hq, d), generator=gen)
    full = ops.paged_decode_attention_kernel(q, k, v, pt, lens, ks, vs)
    fullp = ops.paged_prefill_attention_kernel(qp, k, v, pt, pfx, qlens, ks,
                                               vs)

    def part(t, sl, dim):
        return None if t is None else t.narrow(
            dim, sl.start, sl.stop - sl.start).contiguous()
    for n in (2, 4):
        per = kvh // n
        for r in range(n):
            sl = slice(r * per, (r + 1) * per)
            got = ops.paged_decode_attention_kernel(
                part(q, sl, 1), part(k, sl, 2), part(v, sl, 2), pt, lens,
                part(ks, sl, 2), part(vs, sl, 2))
            assert torch.equal(got, full[:, sl]), (n, r)
            gotp = ops.paged_prefill_attention_kernel(
                part(qp, sl, 2), part(k, sl, 2), part(v, sl, 2), pt, pfx,
                qlens, part(ks, sl, 2), part(vs, sl, 2))
            for a, w in zip(gotp, fullp):
                assert torch.equal(a, w[:, :, sl]), (n, r)
