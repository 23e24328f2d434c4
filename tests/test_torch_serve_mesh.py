"""The serve-side executors on a mesh: the port's ``jit_prefill_step``,
``jit_serve_step`` and ``jit_serve_sample_step`` over gloo on the CPU,
against the unsharded port and against the JAX package's wrappers.

The port serves storage-sharded and compute-replicated over ``model``
(``models/transformer.py``'s ``_ServeMesh``): the weights by the serve
specs, the dense cache by ``sharding.cache_specs``, rows over ``data``.
Each mesh is a world of spawned processes (``_torch_serve_worker``, run by
``_torch_mesh_worker.Lane``: one world of 2 ranks for the meshes 1 x 2 and
2 x 1, one of 4 for 2 x 2 and 1 x 4).  The reduced llama2-110m in f32,
with f32 weights and an f32 cache, and with Q8_0 weights and an int8
cache, JAX's seeded weights carried by ``bridge.params_from_jax``; a
prefill cell of 4 x 8 and a decode cell of 4 x 16, four teacher-forced
steps of each decode wrapper:

* each wrapper's logits and cache (gathered whole) and sampled tokens
  (from the same threefry keys) bit for bit the unsharded
  ``make_*_step``'s, on every rank;
* the same cases through the JAX package's wrappers on a host mesh of the
  same shape (``_jax_serve_mesh_ref.py``, a subprocess under
  ``XLA_FLAGS=--xla_force_host_platform_device_count=4``): logits within
  ``LOGIT_BOUND`` (fixed before the first run), greedy and sampled tokens
  equal wherever the top-2 gap exceeds it;
* a GQA variant (4 query heads over 2 KV heads) at 1 x 4, where the KV
  heads do not divide the model axis and the cache splits its positions;
* a batch of 2 on a (pod 2, data 2, model 1) mesh, whose prompts and
  sampled tokens split over ``data`` while the cache's rows do not;
* four planted faults (``_torch_serve_worker.FAULTS``), each failing a
  bitwise check;
* every rank holding ``per_device_bytes`` of its specs.

A world of one (``make_host_mesh`` in this process, a gloo group of one)
is the unsharded steps bit for bit.  ``test_torch_serve_mesh_families.py``
holds the other families and splits.
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
import _torch_serve_worker as worker
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core.quantization import QuantizedTensor as JaxQT
from repro.models.model import build_model as jax_build_model
from repro_torch.bridge import params_from_jax
from repro_torch.configs import ShapeCell
from repro_torch.core import prng
from repro_torch.distribution import sharding as sh
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.model import build_model

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
# the port's logits against JAX's wrappers on the same mesh, f32 compute,
# fixed before the first run: the JAX package's GSPMD splits the serve
# products' d_model contraction over the model axis and sums the parts, so
# the two differ by summation order (the unsharded f32 decode tests hold
# 1e-5), and an int8 cache's codes may part by one at a rounding edge
LOGIT_BOUND = 1e-4
LANE_DEADLINE_S = 240
B, S, MAX_SEQ, STEPS = 4, 8, 16, 4
MESHES = {"1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2), "1x4": (1, 4)}
# (pod, data, model): a batch of 2 divides ``data`` but not ``pod x data``
POD = {"pod_2x2x1": (2, 2, 1)}
# (quantized weights, cache)
KINDS = {"f32": (False, "f32"), "q8_int8": (True, "int8")}
# the planted faults: (case they run on, mesh)
FAULT_CASES = {"kv_heads_rotated": ("f32", "1x2"),
               "noise_local": ("f32", "1x2"),
               "rows_swapped": ("f32", "2x1"),
               "seq_shard_wrong": ("gqa", "1x4")}
GQA = {"n_kv_heads": 2}


def to_numpy(tree):
    """A JAX parameter tree as numpy, each ``QuantizedTensor`` a mapping of
    its fields (the workers import no JAX; the bridge reads either)."""
    if isinstance(tree, JaxQT):
        return {"q": np.asarray(tree.q), "scale": np.asarray(tree.scale),
                "group_size": tree.group_size, "bits": tree.bits,
                "orig_dim": tree.orig_dim}
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def jax_weights(arch, kv, quantized, over, seed=0):
    """The JAX package's seeded weights of the reduced config (f32),
    quantized (Q8_0, the fused decode operands too) where asked."""
    cache = "float32" if kv == "f32" else "int8"
    cfg = jax_reduced(jax_get_config(arch)).with_(
        compute_dtype="float32", param_dtype="float32",
        kv_cache_dtype=cache, **over)
    model = jax_build_model(cfg)
    params = model.init(jax.random.PRNGKey(seed))
    if quantized:
        params = model.quantize(params)
    return to_numpy(params)


def make_case(name, arch, kind, mesh, over=None, b=B, s=S, max_seq=MAX_SEQ,
              fault=None, kv=None, quantized=None):
    q, k = KINDS.get(kind, (False, "f32"))
    q = q if quantized is None else quantized
    k = k if kv is None else kv
    over = over or {}
    return {"name": name, "arch": arch, "kv": k, "quantized": q,
            "over": over, "mesh": {**MESHES, **POD}[mesh], "batch": b,
            "seq": s,
            "max_seq": max_seq, "fault": fault,
            "weights": f"{arch}|{k}|{q}|{sorted(over.items())}"}


def start_lanes(cases, tmp, tag, steps_n=STEPS):
    """The port's lanes (a world of 2 and one of 4) and JAX's subprocesses
    (one for the meshes of each size) on ``cases``; returns a function
    that waits for all four and gives ({name: [each rank's record]},
    {name: JAX's results})."""
    weights, inputs = {}, {}
    for c in cases:
        if c["weights"] not in weights:
            weights[c["weights"]] = jax_weights(c["arch"], c["kv"],
                                                c["quantized"], c["over"])
        cfg = worker.config(c["arch"], c["kv"], **c["over"])
        inputs[c["name"]] = worker.inputs(cfg, c["batch"], c["seq"], steps_n)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    refs, lanes = [], []
    for world in (2, 4):
        mine = [c for c in cases if np.prod(c["mesh"]) == world]
        if not mine:
            continue
        src = tmp / f"jax_{tag}_{world}.pkl"
        dst = tmp / f"jax_{tag}_{world}_out.pkl"
        with open(src, "wb") as f:
            pickle.dump(([c for c in mine if not c["fault"]], weights,
                         inputs), f)
        refs.append((subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "_jax_serve_mesh_ref.py"),
             str(src), str(dst)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True), dst))
        lanes.append(lane_mod.Lane(
            "_torch_serve_worker:serve", world, tmp / f"{tag}_{world}",
            cases=mine, weights=weights, inputs_=inputs))

    def wait():
        by_name, ref = {}, {}
        for lane in lanes:
            ranks = [o["result"] for o in lane.finish(LANE_DEADLINE_S)]
            for name in ranks[0]:
                by_name[name] = [r[name] for r in ranks]
        for proc, dst in refs:
            _, err = proc.communicate(timeout=LANE_DEADLINE_S)
            assert proc.returncode == 0, err[-4000:]
            with open(dst, "rb") as f:
                ref.update(pickle.load(f))
        return by_name, ref
    return wait


CASES = ([make_case(f"{k}_{m}", "llama2-110m", k, m)
          for k in KINDS for m in MESHES]
         + [make_case("gqa_1x4", "llama2-110m", "f32", "1x4", over=GQA),
            make_case("pod_2x2x1", "llama2-110m", "f32", "pod_2x2x1", b=2)]
         + [make_case(f"fault_{f}", "llama2-110m", "f32", m,
                      over=GQA if case == "gqa" else None, fault=f)
            for f, (case, m) in FAULT_CASES.items()])
HELD = [c["name"] for c in CASES if not c["fault"]]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    port, ref = start_lanes(CASES, tmp_path_factory.mktemp("serve_mesh"),
                            "dense")()
    return {"port": port, "jax": ref}


def top2_gap(x):
    """Each row's gap between its largest and second-largest value."""
    part = np.sort(x, axis=-1)
    return part[..., -1] - part[..., -2]


def gumbel(seed, b, v):
    """The noise ``gumbel_argmax`` adds at temperature 1, (B, V)."""
    from repro_torch.serving import sampling_distributed as sd
    idx = torch.arange(b * v, dtype=torch.int64).reshape(b, v)
    return sd._gumbel_at(prng.prng_key(seed), idx).numpy()


def hold_to_jax(got, want, inputs):
    """The port's gathered results against JAX's: logits within the bound,
    greedy and sampled tokens equal where the top-2 gap exceeds it; the
    worst logit difference."""
    worst = float(np.abs(got["prefill_logits"] - want["prefill_logits"])
                  .max())
    for i, (a, w) in enumerate(zip(got["decode_logits"],
                                   want["decode_logits"])):
        worst = max(worst, float(np.abs(a - w).max()))
        clear = top2_gap(w) > LOGIT_BOUND
        assert (a.argmax(-1) == w.argmax(-1))[clear].all(), i
        # the sampled step: argmax of logits + noise, from the same logits
        b, v = w.shape
        pert = w + gumbel(inputs["keys"][i], b, v)
        clear = top2_gap(pert) > LOGIT_BOUND
        assert (got["sample_tokens"][i] == want["sample_tokens"][i])[
            clear].all(), i
    assert worst <= LOGIT_BOUND, worst
    return worst


@pytest.mark.parametrize("name", HELD)
def test_wrappers_bitwise_against_unsharded(runs, name):
    """Logits, caches and sampled tokens of all three wrappers, gathered
    whole on every rank, bit for bit the unsharded steps'."""
    ranks = runs["port"][name]
    assert len(ranks) in (2, 4)
    for r in ranks:
        assert all(r["checks"].values()), r["checks"]


@pytest.mark.parametrize("name", HELD)
def test_wrappers_match_jax_on_the_same_mesh(runs, name):
    case = next(c for c in CASES if c["name"] == name)
    cfg = worker.config(case["arch"], case["kv"], **case["over"])
    inputs = worker.inputs(cfg, case["batch"], case["seq"], STEPS)
    worst = hold_to_jax(runs["port"][name][0]["got"], runs["jax"][name],
                        inputs)
    print(f"{name}: logits within {worst:.3g} of JAX's "
          f"({worst / LOGIT_BOUND:.3g} of the bound)")


@pytest.mark.parametrize("fault", list(FAULT_CASES))
def test_planted_fault_fails_a_bitwise_check(runs, fault):
    ranks = runs["port"][f"fault_{fault}"]
    failed = sorted({k for r in ranks for k, ok in r["checks"].items()
                     if not ok})
    print(f"{fault}: fails {failed}")
    assert failed


@pytest.mark.parametrize("name", HELD)
def test_held_bytes_are_per_device_bytes(runs, name):
    """Each rank holds its weight shards, the prefill's part of the cache
    and the decode cell's part: the bytes ``per_device_bytes`` of the
    specs the wrappers used gives."""
    for r in runs["port"][name]:
        for what, (held, reckoned) in r["bytes"].items():
            assert held == reckoned, (what, held, reckoned)


def test_specs_show_the_splits(runs):
    """The cache specs the wrappers used: KV heads over ``model`` where
    they divide it, positions over ``model`` where they do not (the GQA
    case at 1 x 4), rows over ``data``; the tokens and logits follow."""
    def specs(name):
        return runs["port"][name][0]["specs"]
    assert specs("f32_1x2")["decode_cache"]["/attn/k"] == \
        (None, "data", None, "model", None)
    assert specs("q8_int8_1x4")["decode_cache"]["/attn/ks"] == \
        (None, "data", None, "model")
    assert specs("gqa_1x4")["decode_cache"]["/attn/k"] == \
        (None, "data", "model", None, None)
    for name in ("f32_2x1", "q8_int8_2x2"):
        sp = specs(name)
        assert sp["decode_cache"]["/lens"] == ("data",)
        assert sp["decode_cache"]["/attn/v"][1] == "data"
        assert sp["tokens"] == ("data",) == sp["sample_tokens"]
        assert sp["batch"]["tokens"] == ("data", None)
    assert specs("f32_2x2")["logits"] == ("data", "model")
    assert specs("f32_2x1")["logits"] == ("data", "model")


def test_specs_on_a_multi_pod_mesh(runs):
    """A batch of 2 on (pod 2, data 2, model 1): the cache's rows (and the
    logits and the decode step's tokens) are replicated, as the batch does
    not divide ``pod x data``, while the prompts and the sampled tokens
    split over ``data`` alone (``_best_batch_spec``); the steps move rows
    between the two (``steps._to_rows``)."""
    sp = runs["port"]["pod_2x2x1"][0]["specs"]
    assert sp["decode_cache"]["/lens"] == (None,)
    assert sp["tokens"] == (None,) and sp["logits"] == (None, "model")
    assert sp["sample_tokens"] == ("data",)
    assert sp["batch"]["tokens"] == ("data", None)


# ---------------------------------------------------------------------------
# a world of one, in this process
# ---------------------------------------------------------------------------


@pytest.fixture
def world_of_one():
    assert not dist.is_initialized()
    mesh = make_host_mesh(device="cpu")
    yield mesh
    dist.destroy_process_group()


@pytest.mark.parametrize("kind", list(KINDS))
def test_world_of_one_is_the_unsharded_steps_bitwise(world_of_one, kind):
    """All three wrappers on a gloo world of one: the prefill's logits and
    cache, four decode steps' logits and cache, four sampled steps'
    tokens, bit for bit the unsharded steps' (every collective skipped)."""
    quantized, kv = KINDS[kind]
    cfg = worker.config("llama2-110m", kv)
    model = build_model(cfg)
    params = params_from_jax(jax_weights("llama2-110m", kv, quantized, {}),
                             device="cpu")
    inp = worker.inputs(cfg, B, S, STEPS)
    pcell = ShapeCell("prefill", S, B, "prefill")
    dcell = ShapeCell("decode", MAX_SEQ, B, "decode")
    want, _ = worker._run(model, params, pcell, dcell, inp, None)
    got, info = worker._run(model, params, pcell, dcell, inp, world_of_one,
                            quantized)
    assert worker._equal(got["prefill"][0], want["prefill"][0])
    assert worker._equal(got["prefill"][1], want["prefill"][1])
    for a, w in zip(got["decode"][0], want["decode"][0]):
        assert worker._equal(a, w)
    assert worker._equal(got["decode"][1], want["decode"][1])
    for a, w in zip(got["sample"][0], want["sample"][0]):
        assert worker._equal(a, w)
    assert worker._equal(got["sample"][1], want["sample"][1])
    for what, (held, reckoned) in info["bytes"].items():
        assert held == reckoned, what


def test_wrappers_keep_the_reference_returns(world_of_one):
    """The reference's return arity and order: (step, pstruct,
    batch_struct) for the prefill, (step, pstruct, cstruct, batch_struct)
    for both decode wrappers, the structs meta tensors of the whole
    cell."""
    model = build_model(worker.config("llama2-110m"))
    pre = steps.jit_prefill_step(model, world_of_one,
                                 ShapeCell("p", S, B, "prefill"))
    assert len(pre) == 3 and callable(pre[0])
    assert pre[2]["tokens"].shape == (B, S) and pre[2]["tokens"].is_meta
    for fn in (steps.jit_serve_step, steps.jit_serve_sample_step):
        out = fn(model, world_of_one, ShapeCell("d", MAX_SEQ, B, "decode"))
        assert len(out) == 4 and callable(out[0])
        assert out[2]["attn"]["k"].shape[:3] == (model.cfg.n_layers, B,
                                                MAX_SEQ)
        assert out[3]["tokens"].shape == (B,)


def test_engine_still_refuses_the_dense_cache_on_a_mesh(world_of_one):
    """``Engine(mesh=)`` keeps the reference's refusal of the dense cache:
    only the model-level steps serve it on a mesh."""
    from repro_torch.serving.engine import Engine
    model = build_model(worker.config("llama2-110m"))
    with pytest.raises(ValueError, match="paged cache"):
        Engine(model, model.init(0, device="cpu"), max_slots=2, max_seq=32,
               cache_kind="dense", mesh=world_of_one)


def test_shard_helpers_restrict_and_view():
    """``sharding.restrict`` drops the axes outside those asked for, and
    ``local_view`` is a view of the rank's part."""
    assert sh.restrict((None, ("pod", "data"), "model"), ("model",)) == \
        (None, None, "model")
    assert sh.restrict(("data", None), ("data",)) == ("data", None)

    class Two:
        shape = {"data": 1, "model": 2}
        coords = {"data": 0, "model": 1}
    t = torch.arange(8).reshape(2, 4)
    v = sh.local_view(t, (None, "model"), Two())
    assert v.data_ptr() == t[:, 2:].data_ptr() and v.tolist() == [[2, 3],
                                                                 [6, 7]]
