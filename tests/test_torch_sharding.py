"""The port's sharding rules against the JAX package's, leaf by leaf.

For every config of both registries: ``param_specs`` in train and serve
mode, float and quantized, on the mesh shapes the reference's tests use
((data 16, model 16), (pod 2, data 16, model 16)) and the serving meshes
(data 1, model n) for n = 1, 2, 4; ``cache_specs`` of each decode cell's
dense cache and ``paged_cache_specs`` of a paged pool; ``data_specs`` of
each cell's inputs; ``train_state_specs`` (ZeRO-1) and
``pick_microbatches``; ``shapes_for`` and ``list_configs``; and
``sanitize``'s cases that degrade instead of raising.  A JAX
``PartitionSpec`` is read as the tuple it compares as; the trees are the
JAX package's ``ShapeDtypeStruct`` stand-ins against the port's meta
tensors.  Also ``per_device_bytes`` against the reference's.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from _torch_mesh_worker import held_bytes

from repro.configs import base as jbase
from repro.core.quantization import QuantizedTensor as JQT
from repro.distribution import sharding as jsh
from repro.launch import roofline as jroof
from repro.launch import steps as jsteps
from repro.models import build_model as jbuild
from repro_torch.configs import base as tbase
from repro_torch.core.quantization import QuantizedTensor as TQT
from repro_torch.distribution import sharding as tsh
from repro_torch.launch import roofline as troof
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer
from repro_torch.models.model import build_model as tbuild


class FakeMesh:
    """Duck-typed mesh for spec-rule tests (axis sizes only)."""
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = {"16x16": FakeMesh({"data": 16, "model": 16}),
          "2x16x16": FakeMesh({"pod": 2, "data": 16, "model": 16}),
          **{f"1x{n}": FakeMesh({"data": 1, "model": n}) for n in (1, 2, 4)}}
ARCHS = jbase.list_configs()


def _j(tree):
    """A JAX spec tree as plain tuples (QuantizedTensor specs as
    ("Q", codes' spec, scales' spec))."""
    if isinstance(tree, dict):
        return {k: _j(v) for k, v in tree.items()}
    if isinstance(tree, JQT):
        return ("Q", tuple(tree.q), tuple(tree.scale))
    if isinstance(tree, P):
        return tuple(tree)
    if isinstance(tree, (tuple, list)):
        return tuple(_j(v) for v in tree)
    raise TypeError(type(tree))


def _t(tree):
    """The port's spec tree in the same form."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    if isinstance(tree, TQT):
        return ("Q", tree.q, tree.scale)
    return tree


def _shapes_j(tree):
    if isinstance(tree, dict):
        return {k: _shapes_j(v) for k, v in tree.items()}
    if isinstance(tree, JQT):
        return ("Q", tuple(tree.q.shape), tuple(tree.scale.shape))
    if isinstance(tree, (tuple, list)):
        return tuple(_shapes_j(v) for v in tree)
    return (tuple(tree.shape), np.dtype(tree.dtype).name)


def _shapes_t(tree):
    if isinstance(tree, dict):
        return {k: _shapes_t(v) for k, v in tree.items()}
    if isinstance(tree, TQT):
        return ("Q", tuple(tree.q.shape), tuple(tree.scale.shape))
    if isinstance(tree, (tuple, list)):
        return tuple(_shapes_t(v) for v in tree)
    return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))


_STRUCTS = {}


def structs(arch, quantized):
    """(JAX struct, port struct) of an arch's parameters, held once."""
    key = (arch, quantized)
    if key not in _STRUCTS:
        jm = jbuild(jbase.get_config(arch))
        tm = tbuild(tbase.get_config(arch))
        _STRUCTS[key] = (jsteps.params_struct(jm, quantized=quantized),
                         tsteps.params_struct(tm, quantized=quantized))
    return _STRUCTS[key]


def test_list_configs_and_shapes_for():
    assert tbase.list_configs() == ARCHS
    assert len(ARCHS) == 11
    assert [tuple(vars(c).values()) for c in tbase.LM_SHAPES] == \
        [tuple(vars(c).values()) for c in jbase.LM_SHAPES]
    for arch in ARCHS:
        want = [c.name for c in jbase.shapes_for(jbase.get_config(arch))]
        got = [c.name for c in tbase.shapes_for(tbase.get_config(arch))]
        assert got == want, arch
    assert "long_500k" in [c.name for c in tbase.shapes_for(
        tbase.get_config("zamba2-1.2b"))]
    assert "long_500k" not in [c.name for c in tbase.shapes_for(
        tbase.get_config("glm4-9b"))]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch):
    jcfg, tcfg = jbase.get_config(arch), tbase.get_config(arch)
    for quantized in (False, True):
        js, ts = structs(arch, quantized)
        assert _shapes_t(ts) == _shapes_j(js), (arch, quantized)
        for mode in ("train", "serve"):
            for name, mesh in MESHES.items():
                want = _j(jsh.param_specs(jcfg, js, mesh, mode=mode))
                got = _t(tsh.param_specs(tcfg, ts, mesh, mode=mode))
                assert got == want, (arch, quantized, mode, name)
        # not vacuous: the model axis splits the embedding, and the
        # quantized tree's leaves are compared codes and scales apart
        spec = got["embed"] if not quantized else got["embed"][1]
        assert spec[0] == "model" or tcfg.train_shard == "dp"
        assert ("Q" in str(got)) == quantized


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_data_specs_match_reference(arch):
    jcfg, tcfg = jbase.get_config(arch), tbase.get_config(arch)
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    for jc, tc in zip(jbase.shapes_for(jcfg), tbase.shapes_for(tcfg)):
        jin, tin = jsteps.input_specs(jcfg, jc), tsteps.input_specs(tcfg, tc)
        assert _shapes_t(tin) == _shapes_j(jin), (arch, tc.name)
        for name, mesh in MESHES.items():
            for mode in ("train", "serve"):
                assert (_t(tsh.data_specs(tcfg, tin, mesh, mode=mode))
                        == _j(jsh.data_specs(jcfg, jin, mesh, mode=mode))), \
                    (arch, tc.name, name, mode)
        if tc.kind != "decode":
            continue
        jcs, tcs = jsteps.cache_struct(jm, jc), tsteps.cache_struct(tm, tc)
        assert _shapes_t(tcs) == _shapes_j(jcs), (arch, tc.name)
        for name, mesh in MESHES.items():
            assert (_t(tsh.cache_specs(tcfg, tcs, mesh))
                    == _j(jsh.cache_specs(jcfg, jcs, mesh))), \
                (arch, tc.name, name)
    if not transformer.supports_paged_cache(tcfg):
        return
    for kv in ("bfloat16", "int8"):
        kw = dict(block_size=16, n_blocks=24, max_blocks_per_seq=6)
        jpc = jax.eval_shape(lambda: jbuild(jcfg.with_(
            kv_cache_dtype=kv)).init_paged_cache(4, **kw))
        tpc = transformer.init_paged_cache(tcfg.with_(kv_cache_dtype=kv), 4,
                                           device="meta", **kw)
        assert _shapes_t(tpc) == _shapes_j(jpc), (arch, kv)
        for name, mesh in MESHES.items():
            want = _j(jsh.paged_cache_specs(jcfg, jpc, mesh))
            assert _t(tsh.paged_cache_specs(tcfg, tpc, mesh)) == want
            assert _t(tsh.cache_specs(tcfg, tpc, mesh)) == want
            assert (tsh.pool_model_axis(tcfg, mesh)
                    == jsh.pool_model_axis(jcfg, mesh)), (arch, name)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_specs_and_microbatches_match_reference(arch):
    jcfg, tcfg = jbase.get_config(arch), tbase.get_config(arch)
    js, ts = structs(arch, False)
    for name, mesh in MESHES.items():
        jp = jsh.param_specs(jcfg, js, mesh, mode="train")
        tp = tsh.param_specs(tcfg, ts, mesh, mode="train")
        for zero in (True, False):
            want = jsteps.train_state_specs(jcfg, jp, mesh, js, zero=zero)
            got = tsteps.train_state_specs(tcfg, tp, mesh, ts, zero=zero)
            assert _t(got["params"]) == _j(want["params"])
            for k in ("m", "v"):
                assert _t(got["opt"][k]) == _j(want["opt"][k]), \
                    (arch, name, zero, k)
            assert got["opt"]["step"] == tuple(want["opt"]["step"]) == ()
        for jc, tc in zip(jbase.shapes_for(jcfg), tbase.shapes_for(tcfg)):
            for target in (1, 2, 4):
                assert (tsteps.pick_microbatches(tc, mesh, target, cfg=tcfg)
                        == jsteps.pick_microbatches(jc, mesh, target,
                                                    cfg=jcfg)), \
                    (arch, name, tc.name, target)


@pytest.mark.parametrize("arch", ["llama2-110m", "qwen3-moe-30b-a3b",
                                  "zamba2-1.2b"])
def test_per_device_bytes_matches_reference(arch):
    jcfg, tcfg = jbase.get_config(arch), tbase.get_config(arch)
    for quantized, mode in ((False, "train"), (True, "serve")):
        js, ts = structs(arch, quantized)
        for name, mesh in MESHES.items():
            want = jroof.per_device_bytes(
                js, jsh.param_specs(jcfg, js, mesh, mode=mode), mesh)
            got = troof.per_device_bytes(
                ts, tsh.param_specs(tcfg, ts, mesh, mode=mode), mesh)
            assert got == want, (arch, quantized, name)


MESH2 = FakeMesh({"data": 1, "model": 2})
MESH16 = MESHES["16x16"]
POD = MESHES["2x16x16"]


@pytest.mark.parametrize("spec,shape,mesh", [
    (("model", None), (100, 64), MESH16),
    ((("pod", "data"), None), (64, 8), POD),
    ((("pod", "data"), None), (8, 8), POD),
    ((None, "model"), (8, 3), MESH2),                 # does not divide
    (("model", None, None), (8,), MESH2),             # over-long: cut
    (("model", None, None), (3,), MESH2),
    (("tp", None), (8, 8), MESH2),                    # unknown axis
    ((), (4, 4), MESH2),                              # short: padded
], ids=["nondivisible", "pod-data", "pod-data-small", "degrade",
        "truncate", "truncate-degrade", "unknown-axis", "pad"])
def test_sanitize_degrades_as_the_reference(spec, shape, mesh):
    want = tuple(jsh.sanitize(P(*spec), shape, mesh))
    assert tsh.sanitize(spec, shape, mesh) == want


def test_pool_axis_odd_heads_and_size_one():
    base = tbase.get_config("llama2-110m")
    jbase_cfg = jbase.get_config("llama2-110m")
    for kw in (dict(n_heads=6, n_kv_heads=3), dict(n_kv_heads=4), {}):
        for n in (1, 2, 4):
            mesh = FakeMesh({"data": 1, "model": n})
            assert (tsh.pool_model_axis(base.with_(**kw), mesh)
                    == jsh.pool_model_axis(jbase_cfg.with_(**kw), mesh))
    # odd KV heads on a model-2 axis: every pool buffer replicates
    cfg = base.with_(n_heads=6, n_kv_heads=3, kv_cache_dtype="int8")
    pool = transformer.init_paged_cache(cfg, 4, block_size=2, n_blocks=48,
                                        max_blocks_per_seq=12,
                                        device="meta")
    specs = tsh.paged_cache_specs(cfg, pool, MESH2)
    assert specs["attn"] == {"k": (), "v": (), "ks": (), "vs": ()}
    assert specs["lens"] == specs["page_table"] == ()


def test_shard_then_gather_is_the_tree_on_a_mesh_of_one():
    """On a one-rank mesh nothing splits: ``shard`` keeps every leaf as it
    is (no copy) and ``gather`` needs no collective."""
    from repro_torch.launch.mesh import Mesh
    mesh = Mesh(("data", "model"), {"data": 1, "model": 1},
                {"data": 0, "model": 0}, {"data": None, "model": None},
                None, torch.device("cpu"))
    cfg = tbase.reduced(tbase.get_config("llama2-110m"))
    m = tbuild(cfg)
    params = m.quantize(m.init(0, device="cpu"))
    specs = tsh.param_specs(cfg, params, mesh, mode="serve")
    shards = tsh.shard(params, specs, mesh)
    assert shards["blocks"]["attn"]["wqkv"].q is \
        params["blocks"]["attn"]["wqkv"].q
    whole = tsh.gather_tree(shards, specs, mesh)
    assert whole["embed"].q is params["embed"].q
    assert held_bytes(shards) == troof.per_device_bytes(params, specs, mesh)


def test_shard_ranges_cut_every_rank_its_part():
    """Each rank of a FakeMesh-shaped (pod, data, model) grid keeps its own
    contiguous part, the parts tile the dim in rank order."""
    from repro_torch.launch.mesh import Mesh
    x = torch.arange(2 * 4 * 3 * 8, dtype=torch.float32).reshape(8, 2 * 4 * 3)
    spec = (None, ("pod", "data", "model"))
    parts = []
    for r in range(24):
        coords = dict(zip(("pod", "data", "model"),
                          (r // 12, (r // 3) % 4, r % 3)))
        mesh = Mesh(("pod", "data", "model"),
                    {"pod": 2, "data": 4, "model": 3}, coords,
                    {}, None, torch.device("cpu"))
        parts.append(tsh.shard({"w": x}, {"w": spec}, mesh)["w"])
    assert all(p.shape == (8, 1) for p in parts)
    assert torch.equal(torch.cat(parts, dim=1), x)
