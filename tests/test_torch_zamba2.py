"""zamba2-1.2b through the port against the JAX package, on the CPU.

The JAX package's config: 38 Mamba2 layers, d_model 2048 (d_inner 4096, 64
SSM heads of 64, state 64), and ONE attention + SwiGLU block (32 query
heads over 32 KV heads of 64, rope theta 1e4, d_ff 8192) whose weights are
shared by its six applications, one after every 6th Mamba2 layer; vocab
32000, f32 params, bf16 compute.  Reduced: 5 Mamba2 layers with the shared
block after every 2nd (two applications, one tail layer), d_model 128, 4
heads of 32.

Here: the config field for field; the parameter tree in the reference's
layout (``blocks_main`` on two leading axes, ``blocks_tail``,
``shared_attn`` unstacked with its fused decode operands), each stack
quantized by the policy at its own shape; the model's prefill and decode
logits; the engine on the dense fallback against the JAX engine (f32,
bf16 with a bf16 and an int8 KV cache, Q4_0) and the reference's fault
(``tests/test_torch_mamba2.py`` explains both); ``_merge_slot_cache``
against JAX's on the (2, 2, ...) main stacks at 1 and 3 slots; the init
that quantizes as it draws; the refusals; ``serve.py --arch zamba2-1.2b``
on the CPU.  Tolerances are ``tests/test_torch_mamba2.py``'s, a shared
attention application counted as the dense cache's attention block (2 +
1/2 units).
"""

from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.serving.engine import Engine as JaxEngine
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.quantization import QuantizedTensor, tree_differs
from repro_torch.launch import serve
from repro_torch.models import transformer
from repro_torch.models.model import build_model
from repro_torch.serving.engine import Engine

from test_torch_mamba2 import (F32, Q4, bridged, engines_match,  # noqa: F401
                               jax_init, model_matches_jax, pinned,
                               reference_fault_shows, refusals_match_jax)

torch.set_num_threads(2)

ARCH = "zamba2-1.2b"


def test_config_is_the_reference_config():
    """The port's zamba2-1.2b and its reduced form equal the JAX package's
    field for field: 6 super blocks of 6 Mamba2 layers and the shared
    block, then 2 tail layers."""
    full = tconfigs.get_config(ARCH)
    assert asdict(full) == asdict(get_config(ARCH))
    assert asdict(tconfigs.reduced(full)) == asdict(reduced(get_config(ARCH)))
    d = transformer._ssm_dims(full)
    assert (full.family, full.n_layers, full.d_model, full.n_heads,
            full.n_kv_heads, full.hd(), full.d_ff, full.vocab_size,
            full.attn_every, full.rope_theta, full.compute_dtype,
            full.kv_cache_dtype) == (
        "hybrid", 38, 2048, 32, 32, 64, 8192, 32000, 6, 1e4, "bfloat16",
        "bfloat16")
    assert (d.d_inner, d.n_heads, d.head_dim, d.state) == (4096, 64, 64, 64)
    assert transformer._hybrid_split(full) == (6, 2)
    assert transformer._hybrid_split(tconfigs.reduced(full)) == (2, 1)
    assert not build_model(full).supports_paged_cache


def _shapes(tree, path=""):
    if isinstance(tree, dict):
        return {x for k, v in tree.items() for x in _shapes(v, f"{path}/{k}")}
    t = tree.q if isinstance(tree, QuantizedTensor) else tree
    return {(path, type(tree).__name__, tuple(t.shape), str(t.dtype))}


def test_parameter_tree_is_the_reference_layout():
    """The port's own ``init_quantized`` tree has the bridged JAX tree's
    leaves, kinds, shapes and dtypes: ``blocks_main`` (2, 2, ...),
    ``blocks_tail`` (1, ...) -- whose ``wB`` / ``wC`` (1 x 16 x 128 values)
    stay f32 under the default policy's 4096-value floor, where the main
    stack's are quantized --, the shared block unstacked with ``wqkv``,
    ``wo_f`` and ``w13``."""
    _, _, tm, tp = bridged(ARCH, "tree")
    own = tm.init_quantized(0, device="cpu")
    assert _shapes(own) == _shapes(tp)
    assert isinstance(tp["blocks_main"]["ssm"]["wB"], QuantizedTensor)
    assert tp["blocks_tail"]["ssm"]["wB"].dtype == torch.float32
    assert tuple(tp["blocks_main"]["ssm"]["wz"].q.shape) == (2, 2, 256, 128)
    shared = tp["shared_attn"]
    assert {"wqkv", "wo_f"} <= set(shared["attn"]) and "w13" in shared["mlp"]
    assert tuple(shared["attn"]["wqkv"].q.shape) == (3 * 128, 128)


@pytest.mark.parametrize("over", [F32, {}, dict(kv_cache_dtype="int8")],
                         ids=["f32", "bf16", "int8-kv"])
def test_model_prefill_and_decode_match_jax(over, pinned):
    tm, cache = model_matches_jax(ARCH, over)
    assert set(cache) == {"lens", "ssm_main", "ssm_tail", "attn"}
    assert cache["ssm_main"]["state"].shape == (2, 2, 2, 16, 16, 16)
    assert cache["ssm_tail"]["state"].shape == (1, 2, 16, 16, 16)
    assert cache["attn"]["k"].shape == (2, 2, 32, 4, 32)
    assert cache["attn"]["k"].dtype == (
        torch.int8 if tm.cfg.kv_cache_dtype == "int8"
        else getattr(torch, tm.cfg.compute_dtype))


def test_engine_matches_jax_engine(pinned):
    """As ``tests/test_torch_mamba2.py``'s, f32 compute: equal plan logs;
    greedy streams equal to the JAX engine's at one slot, and to its batch
    where the reference's fault cannot reach.  The bf16, int8 KV and Q4_0
    engines: ``tests/test_torch_zamba2_engine.py``."""
    engines_match(ARCH, "f32")


def test_reference_engine_advances_a_row_prefilled_in_its_step(pinned):
    reference_fault_shows(ARCH)


def test_best_of_n_and_speculation_are_refused_as_by_jax(pinned):
    refusals_match_jax(ARCH)


def _jax_path(keys) -> str:
    return "".join(f"/{getattr(k, 'key', getattr(k, 'idx', k))}"
                   for k in keys)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, tuple):
        for i, t in enumerate(tree):
            yield from _leaves(t, f"{path}/{i}")
    else:
        yield path, tree


def _to_torch(tree):
    """A JAX cache tree (dicts, tuples, arrays) as the port's, value for
    value and dtype for dtype."""
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(map(_to_torch, tree))
    if tree.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(tree.astype(jnp.float32))
                                ).bfloat16()
    return torch.from_numpy(np.array(tree))


@pytest.mark.parametrize("slots", [1, 3])
def test_merge_slot_cache_matches_jax(slots, pinned):
    """JAX's one-prompt prefill cache (float weights: bf16 conv tails, f32
    states, bf16 K/V) merged into slot ``slots - 1`` of a dense cache
    holding random values, by the JAX engine and, carried across, by the
    port's: every leaf equal, cast to the slot cache's dtype, the (2, 2,
    slots, ...) main stacks too; ``lens`` of that slot the prompt's
    length."""
    jm, _, tm, _ = bridged(ARCH, "merge")
    jp = jax_init(ARCH)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    toks = np.random.default_rng(slots).integers(4, 500, size=(1, 11))
    _, jpc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_seq=32)
    tpc = _to_torch(jpc)
    assert tpc["ssm_main"]["conv"][0].dtype == torch.bfloat16
    kw = dict(max_slots=slots, max_seq=32)
    jeng, teng = JaxEngine(jm, jp, **kw), Engine(tm, tp, **kw, device="cpu")
    rng = np.random.default_rng(7)
    start = {}
    for path, leaf in _leaves(teng.cache):
        start[path] = rng.standard_normal(tuple(leaf.shape)).astype(
            np.float32)
        leaf.copy_(torch.from_numpy(start[path]))
    jeng.cache = jax.tree_util.tree_map_with_path(
        lambda keys, leaf: jnp.asarray(start[_jax_path(keys)]).astype(
            leaf.dtype), jeng.cache)
    jeng._merge_slot_cache(slots - 1, jpc, 11)
    teng._merge_slot_cache(slots - 1, tpc, 11)
    got, want = dict(_leaves(teng.cache)), dict(_leaves(jeng.cache))
    assert set(got) == set(want)
    assert want["/ssm_main/conv/0"].shape[:3] == (2, 2, slots)
    for path in want:
        w = np.asarray(jnp.asarray(want[path]).astype(jnp.float32))
        np.testing.assert_array_equal(got[path].float().numpy(), w,
                                      err_msg=path)
        assert str(got[path].dtype).split(".")[-1] == str(want[path].dtype)
    assert int(teng.cache["lens"][slots - 1]) == 11


@pytest.mark.parametrize("policy", [None, Q4], ids=["q8_0", "q4_0"])
def test_init_quantized_is_quantize_of_init_bitwise(policy, monkeypatch):
    """``Model.init_quantized`` against ``Model.quantize(Model.init(seed))``:
    the same tree, every code and scale equal, the shared block's fused
    operands included (slices of 4096 values)."""
    monkeypatch.setattr(transformer, "_INIT_SLICE", 4096)
    m = build_model(tconfigs.reduced(tconfigs.get_config(ARCH)))
    pol = None if policy is None else QuantPolicy(**policy)
    got = m.init_quantized(5, pol, device="cpu")
    assert not tree_differs(got, m.quantize(m.init(5, device="cpu"), pol))
    assert {"wqkv", "wo_f"} <= set(got["shared_attn"]["attn"])


def test_serve_cli_serves_zamba2_on_the_cpu(capsys):
    """``serve.py --arch zamba2-1.2b --device cpu`` (and ``--kv-int8``):
    the reduced config on the dense fallback serves every request; its
    parameters are ``quantize(init(seed))`` bit for bit."""
    serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                "--max-new", "4", "--slots", "2", "--max-seq", "64",
                "--kv-int8"])
    out = capsys.readouterr().out
    assert f"[serve] {ARCH} (5 layers, d_model 128) on cpu" in out
    assert "[serve] 3/3 requests" in out
    eng, done = serve.run(ARCH, requests=2, max_new=3, slots=2, max_seq=64,
                          seed=1, device="cpu")
    assert not eng.paged and eng.cache["attn"]["k"].dtype == torch.bfloat16
    assert len(done) == 2 and all(1 <= len(r.output) <= 3 for r in done)
    m = build_model(tconfigs.reduced(tconfigs.get_config(ARCH)))
    assert not tree_differs(eng.params, m.quantize(
        m.init(1, device="cpu"), QuantPolicy(bits=8, min_size=512)))
