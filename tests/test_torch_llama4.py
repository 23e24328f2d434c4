"""llama4-maverick-400b-a17b through the port against the JAX package, on
the CPU.

The JAX package's config: 48 layers in the llama4 interleave (``moe_every``
2: a dense layer, then an MoE layer, in turn), d_model 5120, 40 query heads
over 8 KV heads of 128, d_ff 8192 (the dense MLP and each expert), 128
experts, top 1, vocab 202048, rope theta 5e5, bfloat16 params, compute and
KV cache.  Reduced: 2 layers (one pattern), d_model 128, 4 query heads over
2 KV heads of 32, 8 experts of d_ff 256, top 1, groups of 64 tokens; run
here at 2, 4 and 5 layers (at 5 the reference's ``n_layers // moe_every``
patterns drop the fifth layer, and so does the port), and with 10 query
heads over 2 KV heads (5 a KV head, the full config's grouping).

Here: the config and its reduced form field for field; the parameter tree
(``blocks_dense`` on two leading axes, ``blocks_moe``, no ``w13`` on an
MoE block); the one-shot prefill's logits and both cache banks and a
16-step greedy decode loop (f32, bf16, an int8 cache); a tight capacity
that drops pairs and a prime prompt length (groups of one token); the
init that quantizes as it draws; ``rmsnorm_quant``'s launch plan at K
5120; ``serve.py --arch llama4-maverick-400b-a17b`` on the CPU and
``--full`` refused before any draw.  The engines and ``_merge_slot_cache``:
``tests/test_torch_llama4_engine.py``.  Both packages run the ``dequant``
strategy.

Tolerances.  f32 compute: logits within 1e-5 of their scale (summation
order alone), cache banks within 1e-5 of theirs, equal greedy streams.
bf16: the dense cache's bound of ``tests/test_torch_llama3_dense.py``,
``(2 + 1/2) * layers * u * max |logit|`` over the layers that run; a
stream may part only at a step whose top-2 logit gap is below twice that.
Top 1 routes a token to one expert with gate exactly 1.0: a bf16 rounding
that flips a router near-tie moves the token's whole MLP output; on these
inputs none does, and a parting that is not a logit near-tie fails the
test, to be read, not allowed.
"""

import contextlib
import dataclasses
import functools
from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.core import qlinear as jqlinear
from repro.core.policy import QuantPolicy as JQuantPolicy
from repro.models import build_model as jax_build_model
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax
from repro_torch.core import qlinear as tqlinear
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.quantization import QuantizedTensor, tree_differs
from repro_torch.kernels import build, ops
from repro_torch.launch import serve
from repro_torch.models import layers as TL
from repro_torch.models import transformer
from repro_torch.models.model import build_model

torch.set_num_threads(2)

ARCH = "llama4-maverick-400b-a17b"
U = 2.0 ** -8                     # bfloat16 unit roundoff
DENSE_LAYER_WORTH = 2 + 1 / 2     # tests/test_torch_llama3_dense.py
F32 = dict(compute_dtype="float32", kv_cache_dtype="float32")
Q4 = dict(bits=4, min_size=512)   # launch/serve.py --bits 4
HQ5 = dict(n_heads=10, n_kv_heads=2)


@pytest.fixture
def pinned():
    """Both packages on ``dequant``; no CPU tensor reached a CUDA
    kernel."""
    old_j, old_t = jqlinear.default_strategy(), tqlinear.default_strategy()
    jqlinear.set_default_strategy("dequant")
    tqlinear.set_default_strategy("dequant")
    build.reset_launches()
    yield
    jqlinear.set_default_strategy(old_j)
    tqlinear.set_default_strategy(old_t)
    assert all(v == 0 for v in build.LAUNCHES.values())


def test_config_is_the_reference_config():
    """The port's llama4-maverick-400b-a17b and its reduced form equal the
    JAX package's field for field: 24 patterns of a dense and an MoE
    layer; no paged pool."""
    full = tconfigs.get_config(ARCH)
    assert asdict(full) == asdict(get_config(ARCH))
    assert asdict(tconfigs.reduced(full)) == asdict(reduced(get_config(ARCH)))
    assert (full.family, full.n_layers, full.d_model, full.n_heads,
            full.n_kv_heads, full.hd(), full.d_ff, full.vocab_size,
            full.padded_vocab(), full.n_experts, full.top_k, full.moe_every,
            full.moe_group, full.capacity_factor, full.rope_theta,
            full.param_dtype, full.compute_dtype, full.kv_cache_dtype) == (
        "moe", 48, 5120, 40, 8, 128, 8192, 202048, 202240, 128, 1, 2, 512,
        1.25, 5e5, "bfloat16", "bfloat16", "bfloat16")
    r = tconfigs.reduced(full)
    assert (r.n_layers, r.d_model, r.n_heads, r.n_kv_heads, r.hd(), r.d_ff,
            r.n_experts, r.top_k, r.moe_every, r.moe_group) == (
        2, 128, 4, 2, 32, 256, 8, 1, 2, 64)
    assert transformer._interleave_split(full) == (24, 1)
    assert transformer._interleave_split(r.with_(n_layers=5)) == (2, 1)
    assert not build_model(full).supports_paged_cache


@functools.lru_cache(maxsize=None)
def _jax_params(n_pat, hq5=False, policy_items=None):
    """The reduced config's JAX ``init(PRNGKey(0))`` at ``n_pat`` patterns
    (f32 params, which depend neither on the compute or KV dtype nor on a
    layer past the last pattern) quantized under the policy, and the same
    bridged to the port."""
    cfg = reduced(get_config(ARCH)).with_(n_layers=2 * n_pat,
                                          **(HQ5 if hq5 else {}))
    jm = jax_build_model(cfg)
    policy = None if policy_items is None else JQuantPolicy(
        **dict(policy_items))
    jparams = jm.quantize(jax.jit(jm.init)(jax.random.PRNGKey(0)), policy)
    return jparams, params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")


def bridged(tag, n_layers=2, policy=None, **over):
    """(JAX model, its quantized params, port model, the bridged params)
    at the reduced config under an arch id of its own; the JAX model's
    prefill is jitted."""
    tag = f"{ARCH}-torch-parity-{tag}"
    hq5 = over.get("n_heads") == HQ5["n_heads"]
    jcfg = reduced(get_config(ARCH)).with_(arch_id=tag, n_layers=n_layers,
                                           **over)
    tcfg = tconfigs.reduced(tconfigs.get_config(ARCH)).with_(
        arch_id=tag, n_layers=n_layers, **over)
    jm = jax_build_model(jcfg)
    jm = dataclasses.replace(jm, prefill=jax.jit(jm.prefill,
                                                 static_argnames="max_seq"))
    jparams, tparams = _jax_params(
        n_layers // 2, hq5, None if policy is None else tuple(sorted(
            policy.items())))
    return jm, jparams, build_model(tcfg), tparams


def _shapes(tree, path=""):
    if isinstance(tree, dict):
        return {x for k, v in tree.items() for x in _shapes(v, f"{path}/{k}")}
    t = tree.q if isinstance(tree, QuantizedTensor) else tree
    return {(path, type(tree).__name__, tuple(t.shape), str(t.dtype))}


def test_parameter_tree_is_the_reference_layout():
    """The port's own ``init_quantized`` tree has the bridged JAX tree's
    leaves, kinds, shapes and dtypes at 4 layers: ``blocks_dense`` (2, 1,
    ...) with its dense MLP and every fused operand, ``blocks_moe`` (2,
    ...) with the f32 router, three Q8_0 banks and the fused attention
    operands but no ``w13``."""
    _, _, tm, tp = bridged("tree", n_layers=4)
    own = tm.init_quantized(0, device="cpu")
    assert _shapes(own) == _shapes(tp)
    assert set(tp) == {"embed", "final_norm", "blocks_dense", "blocks_moe"}
    dense, moe = tp["blocks_dense"], tp["blocks_moe"]
    assert tuple(dense["attn"]["wqkv"].q.shape) == (2, 1, 256, 128)
    assert "w13" in dense["mlp"] and "moe" not in dense
    assert tuple(dense["mlp"]["w13"].q.shape) == (2, 1, 512, 128)
    assert moe["moe"]["router"].dtype == torch.float32
    assert tuple(moe["moe"]["router"].shape) == (2, 8, 128)
    for name, shape in (("w1", (2, 8, 256, 128)), ("w3", (2, 8, 256, 128)),
                        ("w2", (2, 8, 128, 256))):
        assert moe["moe"][name].bits == 8
        assert tuple(moe["moe"][name].q.shape) == shape
    assert "w13" not in moe["moe"] and "mlp" not in moe
    assert {"wqkv", "wo_f"} <= set(moe["attn"])


def _ran(cfg) -> int:
    """The layers a forward pass runs: whole patterns only."""
    return cfg.n_layers // cfg.moe_every * cfg.moe_every


def _logit_tol(cfg, want) -> float:
    scale = np.abs(np.asarray(want)).max()
    if cfg.compute_dtype == "float32":
        return 1e-5 * scale
    return DENSE_LAYER_WORTH * _ran(cfg) * U * scale


def _route_tol(cfg, call: int, scale: float) -> float:
    """The bound on a bf16 run's router logits at its ``call``-th MoE
    layer of a forward pass (layer 2 call + 1, after 2 call + 2 residual
    adds; f32 compute: none parts): ``(2 + 1/2) * (2 call + 2) * u`` of
    the router logits' largest magnitude, doubled for a gap between two
    of them.  A decision whose top-2 router gap is below it may flip."""
    n = 2 * (call % (cfg.n_layers // cfg.moe_every)) + 2
    return 2 * DENSE_LAYER_WORTH * n * U * scale


@contextlib.contextmanager
def _recorded(routes):
    """For the duration, each of the port's routing calls appends (its
    router logits' top-2 gap (B, S), their largest magnitude) to
    ``routes``."""
    route = TL.moe_route

    def record(x, router, top_k):
        srt = torch.sort(TL.router_logits(x, router), -1,
                         descending=True).values
        routes.append(((srt[..., 0] - srt[..., 1]).numpy(),
                       float(srt.abs().max())))
        return route(x, router, top_k)
    TL.moe_route = record
    try:
        yield routes
    finally:
        TL.moe_route = route


def _held(cfg, got, want, routes, parted):
    """Each row's logits within the tolerance, or (bf16 only) the row is
    one of ``parted`` or made a routing decision at a router near-tie
    (``_route_tol``) in ``routes`` so far: top 1 moves a flipped token by
    a whole expert's output.  Returns the rows parted so far."""
    tol = _logit_tol(cfg, want)
    diff = np.abs(got.numpy() - np.asarray(want)).max(-1)
    near = set()
    for i, (gap, scale) in enumerate(routes):
        near |= set(np.nonzero(
            (gap < _route_tol(cfg, i, scale)).any(-1))[0].tolist())
    for b in np.nonzero(diff > tol)[0].tolist():
        assert cfg.compute_dtype != "float32" and (b in parted or b in near),\
            (b, diff[b], tol)
        parted = parted | {b}
    return parted


def _bank(leaf) -> np.ndarray:
    a = jnp.asarray(leaf)
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                      else a)


# 5 layers run 4 (two patterns), as 4 do: "l5" stands for both depths
MODELS = {"l2-f32": (2, F32), "l2-bf16": (2, {}),
          "l2-int8": (2, dict(kv_cache_dtype="int8")),
          "l4-bf16": (4, {}), "l5-f32": (5, F32),
          "l5-int8": (5, dict(kv_cache_dtype="int8")),
          "hq5-f32": (2, dict(F32, **HQ5))}


@pytest.mark.parametrize("case", list(MODELS))
def test_model_prefill_cache_and_decode_loop_match_jax(case, pinned):
    """Prefill of 2 x 23 tokens into a 48-position cache, then 16 greedy
    decode steps fed JAX's tokens: the prefill's and every step's logits
    within the tolerance (``_held``: in bf16 a row may part from JAX's
    only after a routing decision at a router near-tie), both cache banks'
    K/V (an int8 bank's dequantized, and its scales) of the rows not
    parted within 1e-5 of their scale in f32, within the logits' bound in
    bf16 (a K/V row is a linear function of its layer's input), one code
    step more for int8 K/V; the banks' shapes the reference's."""
    n_layers, over = MODELS[case]
    jm, jp, tm, tp = bridged(f"model-{case}", n_layers, **over)
    cfg = tm.cfg
    toks = np.random.default_rng(23).integers(4, 500, size=(2, 23))
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_seq=48)
    routes = []
    with _recorded(routes):
        tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                            max_seq=48)
    parted = _held(cfg, tl, jl, routes, set())
    live = [b for b in range(2) if b not in parted]
    n_pat = n_layers // 2
    assert set(tc) == set(jc) == {"lens", "attn_dense", "attn_moe"}
    assert tc["attn_dense"]["k"].shape == (n_pat, 1, 2, 48, cfg.n_kv_heads,
                                           32)
    assert tc["attn_moe"]["k"].shape == (n_pat, 2, 48, cfg.n_kv_heads, 32)
    # the banks of the rows not parted: K/V within the logits' relative
    # bound of their scale; an int8 bank's dequantized K/V within that and
    # one code step more, its scales within the bound
    rel = (1e-5 if cfg.compute_dtype == "float32"
           else DENSE_LAYER_WORTH * _ran(cfg) * U)
    for bank in ("attn_dense", "attn_moe"):
        got = {n: t.float().numpy() for n, t in tc[bank].items()}
        want = {n: _bank(t) for n, t in jc[bank].items()}
        assert {n: g.shape for n, g in got.items()} \
            == {n: w.shape for n, w in want.items()}, bank
        for name, step_rel in (("k", 0.0), ("v", 0.0), ("ks", None),
                               ("vs", None)):
            if name not in want:
                continue
            g, w = got[name], want[name]
            if "ks" in want and name in ("k", "v"):
                g = g * got[name + "s"][..., None]
                w = w * want[name + "s"][..., None]
                step_rel = 1 / 127
            ax = -4 if name in ("k", "v") else -3        # the batch axis
            g, w = g.take(live, ax), w.take(live, ax)
            np.testing.assert_allclose(
                g, w, rtol=0, atol=(rel + (step_rel or 0)) * np.abs(w).max(),
                err_msg=f"{bank}/{name}")
    step = jax.jit(jm.decode_step)
    nxt = np.asarray(jnp.argmax(jl, -1))
    for _ in range(16):
        jl, jc = step(jp, jc, jnp.asarray(nxt))
        with _recorded(routes):
            tl, tc = tm.decode_step(tp, tc, torch.from_numpy(nxt.copy()))
        parted = _held(cfg, tl, jl, routes, parted)
        nxt = np.asarray(jnp.argmax(jl, -1))
    assert tc["lens"].tolist() == [39, 39]
    assert len(parted) < 2


def _dropped(idx, s, group, cap_factor, e, k):
    """(token, choice) pairs past their expert's capacity in the grouped
    dispatch, counted in numpy from the chosen experts (B, S, K)."""
    g_sz = min(group, s)
    while s % g_sz:
        g_sz -= 1
    cap = max(int(cap_factor * g_sz * k / e), 1)
    cap = (cap + 3) & ~3
    n = 0
    for grp in idx.reshape(-1, g_sz * k):
        n += sum(max(0, np.sum(grp == x) - cap) for x in range(e))
    return n


@pytest.mark.parametrize("case", ["cap-0.25-s64", "prime-s67"])
def test_grouped_dispatch_edges_match_jax(case, pinned):
    """The one-shot prefill's grouped dispatch at its edges, f32 compute:
    capacity 0.25 on 64-token prompts (capacity 4 of 8 expected a group:
    pairs are dropped, gate 0) and a prime prompt of 67 tokens (the group
    rule lowers 64 to 1: 67 groups of one token, capacity 4).  Logits
    within 1e-5 of their scale, and the MoE layer's dropped pairs counted
    from the routes JAX chooses on the same input."""
    s, cap = (64, 0.25) if case.startswith("cap") else (67, 1.25)
    jm, jp, tm, tp = bridged(f"dispatch-{case}", capacity_factor=cap, **F32)
    toks = np.random.default_rng(s).integers(4, 500, size=(2, s))
    jl, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_seq=s)
    tl, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, max_seq=s)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(jl)).max())
    # the MoE layer's routes on the hidden state it reads
    routes = []
    route = TL.moe_route

    def record(x, router, top_k):
        out = route(x, router, top_k)
        routes.append(out[1].numpy())
        return out
    TL.moe_route = record
    try:
        tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, max_seq=s)
    finally:
        TL.moe_route = route
    (idx,) = routes
    dropped = _dropped(idx, s, 64, cap, 8, 1)
    assert (dropped > 0) == (cap < 1), dropped


@pytest.mark.parametrize("policy", [None, Q4], ids=["q8_0", "q4_0"])
def test_init_quantized_is_quantize_of_init_bitwise(policy, monkeypatch):
    """``Model.init_quantized`` (each expert bank drawn a pattern at a
    time, every weight quantized by slices as it is drawn) against
    ``Model.quantize(Model.init(seed))`` at 4 layers: the same tree, every
    code and scale equal, the fused operands included; the router f32.
    Slices of 4096 values make every weight several slices."""
    monkeypatch.setattr(transformer, "_INIT_SLICE", 4096)
    m = build_model(tconfigs.reduced(tconfigs.get_config(ARCH)).with_(
        n_layers=4))
    pol = None if policy is None else QuantPolicy(**policy)
    got = m.init_quantized(5, pol, device="cpu")
    assert not tree_differs(got, m.quantize(m.init(5, device="cpu"), pol))
    assert got["blocks_moe"]["moe"]["router"].dtype == torch.float32
    assert "w13" in got["blocks_dense"]["mlp"]
    assert "w13" not in got["blocks_moe"]["moe"]


def test_rmsnorm_quant_plan_at_k5120():
    """At llama4's K 5120 (10 x 512: 1280 float4s) PyTorch's row mean takes
    512 / 256 / 128 / 64 / 32 x threads at M = 1 / 2 / 4 / 8 / 16+ and
    never splits a row across warp-rows; the register kernel's plan holds
    a row in 3 / 6 / 12 / 24 / 40 float4s a thread, the last in rows
    sharing blocks of 256 threads (a prefill's rows, M >= 16).
    ``quantize`` at K 5120 and 8192 (wo_f's and w2's inputs) takes 64
    threads a row, as before the 40-float4 plan existed."""
    k = 5120
    seen = {}
    for m in range(1, 2049):
        width, _ = ops._torch_row_mean_order(m, k)
        assert ops._torch_row_split(m, k) == 1
        threads, _, vecs = ops.rmsnorm_quant_plan(m, k, width)
        assert threads == width and vecs * 4 * width >= k
        seen.setdefault((width, vecs), m)
    assert seen == {(512, 3): 1, (256, 6): 2, (128, 12): 4, (64, 24): 8,
                    (32, 40): 16}
    assert ops.rmsnorm_quant_plan(2048, k, 32) == (32, 8, 40)
    assert (ops.quantize_width(5120), ops.quantize_width(8192)) == (64, 64)


def test_serve_cli_serves_llama4_on_the_cpu(capsys):
    """``serve.py --arch llama4-maverick-400b-a17b --device cpu``: the
    reduced config, quantized as it is drawn, serves every request on the
    dense fallback; its parameters are ``quantize(init(seed))`` bit for
    bit."""
    serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                "--max-new", "4", "--slots", "2", "--max-seq", "64"])
    out = capsys.readouterr().out
    assert f"[serve] {ARCH} (2 layers, d_model 128) on cpu" in out
    assert "[serve] 3/3 requests" in out
    eng, done = serve.run(ARCH, requests=2, max_new=3, slots=2, max_seq=64,
                          seed=1, device="cpu")
    assert not eng.paged and "attn_moe" in eng.cache
    assert len(done) == 2 and all(1 <= len(r.output) <= 3 for r in done)
    m = build_model(tconfigs.reduced(tconfigs.get_config(ARCH)))
    assert not tree_differs(eng.params, m.quantize(
        m.init(1, device="cpu"), QuantPolicy(bits=8, min_size=512)))


def test_full_is_refused_before_any_draw(monkeypatch):
    """``serve.py --arch llama4-maverick-400b-a17b --full``: its 48 layers
    hold ~424 GB of Q8_0 (counted on the meta device), past one card's
    memory; the CLI raises ``NotImplementedError`` naming both before any
    weight is drawn.  Every other config's full tree fits."""
    def no_draw(*args, **kwargs):
        raise AssertionError("a weight was drawn")
    monkeypatch.setattr(transformer, "draw_params", no_draw)
    with pytest.raises(NotImplementedError, match=r"423\.6 GB of Q8_0.*"
                       r"80\.0 GB of one card"):
        serve.main(["--arch", ARCH, "--full", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="GB of float"):
        serve.run(ARCH, use_reduced=False, no_quant=True, device="cpu")
    q8 = QuantPolicy(bits=8, min_size=512)
    assert transformer.init_bytes(tconfigs.get_config(ARCH), q8) / 1e9 \
        == pytest.approx(423.6, abs=0.05)
    for arch in ("command-r-35b", "qwen3-moe-30b-a3b", "qwen2-vl-7b"):
        assert transformer.init_bytes(tconfigs.get_config(arch), q8) \
            < serve.CARD_BYTES
