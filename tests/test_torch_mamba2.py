"""mamba2-370m through the port against the JAX package, on the CPU.

The JAX package's config: 48 Mamba2 layers, d_model 1024 (d_inner 2048, 32
SSM heads of 64, one group, state 128, conv width 4), no attention, vocab
50280, f32 params and bf16 compute.  Reduced: 2 layers, d_model 128 (16
SSM heads of 16, state 16), chunks of 32.

Here: the config field for field; ``ssd_chunked``, ``ssd_recurrent_ref``
and ``mamba2_forward`` against JAX's at 1 and 2 B/C groups (heads repeated
over groups element-wise, ``jnp.repeat``), at a prime length (chunk 1: one
token a chunk), a length under the conv width and with a carried state;
the decode step continuing a prefill; the reduced model's prefill and
decode logits; the engine (the dense per-slot cache, which the SSM family
falls back to) against the JAX engine, f32, bf16 and Q4_0; the init that
quantizes as it draws; the refusals of best-of-n and speculation;
``serve.py --arch mamba2-370m`` on the CPU.  Both packages run the
``dequant`` strategy.

The engines.  The batched decode step advances every slot row.  The JAX
engine lets it advance a row prefilled in the same step, so the SSM state
of every prompt admitted while another decodes takes one extra padding
token (``test_reference_engine_advances_a_row_prefilled_in_its_step``).
The port keeps such a row's state.  So its streams are held to the JAX
engine's for each prompt served alone, and to the JAX engine's batch where
the fault cannot reach (a prompt admitted in a step with no decode);
``plan_log`` equals the batch's.

Tolerances.  f32: the scan parts from JAX's only by f32 summation order,
1e-5 of the output's largest magnitude (the token-by-token recurrence
against the chunked scan, 1e-4, as ``tests/test_models.py``); the engines'
greedy streams equal.  bf16: logits within ``worth * n_units * u * max
|logit|`` (u = 2^-8; 2 units an SSM layer: its input norm and its output
each round to bf16, everything between is f32), a stream parting only at a
step whose top-2 gap is below twice that.
"""

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
from repro.models import ssm as JS
from repro.serving.engine import Engine as JaxEngine
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax
from repro_torch.core import qlinear as tqlinear
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.quantization import QuantizedTensor, tree_differs
from repro_torch.kernels import build
from repro_torch.launch import serve
from repro_torch.models import ssm as TS
from repro_torch.models import transformer
from repro_torch.models.model import build_model
from repro_torch.serving.engine import Engine

torch.set_num_threads(2)

ARCH = "mamba2-370m"
U = 2.0 ** -8                     # bfloat16 unit roundoff
F32 = dict(compute_dtype="float32")
Q4 = dict(bits=4, min_size=512)   # launch/serve.py --bits 4
ENGINE = dict(max_slots=2, max_seq=64, prefill_chunk_tokens=16)

# the JAX package's functions, jitted (eager, each op compiles alone)
J_SSD = jax.jit(JS.ssd_chunked, static_argnames="chunk")
J_REC = jax.jit(JS.ssd_recurrent_ref)
J_FWD = jax.jit(JS.mamba2_forward, static_argnums=(2, 3))
J_DEC = jax.jit(JS.mamba2_decode_step, static_argnums=(2,))


@pytest.fixture
def pinned():
    """Both packages on ``dequant``; no CPU tensor reached a CUDA kernel."""
    old_j, old_t = jqlinear.default_strategy(), tqlinear.default_strategy()
    jqlinear.set_default_strategy("dequant")
    tqlinear.set_default_strategy("dequant")
    build.reset_launches()
    yield
    jqlinear.set_default_strategy(old_j)
    tqlinear.set_default_strategy(old_t)
    assert all(v == 0 for v in build.LAUNCHES.values())


def test_config_is_the_reference_config():
    """The port's mamba2-370m and its reduced form equal the JAX package's
    field for field."""
    full = tconfigs.get_config(ARCH)
    assert asdict(full) == asdict(get_config(ARCH))
    assert asdict(tconfigs.reduced(full)) == asdict(reduced(get_config(ARCH)))
    d = transformer._ssm_dims(full)
    assert (full.family, full.n_layers, full.d_model, full.n_heads,
            full.vocab_size, full.padded_vocab(), full.rope_type,
            full.param_dtype, full.compute_dtype, full.tie_embeddings) == (
        "ssm", 48, 1024, 0, 50280, 50432, "none", "float32", "bfloat16",
        True)
    assert (d.d_inner, d.n_heads, d.head_dim, d.n_groups, d.state,
            d.conv_width) == (2048, 32, 64, 1, 128, 4)
    assert not build_model(full).supports_paged_cache


# ---------------------------------------------------------------------------
# the scan and the block against JAX's
# ---------------------------------------------------------------------------


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, rel=1e-5):
    """Within ``rel`` of the reference's largest magnitude."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=rel * np.abs(want).max(),
                               rtol=0)


def _scan_inputs(seed, b, s, h, p, g, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(np.linspace(0.0, 1.0, h)).astype(np.float32)
    bb = rng.standard_normal((b, s, g, n)).astype(np.float32) * 0.3
    cc = rng.standard_normal((b, s, g, n)).astype(np.float32) * 0.3
    return x, dt, a, bb, cc


SCANS = {"s96-chunk32": (96, 32), "s97-prime": (97, 32),
         "s2-one-chunk": (2, 32), "s64-whole": (64, 128)}


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("case", list(SCANS))
def test_ssd_chunked_matches_jax(case, groups):
    """``ssd_chunked`` on the same numpy inputs as JAX's, 8 heads of 8 over
    ``groups`` groups of state 16: y and the final state within 1e-5.  A
    prime length (97) takes the reference's chunk of 1, 97 chunks; both
    scans also hold the token-by-token recurrence within 1e-4, and the
    port's recurrence holds JAX's within 1e-5."""
    s, chunk = SCANS[case]
    assert TS.chunk_len(s, chunk) == (1 if case == "s97-prime" else
                                      min(s, chunk))
    args = _scan_inputs(s + groups, 2, s, 8, 8, groups, 16)
    jy, js = J_SSD(*map(jnp.asarray, args), chunk=chunk)
    ty, ts = TS.ssd_chunked(*map(torch.from_numpy, args), chunk=chunk)
    _close(ty, jy)
    _close(ts, js)
    jry, jrs = J_REC(*map(jnp.asarray, args))
    try_, trs = TS.ssd_recurrent_ref(*map(torch.from_numpy, args))
    _close(try_, jry)
    _close(trs, jrs)
    _close(ty, try_, 1e-4)
    _close(ts, trs, 1e-4)


def test_groups_repeat_heads_element_wise():
    """At 2 groups of 4 heads each, head i reads group i // 4
    (``jnp.repeat``), not i % 2 (``Tensor.repeat``): the port's result
    moves when group 1's B is zeroed only for heads 4-7."""
    x, dt, a, bb, cc = _scan_inputs(3, 1, 16, 8, 4, 2, 8)
    bb[:, :, 1] = 0.0
    y, _ = TS.ssd_chunked(*map(torch.from_numpy, (x, dt, a, bb, cc)),
                          chunk=8)
    assert torch.all(y[:, :, 4:] == 0) and torch.all(y[:, :, :4] != 0)
    jy, _ = J_SSD(*map(jnp.asarray, (x, dt, a, bb, cc)), chunk=8)
    _close(y, jy)


def _block(groups, seed=0):
    """JAX's f32 Mamba2 block (d_model 64, 16 heads of 8, state 16, conv 4)
    and the same weights bridged."""
    dims = JS.make_ssm_dims(64, 16, 2, 8, groups, 4)
    jp = JS.init_mamba2_params(jax.random.PRNGKey(seed), dims)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    tdims = TS.make_ssm_dims(64, 16, 2, 8, groups, 4)
    assert tuple(tdims) == tuple(dims)
    return dims, jp, tdims, tp


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("s", [40, 37, 2], ids=["s40", "s37-prime",
                                               "s2-under-conv"])
def test_mamba2_forward_matches_jax(s, groups, pinned):
    """``mamba2_forward`` (chunk 16) on the same input as JAX's: the output,
    the three conv tails and the final state within 1e-5.  37 is prime
    (chunk 1); 2 tokens are fewer than the conv's 3-token tail, which then
    keeps zeros in front."""
    dims, jp, tdims, tp = _block(groups)
    x = np.random.default_rng(s).standard_normal((2, s, 64)).astype(
        np.float32) * 0.5
    jy, (jconv, jst) = J_FWD(jp, jnp.asarray(x), dims, 16)
    ty, (tconv, tst) = TS.mamba2_forward(tp, torch.from_numpy(x), tdims,
                                         chunk=16)
    _close(ty, jy)
    _close(tst, jst)
    for a, b in zip(tconv, jconv):
        _close(a, b)
    if s < 3:
        assert torch.all(tconv[0][:, : 3 - s] == 0)


@pytest.mark.parametrize("groups", [1, 2])
def test_carried_state_branch_matches_jax(groups, pinned):
    """A prefill continuing from carried conv rings and state (the
    reference's carried-state branch): against JAX's within 1e-5, and
    against one prefill of the whole sequence within 1e-4."""
    dims, jp, tdims, tp = _block(groups, seed=1)
    x = np.random.default_rng(9).standard_normal((2, 48, 64)).astype(
        np.float32) * 0.5
    _, (jc, js) = J_FWD(jp, jnp.asarray(x[:, :29]), dims, 16)
    _, (tc, ts) = TS.mamba2_forward(tp, torch.from_numpy(x[:, :29]), tdims,
                                    16)
    jy, (jc2, js2) = J_FWD(jp, jnp.asarray(x[:, 29:]), dims, 16, jc, js)
    ty, (tc2, ts2) = TS.mamba2_forward(tp, torch.from_numpy(x[:, 29:]),
                                       tdims, 16, conv_state=tc,
                                       ssm_state=ts)
    _close(ty, jy)
    _close(ts2, js2)
    for a, b in zip(tc2, jc2):
        _close(a, b)
    whole, (_, ws) = TS.mamba2_forward(tp, torch.from_numpy(x), tdims, 16)
    _close(ty, whole[:, 29:], 1e-4)
    _close(ts2, ws, 1e-4)


@pytest.mark.parametrize("groups", [1, 2])
def test_decode_step_continues_a_prefill(groups, pinned):
    """As ``tests/test_models.py`` holds the JAX block: a decode step after
    a 32-token prefill gives the 33-token prefill's last output (1e-4),
    and JAX's decode step on JAX's prefill state (1e-5); the conv rings
    shift by one token."""
    dims, jp, tdims, tp = _block(groups)
    x = np.random.default_rng(5).standard_normal((2, 33, 64)).astype(
        np.float32) * 0.5
    y_all, _ = TS.mamba2_forward(tp, torch.from_numpy(x), tdims, chunk=16)
    _, (cs, hs) = TS.mamba2_forward(tp, torch.from_numpy(x[:, :32]), tdims,
                                    chunk=16)
    y_dec, (cs2, hs2) = TS.mamba2_decode_step(tp, torch.from_numpy(x[:, 32]),
                                              tdims, cs, hs)
    _close(y_dec, y_all[:, 32], 1e-4)
    _, (jcs, jhs) = J_FWD(jp, jnp.asarray(x[:, :32]), dims, 16)
    jy, (jcs2, jhs2) = J_DEC(jp, jnp.asarray(x[:, 32]), dims, jcs, jhs)
    _close(y_dec, jy)
    _close(hs2, jhs2)
    for a, b, old in zip(cs2, jcs2, cs):
        _close(a, b)
        assert torch.equal(a[:, :-1], old[:, 1:])


def test_softplus_is_logaddexp():
    """``ssm.softplus`` is ``jax.nn.softplus`` (``logaddexp(x, 0)``) from
    -40 to 40, across PyTorch's threshold of 20 where its own softplus
    returns x, within two f32 ulps (the two libraries' ``exp`` and
    ``log1p``)."""
    x = np.linspace(-40, 40, 1601, dtype=np.float32)
    got = TS.softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.softplus(x)),
                               rtol=2 ** -22, atol=0)


# ---------------------------------------------------------------------------
# the model and the engine
# ---------------------------------------------------------------------------


def units(cfg) -> float:
    """Rounding units of the bf16 logits' bound, ``u * max |logit|`` each:
    2 an SSM layer; a shared attention application as the dense cache's
    attention block, 2 + 1/2 (``tests/test_torch_llama3_dense.py``)."""
    if cfg.family == "hybrid":
        n_super = cfg.n_layers // cfg.attn_every
        return 2 * cfg.n_layers + 2.5 * n_super
    return 2 * cfg.n_layers


@functools.lru_cache(maxsize=None)
def jax_init(arch):
    """The reduced config's JAX ``init(PRNGKey(0))``, jitted: f32 params,
    which do not depend on the compute or KV dtype."""
    jm = jax_build_model(reduced(get_config(arch)))
    return jax.jit(jm.init)(jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _jax_params(arch, policy_items=None):
    """``jax_init(arch)`` quantized under the policy, and the same bridged
    to the port."""
    jm = jax_build_model(reduced(get_config(arch)))
    policy = None if policy_items is None else JQuantPolicy(
        **dict(policy_items))
    jparams = jm.quantize(jax_init(arch), policy)
    return jparams, params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")


def bridged(arch, tag, policy=None, **over):
    """(JAX model, its quantized params, port model, the bridged params)
    at the reduced config under an arch id of its own.  The JAX model's
    one-shot prefill is jitted, as its engine jits the decode step (eager,
    each of its ops compiles alone)."""
    tag = f"{arch}-torch-parity-{tag}"
    jcfg = reduced(get_config(arch)).with_(arch_id=tag, **over)
    tcfg = tconfigs.reduced(tconfigs.get_config(arch)).with_(arch_id=tag,
                                                            **over)
    jm = jax_build_model(jcfg)
    jm = dataclasses.replace(jm, prefill=jax.jit(jm.prefill,
                                                 static_argnames="max_seq"))
    jparams, tparams = _jax_params(
        arch, None if policy is None else tuple(sorted(policy.items())))
    return jm, jparams, build_model(tcfg), tparams


def model_matches_jax(arch, over):
    """Prefill logits of 2 x 23 tokens and the next decode step's against
    JAX's: within 1e-5 of their scale with f32 compute, within
    ``units * u * scale`` in bf16; the decode cache's leaves as JAX's."""
    jm, jp, tm, tp = bridged(arch, "model", **over)
    toks = np.random.default_rng(23).integers(4, 500, size=(2, 23))
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_seq=32)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, max_seq=32)
    nxt = np.asarray(jnp.argmax(jl, -1))
    jd, _ = jax.jit(jm.decode_step)(jp, jc, jnp.asarray(nxt))
    td, tc2 = tm.decode_step(tp, tc, torch.from_numpy(nxt.copy()))
    assert tc2 is not tc and tc2["lens"].tolist() == [24, 24]
    for got, want in ((tl, jl), (td, jd)):
        scale = np.abs(np.asarray(want)).max()
        f32 = tm.cfg.compute_dtype == "float32"
        tol = (1e-5 if f32 else units(tm.cfg) * U) * scale
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                                   rtol=0)
    return tm, tc2


@pytest.mark.parametrize("over", [F32, {}], ids=["f32", "bf16"])
def test_model_prefill_and_decode_match_jax(over, pinned):
    tm, cache = model_matches_jax(ARCH, over)
    assert set(cache) == {"lens", "ssm"}
    assert cache["ssm"]["state"].shape == (2, 2, 16, 16, 16)
    assert all(c.dtype == torch.float32 and c.shape[:3] == (2, 2, 3)
               for c in cache["ssm"]["conv"])


def top2_gaps(tm, tparams, prompt, out):
    """Top-2 logit gap and logits' scale of every greedy step of one
    stream, recomputed by the port's one-shot prefill of the sequence."""
    gaps = []
    for j in range(len(out)):
        seq = np.concatenate([prompt, np.asarray(out[:j], np.int32)])
        logits, _ = tm.prefill(tparams, {"tokens": seq[None]})
        top = torch.topk(logits[0], 2).values
        gaps.append((float(top[0] - top[1]), float(logits.abs().max())))
    return gaps


def hold_streams(tm, tparams, prompts, got, want):
    """Equal streams with f32 compute.  In bf16 a stream may part only at a
    step whose top-2 gap is below twice the logits' bound (``units * u``
    of their scale)."""
    assert len(got) == len(want) == len(prompts)
    for prompt, g, w in zip(prompts, got, want):
        if tm.cfg.compute_dtype == "float32":
            assert g == w
            continue
        part = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b),
                    None)
        if part is None:
            assert g == w
            continue
        gap, scale = top2_gaps(tm, tparams, prompt, w)[part]
        assert gap < 2 * units(tm.cfg) * U * scale, (part, gap, scale)


# one prompt length, past the 16-token budget: one prompt admitted a step;
# the JAX engine's one-shot prefill compiles once a length
LENS = (17, 17, 17, 17)


def serve_streams(eng, prompts, max_new=6):
    for p in prompts:
        eng.submit(p, max_new_tokens=max_new, temperature=0.0)
    done = sorted(eng.run(), key=lambda r: r.uid)
    assert all(r.error is None for r in done), [r.error for r in done]
    return [list(r.output) for r in done]


def engine_case(arch, tag, policy=None, **over):
    """The port's engine (default ``cache_kind``: the dense fallback, 2
    slots, 16-token budget: one prompt admitted a step, each but the first
    beside a decode) against the JAX engine on the same weights and
    prompts, then the same JAX engine serving each prompt alone, one after
    another (no row is then stepped beside a prefill; one decode compile
    serves both).  Returns (port model, params, prompts, port streams, JAX
    batch streams, JAX streams alone, the uids the JAX batch admitted
    beside a decode)."""
    jm, jp, tm, tp = bridged(arch, tag, policy, **over)
    rng = np.random.default_rng(30)
    prompts = [rng.integers(4, 500, size=n).astype(np.int32) for n in LENS]
    eng = Engine(tm, tp, **ENGINE, device="cpu")
    assert not eng.paged and "page_table" not in eng.cache
    got = serve_streams(eng, prompts)
    jeng = JaxEngine(jm, jp, **ENGINE)
    want = serve_streams(jeng, prompts)
    assert not jeng.paged
    assert eng.plan_log == jeng.plan_log
    alone = [serve_streams(jeng, [p])[0] for p in prompts]
    beside = {uid for plan in jeng.plan_log if plan["decodes"]
              for uid, _ in plan["admitted"]}
    return tm, tp, prompts, got, want, alone, beside


@functools.lru_cache(maxsize=None)
def engine_f32(arch):
    return engine_case(arch, "engine-f32", **F32)


def engines_match(arch, case):
    """The port's streams equal the JAX engine's for each prompt alone
    (f32), or part only at a bf16 near-tie; with f32 compute, a prompt the
    reference's fault cannot reach gets the JAX batch's stream too."""
    if case == "f32":
        tm, tp, prompts, got, want, alone, beside = engine_f32(arch)
    else:
        over = dict(F32) if case == "q4_0-f32" else {}
        if case == "int8-kv":
            over["kv_cache_dtype"] = "int8"
        tm, tp, prompts, got, want, alone, beside = engine_case(
            arch, f"engine-{case}", Q4 if case.startswith("q4") else None,
            **over)
    hold_streams(tm, tp, prompts, got, alone)
    if tm.cfg.compute_dtype == "float32":
        for uid, (g, w) in enumerate(zip(got, want), start=1):
            if uid not in beside:
                assert g == w
    if case.startswith("q4"):
        assert tp["blocks" if "blocks" in tp else "blocks_main"]["ssm"][
            "wz"].bits == 4


@pytest.mark.parametrize("case", ["f32", "bf16", "q4_0-f32"])
def test_engine_matches_jax_engine(case, pinned):
    """The reduced engine against the JAX engine (``engine_case``): equal
    plan logs; greedy streams equal to the JAX engine's for each prompt
    alone with f32 compute (Q8_0 and Q4_0 weights) and to its batch where
    the reference's fault cannot reach; in bf16 parting only at a
    near-tie."""
    engines_match(ARCH, case)


def reference_fault_shows(arch):
    """The JAX engine's batch streams part from its own streams of each
    prompt alone for a prompt admitted beside a decode (its state advanced
    by the padding token of the step that prefilled it), and only there;
    the port's batch streams equal the port's one-slot engine's."""
    tm, tp, prompts, got, want, alone, beside = engine_f32(arch)
    parted = {uid for uid, (w, a) in enumerate(zip(want, alone), start=1)
              if w != a}
    assert parted and parted <= beside
    one = serve_streams(Engine(tm, tp, **dict(ENGINE, max_slots=1),
                               device="cpu"), prompts)
    assert got == one == alone


def test_reference_engine_advances_a_row_prefilled_in_its_step(pinned):
    reference_fault_shows(ARCH)


def refusals_match_jax(arch):
    """On the dense fallback, best-of-n is rejected with the reference's
    message and speculation refused at construction, as by the JAX engine;
    the paged pool refuses the family."""
    jm, jp, tm, tp = bridged(arch, "refusals")
    for eng in (Engine(tm, tp, **ENGINE, device="cpu"),
                JaxEngine(jm, jp, **ENGINE)):
        eng.submit(np.arange(4, 9, dtype=np.int32), max_new_tokens=2,
                   temperature=0.0, n_samples=2)
        (req,) = eng.run()
        assert req.error_kind == "invalid" and "paged" in req.error
    for make in (lambda: Engine(tm, tp, **ENGINE, spec_tokens=2,
                                device="cpu"),
                 lambda: JaxEngine(jm, jp, **ENGINE, spec_tokens=2)):
        with pytest.raises(ValueError, match="paged"):
            make()
    with pytest.raises(ValueError, match="paged"):
        tm.init_paged_cache(2, n_blocks=4, max_blocks_per_seq=2,
                            device="cpu")


def test_best_of_n_and_speculation_are_refused_as_by_jax(pinned):
    refusals_match_jax(ARCH)


@pytest.mark.parametrize("policy", [None, Q4], ids=["q8_0", "q4_0"])
def test_init_quantized_is_quantize_of_init_bitwise(policy, monkeypatch):
    """``Model.init_quantized`` against ``Model.quantize(Model.init(seed))``:
    the same tree, every code and scale equal (slices of 4096 values make
    every weight several slices); ``wdt``, the convs and the dynamics f32
    and unquantized; the in / out projections quantized."""
    monkeypatch.setattr(transformer, "_INIT_SLICE", 4096)
    m = build_model(tconfigs.reduced(tconfigs.get_config(ARCH)))
    pol = None if policy is None else QuantPolicy(**policy)
    got = m.init_quantized(5, pol, device="cpu")
    assert not tree_differs(got, m.quantize(m.init(5, device="cpu"), pol))
    ssm = got["blocks"]["ssm"]
    for k in ("wz", "wx", "wB", "wC", "out_proj"):
        assert isinstance(ssm[k], QuantizedTensor)
    for k in ("wdt", "conv_x", "conv_B", "conv_C", "A_log", "dt_bias",
              "D_skip"):
        assert isinstance(ssm[k], torch.Tensor) \
            and ssm[k].dtype == torch.float32


def test_serve_cli_serves_mamba2_on_the_cpu(capsys):
    """``serve.py --arch mamba2-370m --device cpu``: the reduced config on
    the dense fallback serves every request at the reference's sampling;
    its parameters are ``quantize(init(seed))`` bit for bit."""
    serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                "--max-new", "4", "--slots", "2", "--max-seq", "64"])
    out = capsys.readouterr().out
    assert f"[serve] {ARCH} (2 layers, d_model 128) on cpu" in out
    assert "[serve] 3/3 requests" in out
    eng, done = serve.run(ARCH, requests=2, max_new=3, slots=2, max_seq=64,
                          seed=1, device="cpu")
    assert not eng.paged
    assert len(done) == 2 and all(1 <= len(r.output) <= 3 for r in done)
    assert all(0 <= t < eng.model.cfg.vocab_size for r in done
               for t in r.output)
    m = build_model(tconfigs.reduced(tconfigs.get_config(ARCH)))
    assert not tree_differs(eng.params, m.quantize(
        m.init(1, device="cpu"), QuantPolicy(bits=8, min_size=512)))
