"""The port's dense-cache path and Q4_0 weights against the JAX package on
the CPU.

Dense cache: the one-shot ``prefill`` and the dense ``decode_step`` against
the JAX model, and the dense ``Engine`` against the JAX dense ``Engine``
(equal greedy streams and plan logs), f32 and int8 KV; inside the port, the
dense streams equal the paged ones (as ``tests/test_decode_paths.py``
holds for the JAX package).  Q4_0: the policy ``launch/serve.py --bits 4``
builds, codes and scales bitwise, the Q4 embedding and ``qdot`` under both
strategies, and Q4 engines on both caches.

Tolerances are those of ``test_torch_model.py``: under ``dequant`` on both
sides the packages differ by f32 summation order only (1e-5 on logits and
f32 cache rows, int8 codes within one); under the paper's integer
arithmetic (JAX ``"integer"``, the port's ``"kernel"``) a requantized
activation code can flip and move a logit by up to 3e-2 and a cache row by
up to 5e-2 (ROADMAP section C).  The JAX one-shot prefill compiles once per
prompt length, so the prompts here use few distinct lengths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.core import qlinear as jqlinear
from repro.core.policy import QuantPolicy as JQuantPolicy
from repro.models import build_model as jax_build_model
from repro.models import layers as JL
from repro.serving.engine import Engine as JaxEngine
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax
from repro_torch.core import qlinear as tqlinear
from repro_torch.core.policy import QuantPolicy
from repro_torch.models import layers as TL
from repro_torch.models.model import build_model
from repro_torch.serving.engine import Engine

from test_torch_engine import _top2_gaps
from test_torch_model import PAIRS, _check_pool, _np
from test_torch_model import strategies  # noqa: F401  (the fixture)

torch.set_num_threads(2)

Q4 = dict(bits=4, min_size=512)          # launch/serve.py --bits 4


def _models(kv: str, tag: str, bits: int = 8):
    tag = f"llama2-110m-torch-dense-{tag}-{kv}-q{bits}"
    jcfg = reduced(get_config("llama2-110m")).with_(arch_id=tag,
                                                    kv_cache_dtype=kv)
    tcfg = tconfigs.reduced(tconfigs.get_config("llama2-110m")).with_(
        arch_id=tag, kv_cache_dtype=kv)
    jm = jax_build_model(jcfg)
    policy = JQuantPolicy(**Q4) if bits == 4 else None
    jparams = jm.quantize(jm.init(jax.random.PRNGKey(0)), policy)
    tm = build_model(tcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return jm, jparams, tm, tparams


@pytest.mark.parametrize("strategies", list(PAIRS), indirect=True,
                         ids=["dequant", "integer-kernel"])
@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_prefill_then_decode_matches_jax(kv, strategies):
    logit_tol, pool_tol = strategies
    jm, jparams, tm, tparams = _models(kv, tqlinear.default_strategy())
    int8 = kv == "int8"
    rng = np.random.default_rng(0)
    toks = rng.integers(4, 500, size=(2, 11)).astype(np.int32)
    jl, jcache = jm.prefill(jparams, {"tokens": jnp.asarray(toks)},
                            max_seq=24)
    tl, tcache = tm.prefill(tparams, {"tokens": toks}, max_seq=24)
    np.testing.assert_allclose(_np(tl), _np(jl), **logit_tol)
    _check_pool(jcache, tcache, int8, pool_tol)

    jdecode = jax.jit(jm.decode_step)
    for step in range(3):
        if step == 2:
            # a row at the end of its reservation writes at the last
            # position (clamped, as dynamic_update_slice clamps) and
            # attends all of it
            jcache["lens"] = jnp.asarray([13, 24], jnp.int32)
            tcache["lens"] = torch.tensor([13, 24], dtype=torch.int32)
        t = rng.integers(4, 500, size=(2,)).astype(np.int32)
        jl, jcache = jdecode(jparams, jcache, jnp.asarray(t))
        tl, tcache = tm.decode_step(tparams, tcache, torch.from_numpy(t))
        np.testing.assert_allclose(_np(tl), _np(jl), **logit_tol)
        _check_pool(jcache, tcache, int8, pool_tol)
    assert _np(tcache["lens"]).tolist() == [14, 25]


def test_attention_twins_match_jax():
    """The jnp twins of the one-shot prefill and dense decode attention
    (``attention_scores_blockwise``, ``attention_decode``) against the JAX
    package's, and against the port's kernel wrappers on the CPU."""
    rng = np.random.default_rng(9)
    b, s, h, kvh, d = 2, 12, 4, 2, 16
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, kvh, d)).astype(np.float32)
            for _ in range(2))
    t = torch.from_numpy
    scale = d ** -0.5
    jcfg = JL.AttnConfig(h, kvh, d, q_chunk=4)
    tcfg = TL.AttnConfig(h, kvh, d, q_chunk=4)
    want = np.asarray(JL.attention_scores_blockwise(
        jnp.asarray(q * scale), jnp.asarray(k), jnp.asarray(v), jcfg))
    got = TL.attention_scores_blockwise(t(q * scale), t(k), t(v), tcfg)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=0)
    from repro_torch.kernels import ops
    np.testing.assert_allclose(ops.flash_prefill(t(q), t(k), t(v)).numpy(),
                               want, atol=2e-6, rtol=0)
    with pytest.raises(NotImplementedError):
        TL.attention_scores_blockwise(t(q), t(k), t(v),
                                      tcfg._replace(window=4))

    qd = (rng.standard_normal((b, h, d)) * scale).astype(np.float32)
    lens = np.array([7, 0], np.int32)
    want = np.asarray(JL.attention_decode(
        jnp.asarray(qd), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        jcfg))
    got = TL.attention_decode(t(qd), t(k), t(v), t(lens), tcfg)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=0)
    got = ops.decode_attention(t(qd), t(k), t(v), t(lens))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=0)


def _serve(engine, prompts, max_new=6):
    for p in prompts:
        engine.submit(p, max_new_tokens=max_new, temperature=0.0)
    done = sorted(engine.run(), key=lambda r: r.uid)
    assert all(r.error is None for r in done), [r.error for r in done]
    return [list(r.output) for r in done], engine.plan_log


def _prompts(seed, lens=(11, 5, 11, 5)):
    rng = np.random.default_rng(seed)
    return [rng.integers(4, 500, size=n).astype(np.int32) for n in lens]


@pytest.mark.parametrize("strategies", [("dequant", "dequant")],
                         indirect=True, ids=["dequant"])
@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_dense_engine_matches_jax_dense_engine(kv, strategies):
    jm, jparams, tm, tparams = _models(kv, "engine")
    prompts = _prompts(1)
    kw = dict(max_slots=2, max_seq=48, cache_kind="dense")
    want, want_log = _serve(JaxEngine(jm, jparams, **kw), prompts)
    eng = Engine(tm, tparams, **kw, device="cpu")
    got, got_log = _serve(eng, prompts)
    assert got_log == want_log
    for prompt, w in zip(prompts, want):
        assert min(_top2_gaps(tm, tparams, prompt, w)) > \
            10 * strategies[0]["atol"]
    assert got == want
    assert eng.cache_utilization() == 0.0


@pytest.mark.parametrize("strategy", ["dequant", "kernel"])
@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_dense_streams_equal_paged(kv, strategy):
    """Inside the port, the dense cache gives the paged pool's greedy
    streams (tests/test_decode_paths.py::test_engine_paged_matches_dense_
    greedy for the JAX package), and both drain to an empty cache."""
    old = tqlinear.default_strategy()
    tqlinear.set_default_strategy(strategy)
    try:
        tm = build_model(tconfigs.reduced(
            tconfigs.get_config("llama2-110m")).with_(kv_cache_dtype=kv))
        params = tm.quantize(tm.init(0, device="cpu"))
        prompts = _prompts(0, (8, 3, 17, 5))
        outs = {}
        for kind in ("paged", "dense"):
            eng = Engine(tm, params, max_slots=2, max_seq=64, page_size=8,
                         cache_kind=kind, device="cpu")
            outs[kind], _ = _serve(eng, prompts, max_new=5)
            assert eng.cache_utilization() == 0.0
        assert outs["dense"] == outs["paged"]
    finally:
        tqlinear.set_default_strategy(old)


def test_dense_engine_rejects_sampling_groups():
    """n_samples > 1 needs the block pool (fork / copy-on-write): the dense
    Engine rejects it with the reference's message."""
    tm = build_model(tconfigs.reduced(tconfigs.get_config("llama2-110m")))
    eng = Engine(tm, tm.quantize(tm.init(0, device="cpu")), max_slots=2,
                 max_seq=32, cache_kind="dense", device="cpu")
    eng.submit([5, 6, 7], max_new_tokens=2, temperature=0.0, n_samples=2)
    (req,) = eng.run()
    assert req.error_kind == "invalid" and "paged" in req.error


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def test_q4_policy_embed_and_qdot_match_jax():
    """The Q4 policy's codes and scales (fused operands included) bitwise,
    the Q4 embedding bitwise, and Q4 ``qdot`` under ``integer`` and
    ``dequant`` within f32 summation order; the port's ``kernel`` strategy
    runs the same function as its ``integer`` one on the CPU."""
    jm = jax_build_model(reduced(get_config("llama2-110m")))
    jfloat = jm.init(jax.random.PRNGKey(3))
    jq = jm.quantize(jfloat, JQuantPolicy(**Q4))
    tm = build_model(tconfigs.reduced(tconfigs.get_config("llama2-110m")))
    tq = tm.quantize(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                            jfloat),
                                     device="cpu"), QuantPolicy(**Q4))
    want = dict(_leaves(jax.tree_util.tree_map(np.asarray, jq)))
    got = dict(_leaves(tq))
    assert set(got) == set(want)
    n4 = 0
    for path, w in want.items():
        g = got[path]
        if hasattr(w, "bits"):
            n4 += w.bits == 4
            assert (g.bits, g.group_size, g.orig_dim) == \
                (w.bits, w.group_size, w.orig_dim), path
            assert g.q.numpy().tobytes() == np.asarray(w.q).tobytes(), path
            assert g.scale.numpy().tobytes() == \
                np.asarray(w.scale).tobytes(), path
    assert n4 >= 10

    toks = np.array([[3, 511, 7], [0, 42, 42]], np.int32)
    np.testing.assert_array_equal(
        TL.embed_lookup(tq["embed"], torch.from_numpy(toks)).numpy(),
        np.asarray(JL.embed_lookup(jq["embed"], jnp.asarray(toks))))

    x = np.random.default_rng(2).standard_normal((5, 128)).astype(np.float32)
    w_j = jax.tree_util.tree_map(lambda a: a[0], jq["blocks"]["mlp"]["w13"])
    w_t = tq["blocks"]["mlp"]["w13"]
    w_t = type(w_t)(q=w_t.q[0], scale=w_t.scale[0], group_size=w_t.group_size,
                    bits=4, orig_dim=w_t.orig_dim)
    for s in ("integer", "dequant"):
        want = np.asarray(jqlinear.qdot(jnp.asarray(x), w_j, strategy=s))
        got = tqlinear.qdot(torch.from_numpy(x), w_t, strategy=s).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        tqlinear.qdot(torch.from_numpy(x), w_t, strategy="kernel").numpy(),
        tqlinear.qdot(torch.from_numpy(x), w_t, strategy="integer").numpy())


@pytest.mark.parametrize("strategies", [("dequant", "dequant")],
                         indirect=True, ids=["dequant"])
@pytest.mark.parametrize("cache_kind", ["paged", "dense"])
def test_q4_engine_matches_jax_engine(cache_kind, strategies):
    jm, jparams, tm, tparams = _models("float32", "q4-" + cache_kind, bits=4)
    prompts = _prompts(2)
    kw = dict(max_slots=2, max_seq=48, page_size=8, cache_kind=cache_kind)
    want, want_log = _serve(JaxEngine(jm, jparams, **kw), prompts)
    got, got_log = _serve(Engine(tm, tparams, **kw, device="cpu"), prompts)
    assert got_log == want_log
    for prompt, w in zip(prompts, want):
        assert min(_top2_gaps(tm, tparams, prompt, w)) > \
            10 * strategies[0]["atol"]
    assert got == want
