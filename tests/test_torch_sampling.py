"""The port's sampling against ``jax.random`` and the JAX Engine, on the CPU.

- ``repro_torch.core.prng`` equals ``jax.random`` (threefry-2x32,
  partitionable) bit for bit: keys, splits, ``fold_in`` chains, raw bits,
  uniform and gumbel draws and categorical samples, over the seeds the
  engine and ``launch/serve.py`` use (0, 1, 2**31 - 1, seed + i).
- ``sample_logits`` / ``sample_logits_per_row`` equal the reference's on
  the same logits for temperature {0, 0.7, 1.0} x top_p {1.0, 0.9}.
- The port's Engine serves sampled traffic (per-request temperature and
  top-p, best-of-n fanout, a warm fanout over cached blocks) with the JAX
  Engine's streams and plan logs, on bridged weights under ``dequant`` on
  both sides, f32 and int8 KV.
- Inside the port, sibling ``i`` of a group equals the ``(seed, stream=i)``
  rerun bitwise, and the request-level contract of
  ``tests/test_sampling_groups.py`` holds.

Hazards, and what these tests do about them.  A sampled token is the
argmax of ``logits / t + gumbel``: with the gumbel noise bitwise equal, it
parts only where the logits differ by more than the perturbed top-2 gap.
Under ``dequant`` the packages' logits differ by ~1e-6 (f32 summation
order), so a parting needs a gap below that; the seeds here give none.  The
nucleus mask compares a cumulative sum whose summation order differs
between XLA and PyTorch, so at a near-tie of the cumulative probability
with ``top_p`` the boundary token can be kept on one side only; that moves
the sample only if that one token wins the draw.  The seeds here hit
neither hazard, and every test requires the samples to be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.core import qlinear as jqlinear
from repro.models import build_model as jax_build_model
from repro.serving import engine as jengine
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax
from repro_torch.core import prng
from repro_torch.core import qlinear as tqlinear
from repro_torch.models.model import build_model
from repro_torch.serving import engine as tengine
from repro_torch.serving.engine import Engine

torch.set_num_threads(2)

SEEDS = [0, 1, 2, 3, 2 ** 31 - 1]


def _np(key_or_bits):
    return np.asarray(key_or_bits).astype(np.int64)


# ---------------------------------------------------------------------------
# threefry keys and draws
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_match_jax_random(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.prng_key(seed)
    np.testing.assert_array_equal(tk.numpy(), _np(jk))
    for num in (2, 3):
        np.testing.assert_array_equal(prng.split(tk, num).numpy(),
                                      _np(jax.random.split(jk, num)))
    # the engine's chains: the engine key's splits, a stream root
    # fold_in(root, stream + i), a token key fold_in(stream_root, t)
    jkey, tkey = jk, tk
    for _ in range(3):
        jkey, jsub = jax.random.split(jkey)
        tkey, tsub = prng.split(tkey)
        np.testing.assert_array_equal(tsub.numpy(), _np(jsub))
    for stream in (0, 1, 5):
        for t in (0, 1, 47):
            want = jax.random.fold_in(jax.random.fold_in(jk, stream), t)
            got = prng.fold_in(prng.fold_in(tk, stream), t)
            np.testing.assert_array_equal(got.numpy(), _np(want))
    # a (B, 2) key batch folds one datum per row, as vmap does
    roots = torch.stack([prng.fold_in(tk, i) for i in range(4)])
    got = prng.fold_in(roots, torch.tensor([0, 3, 9, 2 ** 32 - 1]))
    want = jax.vmap(jax.random.fold_in)(
        jnp.stack([jax.random.fold_in(jk, i) for i in range(4)]),
        jnp.asarray([0, 3, 9, 2 ** 32 - 1], jnp.uint32))
    np.testing.assert_array_equal(got.numpy(), _np(want))


@pytest.mark.parametrize("seed", SEEDS)
def test_draws_match_jax_random(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.prng_key(seed)
    for shape in [(1, 32000), (3, 7), (5,)]:
        np.testing.assert_array_equal(
            prng.random_bits(tk, shape).numpy(),
            _np(jax.random.bits(jk, shape)))
    np.testing.assert_array_equal(
        prng.uniform(tk, (4096,), -2.0, 3.0).numpy(),
        np.asarray(jax.random.uniform(jk, (4096,), minval=-2.0,
                                      maxval=3.0)))
    got = prng.gumbel(tk, (1, 32000)).numpy()
    want = np.asarray(jax.random.gumbel(jk, (1, 32000)))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    logits = np.random.default_rng(seed % 1000).standard_normal(
        (4, 32000)).astype(np.float32)
    np.testing.assert_array_equal(
        prng.categorical(tk, torch.from_numpy(logits)).numpy(),
        np.asarray(jax.random.categorical(jk, jnp.asarray(logits))))
    keys = jax.random.split(jk, 4)
    np.testing.assert_array_equal(
        prng.categorical(torch.from_numpy(_np(keys)),
                         torch.from_numpy(logits)).numpy(),
        np.asarray(jax.vmap(jax.random.categorical)(keys,
                                                    jnp.asarray(logits))))


def test_log_is_xla_log_bitwise():
    """The gumbel transform's log is XLA's f32 log on the CPU, bit for bit
    (torch.log differs in the last place for ~1 value in 7)."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        np.array([0.0, -0.0, -1.0, np.inf, 1e-45, 1e-40, 1.0, 2.0, 0.5,
                  np.finfo(np.float32).tiny, 3e38], np.float32),
        rng.uniform(0, 1, 500_000).astype(np.float32),
        np.exp(rng.uniform(-80, 80, 500_000)).astype(np.float32)])
    got = prng.log(torch.from_numpy(x)).numpy()
    want = np.asarray(jnp.log(jnp.asarray(x)))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert np.isnan(prng.log(torch.tensor([-1.0, np.nan])).numpy()).all()


# ---------------------------------------------------------------------------
# sample_logits / sample_logits_per_row
# ---------------------------------------------------------------------------


def _logits(seed: int, b: int = 6, v: int = 32000):
    """Rows of the spread a random llama2-110m head gives (std ~0.5), and
    peaked rows a trained model gives."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, v)).astype(np.float32)
    x[: b // 2] *= 0.5
    x[b // 2:] *= 4.0
    return x


@pytest.mark.parametrize("top_p", [1.0, 0.9])
@pytest.mark.parametrize("temperature", [0.0, 0.7, 1.0])
def test_sample_logits_match_jax(temperature, top_p):
    logits = _logits(int(temperature * 10 + top_p * 100))
    jl, tl = jnp.asarray(logits), torch.from_numpy(logits)
    for seed in (0, 7):
        jk = jax.random.PRNGKey(seed)
        got = tengine.sample_logits(prng.prng_key(seed), tl, temperature,
                                    top_p)
        want = jengine.sample_logits(jk, jl, temperature, top_p)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        keys = jax.random.split(jk, logits.shape[0])
        t = np.linspace(0.0, temperature, logits.shape[0]).astype(np.float32)
        got = tengine.sample_logits_per_row(
            torch.from_numpy(_np(keys)), tl, torch.from_numpy(t), top_p)
        want = jengine.sample_logits_per_row(keys, jl, jnp.asarray(t), top_p)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.dtype == torch.int32


def test_sample_logits_vectorized_params():
    """The reference's contract: a greedy row is the argmax whatever its
    neighbours, and a top_p=0.6 row samples only inside its nucleus."""
    logits = torch.log(torch.tensor([[0.5, 0.3, 0.15, 0.05],
                                     [0.05, 0.15, 0.3, 0.5]]))
    t, p = torch.tensor([1.0, 0.0]), torch.tensor([0.6, 1.0])
    seen0 = set()
    for i in range(64):
        tok = tengine.sample_logits(prng.prng_key(i), logits, t, p)
        seen0.add(int(tok[0]))
        assert int(tok[1]) == 3
    assert seen0 <= {0, 1} and len(seen0) == 2


# ---------------------------------------------------------------------------
# the Engine against the JAX Engine (dequant on both sides)
# ---------------------------------------------------------------------------


@pytest.fixture
def dequant():
    old_j, old_t = jqlinear.default_strategy(), tqlinear.default_strategy()
    jqlinear.set_default_strategy("dequant")
    tqlinear.set_default_strategy("dequant")
    yield
    jqlinear.set_default_strategy(old_j)
    tqlinear.set_default_strategy(old_t)


def _bridged(kv: str):
    tag = f"llama2-110m-torch-sampling-{kv}"
    jcfg = reduced(get_config("llama2-110m")).with_(arch_id=tag,
                                                    kv_cache_dtype=kv)
    tcfg = tconfigs.reduced(tconfigs.get_config("llama2-110m")).with_(
        arch_id=tag, kv_cache_dtype=kv)
    jm = jax_build_model(jcfg)
    jparams = jm.quantize(jm.init(jax.random.PRNGKey(0)))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return jm, jparams, build_model(tcfg), tparams


def _sampled_traffic(engine):
    """Per-request sampling parameters, a best-of-3 group, an engine-keyed
    request, a greedy one; then the group again, warm on cached blocks."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(4, 500, size=n).astype(np.int32)
               for n in (13, 7, 21, 9)]
    engine.submit(prompts[0], max_new_tokens=6, temperature=1.0, top_p=0.9,
                  seed=11, n_samples=3)
    engine.submit(prompts[1], max_new_tokens=6, temperature=0.7)
    engine.submit(prompts[2], max_new_tokens=6, temperature=0.0)
    engine.submit(prompts[3], max_new_tokens=5, temperature=5.0, seed=4,
                  stream=2)
    first = sorted(engine.run(), key=lambda r: r.uid)
    engine.submit(prompts[2][:17], max_new_tokens=4, temperature=1.0,
                  seed=21, n_samples=2)
    second = engine.run()
    out = []
    for r in first + second:
        assert r.error is None, r.error
        out.append(r.outputs)
    return out


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_sampled_engine_matches_jax_engine(kv, dequant):
    jm, jparams, tm, tparams = _bridged(kv)
    kw = dict(max_slots=4, max_seq=64, page_size=8, prefill_chunk_tokens=16,
              seed=5)
    jeng = jengine.Engine(jm, jparams, **kw)
    teng = Engine(tm, tparams, **kw, device="cpu")
    want, got = _sampled_traffic(jeng), _sampled_traffic(teng)
    assert got == want
    assert teng.plan_log == jeng.plan_log
    assert teng.metrics["fanouts"] == jeng.metrics["fanouts"] == 2
    assert any("forked" in p for p in teng.plan_log)
    assert teng.metrics["prefix_hits"] == jeng.metrics["prefix_hits"] >= 1
    teng.pager.debug_check()
    assert teng.pager.utilization() == 0.0


# ---------------------------------------------------------------------------
# inside the port: fanout reruns and the request-level contract
# ---------------------------------------------------------------------------


def _port_model(kv: str = "float32"):
    cfg = tconfigs.reduced(tconfigs.get_config("llama2-110m")).with_(
        kv_cache_dtype=kv)
    m = build_model(cfg)
    return m, m.init(0, device="cpu")


def _engine(m, params, **kw):
    base = dict(max_slots=4, max_seq=64, page_size=8, device="cpu")
    base.update(kw)
    return Engine(m, params, **base)


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_siblings_equal_their_stream_reruns(kv):
    """Sibling i of a (seed=s, n_samples=n) request streams what an
    independent (seed=s, stream=i) request streams alone; the group
    prefills its prompt once and drains every block."""
    m, params = _port_model(kv)
    prompt = np.random.default_rng(10).integers(4, 500, size=13).astype(
        np.int32)
    eng = _engine(m, params, prefill_chunk_tokens=16)
    uid = eng.submit(prompt, max_new_tokens=7, temperature=1.0, top_p=0.9,
                     seed=11, n_samples=3)
    (r,) = eng.run()
    assert r.error is None and len(r.outputs) == 3
    assert all(len(o) == 7 for o in r.outputs) and r.output is r.outputs[0]
    assert [(s, e) for p in eng.plan_log for u, s, e in p["prefills"]
            if u == uid] == [(0, 13)]
    assert eng.metrics["fanouts"] == 1
    eng.pager.debug_check()
    assert eng.pager.utilization() == 0.0
    assert len({tuple(o) for o in r.outputs}) > 1
    for i in range(3):
        solo = _engine(m, params, prefill_chunk_tokens=16)
        solo.submit(prompt, max_new_tokens=7, temperature=1.0, top_p=0.9,
                    seed=11, stream=i)
        (ri,) = solo.run()
        assert ri.output == r.outputs[i], i


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_n_samples_one_greedy_identical_to_dense_engine(kv):
    m, params = _port_model(kv)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(4, 500, size=n).astype(np.int32)
               for n in (6, 11, 9)]

    def serve(kind):
        eng = _engine(m, params, cache_kind=kind)
        for p in prompts:
            eng.submit(p, max_new_tokens=8, temperature=0.0, n_samples=1)
        done = sorted(eng.run(), key=lambda r: r.uid)
        assert all(r.error is None for r in done)
        return done

    paged, dense = serve("paged"), serve("dense")
    assert [r.output for r in paged] == [r.output for r in dense]
    for r in paged:
        assert r.outputs == [r.output] and r.outputs[0] is r.output


def test_group_allocates_at_most_prompt_plus_n_tails():
    m, params = _port_model()
    plen, max_new, bs, n = 19, 8, 8, 4
    prompt = np.random.default_rng(1).integers(4, 500, size=plen).astype(
        np.int32)
    eng = _engine(m, params, page_size=bs)
    eng.submit(prompt, max_new_tokens=max_new, temperature=1.0, seed=5,
               n_samples=n)
    (r,) = eng.run()
    assert r.error is None and len(r.outputs) == n
    prompt_blocks = plen // bs
    tail_blocks = -(-(plen + max_new) // bs) - prompt_blocks
    assert eng.metrics["blocks_live_peak"] <= prompt_blocks + n * tail_blocks
    assert eng.metrics["blocks_saved_by_sharing_peak"] >= \
        (n - 1) * prompt_blocks
    eng.pager.debug_check()
    assert eng.pager.utilization() == 0.0


def test_stop_tokens_per_sibling():
    m, params = _port_model()
    prompt = np.random.default_rng(2).integers(4, 500, size=10).astype(
        np.int32)
    eng = _engine(m, params)
    eng.submit(prompt, max_new_tokens=8, temperature=1.0, seed=13,
               n_samples=3)
    (ref,) = eng.run()
    assert all(len(o) == 8 for o in ref.outputs)
    target = None
    for i, out in enumerate(ref.outputs):
        for j, tok in enumerate(out[1:-1], start=1):
            others = [o for k, o in enumerate(ref.outputs) if k != i]
            if all(tok not in o[:j + 1] for o in others):
                target, pos, sib = tok, j, i
                break
        if target is not None:
            break
    assert target is not None, "seeded streams must provide a stop token"
    eng2 = _engine(m, params)
    eng2.submit(prompt, max_new_tokens=8, temperature=1.0, seed=13,
                n_samples=3, stop_tokens=[int(target)])
    (r,) = eng2.run()
    assert r.outputs[sib] == ref.outputs[sib][:pos + 1]
    for k in range(3):
        if k != sib:
            assert r.outputs[k] == ref.outputs[k][:len(r.outputs[k])]
            assert len(r.outputs[k]) >= pos + 1
    eng3 = _engine(m, params)
    eng3.submit(prompt, max_new_tokens=8, temperature=1.0, seed=13,
                stream=sib, stop_tokens=[int(target)])
    (solo,) = eng3.run()
    assert solo.output == ref.outputs[sib][:pos + 1]


def test_first_token_stop_and_max_new_tokens_one():
    m, params = _port_model()
    prompt = np.random.default_rng(4).integers(4, 500, size=9).astype(
        np.int32)
    eng = _engine(m, params)
    eng.submit(prompt, max_new_tokens=1, temperature=1.0, seed=4,
               n_samples=3)
    eng.submit(prompt, max_new_tokens=1, temperature=0.0)
    done = sorted(eng.run(), key=lambda r: r.uid)
    assert [len(o) for o in done[0].outputs] == [1, 1, 1]
    assert len(done[1].output) == 1
    eng.pager.debug_check()
    assert eng.pager.utilization() == 0.0
    eng2 = _engine(m, params)
    eng2.submit(prompt, max_new_tokens=6, temperature=1.0, seed=4,
                n_samples=3)
    (ref,) = eng2.run()
    tok0 = int(ref.outputs[1][0])
    eng3 = _engine(m, params)
    eng3.submit(prompt, max_new_tokens=6, temperature=1.0, seed=4,
                n_samples=3, stop_tokens=[tok0])
    (r,) = eng3.run()
    assert r.outputs[1] == [tok0]


def test_group_request_errors():
    m, params = _port_model()
    prompt = np.random.default_rng(3).integers(4, 500, size=6).astype(
        np.int32)
    eng = _engine(m, params, max_slots=2)
    eng.submit(prompt, max_new_tokens=4, n_samples=3)
    eng.submit(prompt, max_new_tokens=4, n_samples=0)
    done = sorted(eng.run(), key=lambda r: r.uid)
    assert "max_slots" in done[0].error
    assert "n_samples" in done[1].error
    dense = _engine(m, params, cache_kind="dense")
    dense.submit(prompt, max_new_tokens=4, n_samples=2)
    (r,) = dense.run()
    assert r.error is not None and "paged" in r.error
