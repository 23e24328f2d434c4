"""The port's speculative decoding against the JAX package's, on the CPU.

The reduced llama2-110m config at the sizes of the reference's own tests
(tests/test_spec_decode.py: 2 slots, pages of 8, a random and a repetitive
prompt), with the JAX weights carried across by the bridge:

  * ``NgramProposer`` proposes exactly the reference's drafts;
  * ``verify_chunk_batch``'s (B, c, V) logits and the pool it writes agree
    with the JAX entry (oracle prefix read) within the chunk step's parity
    tolerance, 1e-5 (test_torch_model.py);
  * the speculative ``Engine`` against the JAX engine at the same
    ``spec_tokens``: the same streams, ``plan_log`` (verifies included) and
    speculation counters, for f32 weights on f32 and int8 pools, for Q8_0
    weights under ``dequant`` and for a sampled request;
  * greedy speculative streams equal the port's own plain streams whatever
    the proposer (n-gram, a replay oracle, always-wrong drafts): the verify
    and decode paths differ only by f32 summation order (each within 1e-5
    of the reference), and every step of these streams has a top-2 gap
    above twice that;
  * the verify entry keeps one shape per pool key while draft lengths
    churn, rollback leaves no lease, a self-drafting ``DraftModelProposer``
    accepts nearly everything, and ``serve.py --spec-tokens`` prints the
    speculation line.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.core import qlinear as jqlinear
from repro.models import build_model as jax_build_model
from repro.serving import spec_decode as jspec
from repro.serving.engine import Engine as JaxEngine
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax
from repro_torch.core import qlinear as tqlinear
from repro_torch.kernels import build
from repro_torch.models.model import build_model
from repro_torch.serving.engine import Engine
from repro_torch.serving.spec_decode import (DraftModelProposer,
                                             DraftProposer, NgramProposer,
                                             build_proposer)

from test_torch_engine import _top2_gaps

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
ENGINE = dict(max_slots=2, max_seq=96, page_size=8)
# the chunk step's parity tolerance under dequant (test_torch_model.py)
TOL = dict(atol=1e-5, rtol=1e-5)
# the port's chunk (verify) and decode logits are each within 1e-5 of the
# JAX package's (test_torch_model.py), so within 2e-5 of each other: a
# greedy step whose top-2 gap is above that cannot part
GAP = 2e-5


@pytest.fixture
def dequant(monkeypatch):
    """Both packages under ``dequant`` with the JAX chunk step's plain
    prefix read (its tests' default on the CPU); no CUDA launch."""
    monkeypatch.setenv("REPRO_FUSED_PREFILL", "oracle")
    old_j, old_t = jqlinear.default_strategy(), tqlinear.default_strategy()
    jqlinear.set_default_strategy("dequant")
    tqlinear.set_default_strategy("dequant")
    build.reset_launches()
    yield
    jqlinear.set_default_strategy(old_j)
    tqlinear.set_default_strategy(old_t)
    assert all(v == 0 for v in build.LAUNCHES.values())


def _models(tag: str, kv: str = "float32", quantized: bool = False):
    """(JAX model, its params, port model, the bridged params) under a
    config of their own: both packages count chunk and verify shapes per
    config, and the JAX count is also per parameter tree."""
    tag = f"llama2-110m-torch-spec-{tag}-{kv}"
    jm = jax_build_model(reduced(get_config("llama2-110m")).with_(
        arch_id=tag, kv_cache_dtype=kv))
    jparams = jm.init(jax.random.PRNGKey(0))
    if quantized:
        jparams = jm.quantize(jparams)
    tm = build_model(tconfigs.reduced(tconfigs.get_config(
        "llama2-110m")).with_(arch_id=tag, kv_cache_dtype=kv))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return jm, jparams, tm, tparams


def _prompts():
    """The reference test's prompts: a random one, and a repetitive one
    whose suffix the n-gram proposer finds earlier in the context."""
    rng = np.random.default_rng(5)
    flat = rng.integers(4, 500, size=11).astype(np.int32)
    rep = np.tile(np.asarray([7, 11, 13, 17], np.int32), 4)
    return [flat, rep]


class _ReplayProposer:
    """Replays a known stream: every draft is right."""

    def __init__(self, ref):
        self.ref = [int(t) for t in ref]

    def propose(self, prompt, output, k):
        m = len(output)
        return self.ref[m:m + k] if output == self.ref[:m] else []


class _WrongProposer:
    """Drafts that are always wrong (the right token plus one)."""

    def __init__(self, ref, vocab=512):
        self.ref = [int(t) for t in ref]
        self.vocab = vocab

    def propose(self, prompt, output, k):
        m = len(output)
        return [(t + 1) % self.vocab for t in self.ref[m:m + k]] or [3] * k


def _serve(engine, prompts, max_new=20, sampling=None):
    uids = [engine.submit(p, max_new_tokens=max_new,
                          **(sampling[i] if sampling else
                             dict(temperature=0.0)))
            for i, p in enumerate(prompts)]
    done = {r.uid: r for r in engine.run()}
    assert all(done[u].error is None for u in uids), \
        [done[u].error for u in uids]
    return [done[u].output for u in uids]


SPEC_METRICS = ("draft_tokens", "accepted_tokens", "verify_steps",
                "spec_rollbacks", "verify_compiles", "seq_steps",
                "tokens_out")


# -- proposers ------------------------------------------------------------


def _contexts():
    rng = np.random.default_rng(17)
    out = []
    for i in range(6):
        prompt = rng.integers(4, 40 if i % 2 else 9, size=int(
            rng.integers(3, 30))).astype(np.int32)
        output = [int(t) for t in rng.integers(4, 9, size=i * 3)]
        out.append((prompt, output))
    out.append((np.tile(np.asarray([7, 11, 13, 17], np.int32), 4), []))
    out.append((np.asarray([5, 6, 7], np.int32), [5, 6]))
    out.append((np.asarray([1, 2, 3, 4], np.int32), []))
    return out


@pytest.mark.parametrize("k", [0, 1, 3, 5])
@pytest.mark.parametrize("max_n,min_n,max_context",
                         [(3, 1, 1024), (2, 2, 1024), (4, 1, 12)])
def test_ngram_proposals_equal_the_reference(k, max_n, min_n, max_context):
    ours = NgramProposer(max_n, min_n, max_context)
    theirs = jspec.NgramProposer(max_n, min_n, max_context)
    got = [ours.propose(p, o, k) for p, o in _contexts()]
    assert got == [theirs.propose(p, o, k) for p, o in _contexts()]
    assert all(len(d) <= k for d in got)
    if k and max_n == 3:
        assert any(got)                        # repetition is found


def test_build_proposer_and_the_protocol():
    assert isinstance(build_proposer("ngram"), NgramProposer)
    assert isinstance(NgramProposer(), DraftProposer)
    assert isinstance(_ReplayProposer([1]), DraftProposer)
    with pytest.raises(ValueError):
        build_proposer("nonsense")
    with pytest.raises(ValueError):
        NgramProposer(max_n=1, min_n=2)


# -- the verify step ------------------------------------------------------


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_verify_chunk_batch_matches_jax(kv, dequant):
    """Two verify calls on a pool a chunk step filled: rows of draft
    lengths 4, 2 and padding, then all rows live; every live position's
    logits, the pool and the lengths against the JAX entry.  Each verify
    starts from the JAX pool: an int8 code the two packages' writes round
    differently (one in this pool) moves the logits of the rows that read
    it by ~1e-4, the decode path's known approximation, not the verify's."""
    jm, jparams, tm, tparams = _models("verify", kv, quantized=True)
    b, bs, nb, mb = 3, 8, 24, 8
    jcache = jm.init_paged_cache(b, block_size=bs, n_blocks=nb,
                                 max_blocks_per_seq=mb)
    tcache = tm.init_paged_cache(b, block_size=bs, n_blocks=nb,
                                 max_blocks_per_seq=mb, device="cpu")
    pt = np.full((b, mb), -1, np.int32)
    pt[0, :5] = [3, 5, 1, 0, 9]
    pt[1, :6] = [2, 7, 4, 11, 12, 13]
    pt[2, :3] = [6, 8, 10]
    jcache["page_table"] = jnp.asarray(pt)
    tcache["page_table"] = torch.from_numpy(pt.copy())
    rng = np.random.default_rng(3)
    toks = rng.integers(4, 500, size=(b, 16)).astype(np.int32)
    slots, lens = np.array([0, 1, 2]), np.array([16, 13, 9])
    _, jcache = jm.prefill_chunk_batch(jparams, toks, jcache, slots, 0,
                                       chunk_lens=lens)
    _, tcache = tm.prefill_chunk_batch(tparams, toks, tcache, slots, 0,
                                       chunk_lens=lens)
    c0 = tm.verify_compile_count()
    steps = [(np.array([0, 1, -1]), np.array([16, 13, 0]),
              np.array([5, 3, 0])),
             (np.array([0, 1, 2]), np.array([18, 14, 9]),
              np.array([5, 5, 1]))]
    for slots, offs, lens in steps:
        for key, buf in tcache["attn"].items():
            buf.copy_(torch.from_numpy(np.array(jcache["attn"][key])))
        toks = rng.integers(4, 500, size=(b, 5)).astype(np.int32)
        jl, jcache = jm.verify_chunk_batch(jparams, toks, jcache, slots,
                                           offs, chunk_lens=lens)
        tl, tcache = tm.verify_chunk_batch(tparams, toks, tcache, slots,
                                           offs, page_table=pt,
                                           chunk_lens=lens)
        assert tuple(tl.shape) == (b, 5, 512)
        for i in np.nonzero(slots >= 0)[0]:
            np.testing.assert_allclose(tl[i, :lens[i]].numpy(),
                                       np.asarray(jl)[i, :lens[i]], **TOL)
        for key in jcache["attn"]:
            got = tcache["attn"][key].numpy()
            want = np.asarray(jcache["attn"][key])
            if key in ("k", "v") and kv == "int8":
                assert np.abs(got.astype(np.int32) - want).max() <= 1
            else:
                np.testing.assert_allclose(got, want, err_msg=key, **TOL)
        np.testing.assert_array_equal(tcache["lens"].numpy(),
                                      np.asarray(jcache["lens"]))
    assert tm.verify_compile_count() == c0 + 1       # one (3, 5) extent


def test_prefill_chunk_is_the_batch_of_one(dequant):
    """``prefill_chunk`` (B = 1) against the JAX entry and against the
    batched step's row."""
    jm, jparams, tm, tparams = _models("chunk1")
    cache_kw = dict(block_size=8, n_blocks=8, max_blocks_per_seq=4)
    jcache = jm.init_paged_cache(2, **cache_kw)
    tcache = tm.init_paged_cache(2, device="cpu", **cache_kw)
    pt = np.full((2, 4), -1, np.int32)
    pt[1, :3] = [4, 2, 6]
    jcache["page_table"] = jnp.asarray(pt)
    tcache["page_table"] = torch.from_numpy(pt.copy())
    toks = np.random.default_rng(1).integers(4, 500, size=20)
    for start, end in ((0, 12), (12, 20)):
        jl, jcache = jm.prefill_chunk(jparams, jnp.asarray(toks[start:end]),
                                      jcache, 1, start)
        tl, tcache = tm.prefill_chunk(tparams, toks[start:end], tcache, 1,
                                      start)
        assert tuple(tl.shape) == (1, 512)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tcache["lens"].tolist() == [0, 20]


# -- the speculative engine against the JAX engine ----------------------------


PARITY = {
    # f32 weights, the reference test's own setting
    "f32-weights-f32-pool": ("float32", False, 4),
    "f32-weights-int8-pool": ("int8", False, 3),
    # the paper's Q8_0 weights (with the fused decode operands), dequant
    "q8-weights-f32-pool": ("float32", True, 4),
}


@pytest.mark.parametrize("case", list(PARITY))
def test_speculative_engine_matches_jax(case, dequant):
    kv, quantized, k = PARITY[case]
    jm, jparams, tm, tparams = _models(case, kv, quantized)
    jeng = JaxEngine(jm, jparams, **ENGINE, spec_tokens=k)
    want = _serve(jeng, _prompts())
    eng = Engine(tm, tparams, **ENGINE, spec_tokens=k, device="cpu")
    got = _serve(eng, _prompts())
    assert got == want
    assert eng.plan_log == jeng.plan_log
    assert any(p.get("verifies") for p in eng.plan_log)
    assert {m: eng.metrics[m] for m in SPEC_METRICS} \
        == {m: jeng.metrics[m] for m in SPEC_METRICS}
    assert eng.metrics["accepted_tokens"] > 0
    assert eng.metrics["accept_ratio"] == pytest.approx(
        jeng.metrics["accept_ratio"])
    assert eng.metrics["steps_per_token"] == pytest.approx(
        jeng.metrics["steps_per_token"])
    # the verify's prefix traffic is charged as a chunk's (the energy
    # itself differs by design: the port's roofline has H100 constants)
    assert eng.metrics["prefix_attn_bytes"] == \
        jeng.metrics["prefix_attn_bytes"] > 0
    assert eng.pager.audit(repair=False).clean
    assert all(rc == 0 for rc in eng.pager.refcount)


def test_sampled_speculative_request_matches_jax(dequant):
    """A seeded request at temperature 1.0 beside a greedy one, 4 slots,
    k = 3: each verify position draws with the key plain decode would use
    (threefry bitwise to the reference's), so the streams, plans and
    counters equal the JAX engine's."""
    jm, jparams, tm, tparams = _models("sampled")
    other = np.tile(np.asarray([23, 29, 31], np.int32), 5)
    prompts = [_prompts()[1], other]
    sampling = [dict(temperature=1.0, seed=77), dict(temperature=0.0)]
    kw = dict(ENGINE, max_slots=4, spec_tokens=3)
    jeng = JaxEngine(jm, jparams, **kw)
    want = _serve(jeng, prompts, 12, sampling)
    eng = Engine(tm, tparams, **kw, device="cpu")
    got = _serve(eng, prompts, 12, sampling)
    assert got == want
    assert eng.plan_log == jeng.plan_log
    assert {m: eng.metrics[m] for m in SPEC_METRICS} \
        == {m: jeng.metrics[m] for m in SPEC_METRICS}
    # and the sampled stream is the one plain decode draws
    plain = Engine(tm, tparams, **dict(kw, spec_tokens=0), device="cpu")
    assert _serve(plain, prompts, 12, sampling)[0] == got[0]


# -- greedy speculation equals the port's own plain decode -----------------------


@pytest.fixture(scope="module")
def f32_port():
    """The port's reduced model with f32 weights, and each prompt's plain
    greedy stream with the top-2 gap of its every step."""
    _, _, tm, tparams = _models("selfcheck")
    plain = {}
    for n_new in (20, 24):
        eng = Engine(tm, tparams, **ENGINE, device="cpu")
        outs = _serve(eng, _prompts(), n_new)
        gaps = [_top2_gaps(tm, tparams, p, o) for p, o in
                zip(_prompts(), outs)]
        assert min(min(g) for g in gaps) > GAP, gaps
        plain[n_new] = outs
    return tm, tparams, plain


@pytest.mark.parametrize("proposer", ["ngram", "replay", "wrong"])
def test_greedy_speculation_equals_plain_decode(f32_port, proposer):
    tm, tparams, plain = f32_port
    base = plain[20]
    if proposer == "ngram":
        drafts = [None]
    elif proposer == "replay":
        drafts = [_ReplayProposer(b) for b in base]
    else:
        drafts = [_WrongProposer(b) for b in base]
    for i, draft in enumerate(drafts):
        prompts = _prompts() if draft is None else [_prompts()[i]]
        eng = Engine(tm, tparams, **ENGINE, spec_tokens=4,
                     draft_proposer=draft, device="cpu")
        got = _serve(eng, prompts)
        assert got == (base if draft is None else [base[i]])
        m = eng.metrics
        assert m["verify_steps"] > 0 and m["draft_tokens"] > 0
        seq_verifies = sum(len(p.get("verifies", [])) for p in eng.plan_log)
        if proposer == "wrong":
            assert m["accepted_tokens"] == 0
            assert m["spec_rollbacks"] == seq_verifies > 0
        if proposer == "replay":
            assert m["accept_ratio"] > 0.9 and m["spec_rollbacks"] == 0
            assert m["steps_per_token"] < 0.5
        assert m["steps_per_token"] <= 1.0
        assert eng.pager.audit(repair=False).clean
        assert all(rc == 0 for rc in eng.pager.refcount)


@pytest.mark.parametrize("max_new", [2, 3, 5])
def test_max_new_tokens_is_never_exceeded(f32_port, max_new):
    tm, tparams, plain = f32_port
    base = plain[20][0][:max_new]
    eng = Engine(tm, tparams, **ENGINE, spec_tokens=4,
                 draft_proposer=_ReplayProposer(plain[20][0]), device="cpu")
    assert _serve(eng, _prompts()[:1], max_new) == [base]


def test_verify_keeps_one_shape_while_drafts_churn(f32_port):
    """Draft lengths change from step to step (the n-gram proposer returns
    0..k tokens), yet the verify step runs at one padded extent; a second
    wave adds none."""
    tm, tparams, plain = f32_port
    eng = Engine(tm, tparams, **ENGINE, spec_tokens=4, device="cpu")
    c0 = eng.verify_compile_count()
    p0 = eng.prefill_compile_count()
    _serve(eng, _prompts(), 16)
    lens = {ln for plan in eng.plan_log
            for (_, _, ln) in plan.get("verifies", [])}
    assert len(lens) > 1, lens                 # the drafts really churned
    assert eng.verify_compile_count() - c0 <= 1
    c1 = eng.verify_compile_count()
    _serve(eng, _prompts(), 8)
    assert eng.verify_compile_count() == c1 == eng.metrics["verify_compiles"]
    assert eng.prefill_compile_count() - p0 <= 1


def test_rollback_by_truncation_leaves_no_lease(f32_port):
    """Wrong drafts under pages of 4: every verify writes past the
    accepted length and truncation hands the blocks back, so the pool
    drains with no lease and a clean audit, and no rejected row was ever
    registered in the prefix index."""
    tm, tparams, plain = f32_port
    eng = Engine(tm, tparams, **dict(ENGINE, page_size=4), spec_tokens=4,
                 draft_proposer=_WrongProposer(plain[24][1]), device="cpu")
    assert _serve(eng, _prompts()[1:], 24) == [plain[24][1]]
    assert eng.metrics["spec_rollbacks"] > 0
    assert all(rc == 0 for rc in eng.pager.refcount)
    assert eng.pager.n_free() == eng.n_pages
    assert eng.pager.audit(repair=False).clean


def test_draft_model_proposer_drafts_the_target(f32_port):
    """The target drafting for itself: its greedy drafts verify, so nearly
    every draft is accepted and the stream is the plain one."""
    tm, tparams, plain = f32_port
    prop = DraftModelProposer(tm, tparams, max_seq=64)
    drafts = prop.propose(_prompts()[0], [], 3)
    assert len(drafts) == 3 and all(isinstance(t, int) for t in drafts)
    assert drafts == plain[20][0][:3]
    assert prop.propose(_prompts()[0], [], 0) == []
    eng = Engine(tm, tparams, **ENGINE, spec_tokens=3, draft_proposer=prop,
                 device="cpu")
    assert _serve(eng, _prompts()[:1], 8) == [plain[20][0][:8]]
    assert eng.metrics["accept_ratio"] > 0.9


def test_engine_wiring(f32_port):
    tm, tparams, _ = f32_port
    with pytest.raises(ValueError, match="paged"):
        Engine(tm, tparams, max_slots=2, max_seq=64, cache_kind="dense",
               spec_tokens=4, device="cpu")
    eng = Engine(tm, tparams, **ENGINE, spec_tokens=2, device="cpu")
    assert isinstance(eng.draft_proposer, NgramProposer)
    eng = Engine(tm, tparams, **ENGINE, device="cpu")
    _serve(eng, _prompts()[:1], 6)
    assert all(not p.get("verifies") for p in eng.plan_log)
    assert eng.metrics["verify_steps"] == 0
    assert eng.metrics["steps_per_token"] == 1.0


def test_step_async_runs_verify_steps_to_their_end(f32_port):
    """A step with verifies returns no pending work; the plain steps
    beside it still do, and the streams are the synchronous ones."""
    tm, tparams, plain = f32_port
    eng = Engine(tm, tparams, **ENGINE, spec_tokens=4, device="cpu")
    for p in _prompts():
        eng.submit(p, max_new_tokens=20, temperature=0.0)
    done, pendings = [], 0
    while eng.scheduler.has_work():
        n_plans = len(eng.plan_log)
        out, pending = eng.step_async()
        done.extend(out or [])
        if len(eng.plan_log) > n_plans and eng.plan_log[-1]["verifies"]:
            assert pending is None
        pendings += pending is not None
        done.extend(eng.finish_step(pending))
    assert pendings > 0 and eng.metrics["verify_steps"] > 0
    assert [r.output for r in sorted(done, key=lambda r: r.uid)] \
        == plain[20]


def test_serve_cli_prints_the_speculation_line():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--requests", "3",
         "--slots", "2", "--max-seq", "64", "--max-new", "6",
         "--spec-tokens", "2", "--device", "cpu"], capture_output=True,
        text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr
    assert "[serve] 3/3 requests" in out.stdout
    assert "[serve] speculation (ngram, k=2): accept_ratio" in out.stdout
