"""The port's serving Engine against the JAX package's Engine on the CPU.

Same weights (bridged), same requests, greedy: both engines must emit equal
token streams and equal ``plan_log``s (every step's chunk ranges, decodes,
preemptions, copy-on-write pairs, prefix-cache admissions and the chunk
step's shape count) for chunked, preempted (small pool) and prefix-warm
traffic, on f32 and int8 KV pools.  This mirrors
``tests/test_decode_paths.py::test_engine_paged_matches_dense_greedy``.

Strategies: ``dequant`` on both sides, where logits agree to ~1e-6 (the
model tests hold them to 1e-5), and the paper's integer arithmetic (JAX
``"integer"``, the port's ``"kernel"``), where a requantized activation
code can flip and move a row's logits by up to ~3e-2 (see
test_torch_model.py).  A greedy step is a near-tie when its top-2 logit gap
is below that tolerance: the dequant run asserts that no step is one (the
prompts are seeded to avoid them), and the integer run allows the streams
to part only at such a step.
"""

import inspect

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.core import qlinear as jqlinear
from repro.models import build_model as jax_build_model
from repro.serving.engine import Engine as JaxEngine
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax
from repro_torch.core import qlinear as tqlinear
from repro_torch.kernels import build
from repro_torch.models.model import Model, build_model
from repro_torch.serving.engine import Engine
from repro_torch.serving.faults import ERR_DEADLINE, ERR_NAN, SimClock

torch.set_num_threads(2)

# (JAX strategy, port strategy) -> logits tolerance of the pair
PAIRS = {("dequant", "dequant"): 1e-5, ("integer", "kernel"): 3e-2}

ENGINE = dict(max_slots=2, max_seq=64, page_size=8)
# traffic -> (prompt lengths, engine overrides, second-wave lengths)
TRAFFIC = {
    # prompts longer than the chunk budget: several chunks per prompt,
    # interleaved with decodes; three requests queue behind two slots
    "chunked": ((21, 3, 17, 40, 9), dict(prefill_chunk_tokens=16), ()),
    # a 5-page pool under two slots growing to ~30 rows: decode growth
    # must preempt and recompute
    "preempted": ((22, 20, 18), dict(prefill_chunk_tokens=24, n_pages=5),
                  ()),
    # a second wave sharing a two-page prefix with the first: admissions
    # map the cached blocks and prefill only the rest
    "prefix_warm": ((19, 27), dict(prefill_chunk_tokens=32), (23, 18)),
}


@pytest.fixture
def strategies(monkeypatch, request):
    jax_s, port_s = request.param
    monkeypatch.setenv("REPRO_FUSED_PREFILL", "interpret")
    old_j, old_t = jqlinear.default_strategy(), tqlinear.default_strategy()
    jqlinear.set_default_strategy(jax_s)
    tqlinear.set_default_strategy(port_s)
    build.reset_launches()
    yield PAIRS[request.param]
    jqlinear.set_default_strategy(old_j)
    tqlinear.set_default_strategy(old_t)
    assert all(v == 0 for v in build.LAUNCHES.values())


def _prompts(traffic: str, seed: int):
    lens, _, wave2 = TRAFFIC[traffic]
    rng = np.random.default_rng(seed)
    first = [rng.integers(4, 500, size=n).astype(np.int32) for n in lens]
    if not wave2:
        return first, []
    shared = first[0][:16]                      # two full pages
    second = [np.concatenate([shared, rng.integers(4, 500, size=n - 16)])
              .astype(np.int32) for n in wave2]
    return first, second


def _serve(engine, waves):
    outs = {}
    for wave in waves:
        for p in wave:
            engine.submit(p, max_new_tokens=6, temperature=0.0)
        for r in engine.run():
            assert r.error is None, r.error
            outs[r.uid] = list(r.output)
    return [outs[u] for u in sorted(outs)], engine.plan_log


def _top2_gaps(tm, tparams, prompt, out):
    """Top-2 logit gap of every greedy step of one stream, recomputed by
    the port as one whole-sequence chunk per step (under its own config,
    so these shapes stay out of the engine's chunk-shape count)."""
    tm = build_model(tm.cfg.with_(arch_id=tm.cfg.arch_id + "-gaps"))
    gaps = []
    for j in range(len(out)):
        seq = np.concatenate([prompt, np.asarray(out[:j], np.int32)])
        n = len(seq)
        cache = tm.init_paged_cache(1, block_size=8, n_blocks=8,
                                    max_blocks_per_seq=8, device="cpu")
        cache["page_table"] = torch.arange(8, dtype=torch.int32)[None]
        logits, _ = tm.prefill_chunk_batch(tparams, seq[None], cache, [0],
                                           [0], chunk_lens=[n])
        top = torch.topk(logits[0], 2).values
        gaps.append(float(top[0] - top[1]))
    return gaps


@pytest.mark.parametrize("strategies", [("dequant", "dequant")],
                         indirect=True, ids=["dequant"])
@pytest.mark.parametrize("kv", ["float32", "int8"])
@pytest.mark.parametrize("traffic", list(TRAFFIC))
def test_engine_matches_jax_engine(traffic, kv, strategies):
    check_engine_parity(traffic, kv, strategies)


@pytest.mark.parametrize("strategies", [("dequant", "dequant")],
                         indirect=True, ids=["dequant"])
@pytest.mark.parametrize("traffic", ["preempted", "prefix_warm"])
def test_engine_knobs_match_jax_engine(traffic, strategies):
    """``prefix_caching=False`` and ``preempt_limit=1`` reach both
    engines' allocator and scheduler: the same streams and plan logs, and
    no prefix hit even for the wave that shares a cached prefix."""
    check_engine_parity(traffic, "float32", strategies,
                        dict(prefix_caching=False, preempt_limit=1,
                             nan_guard=False))


def test_engine_arguments_follow_the_reference_order():
    """The constructor arguments the port shares with the reference come
    in the reference's order (``seed`` 6th), the C1 knobs among them."""
    ours = list(inspect.signature(Engine).parameters)
    theirs = list(inspect.signature(JaxEngine).parameters)
    shared = [a for a in ours if a in theirs]
    assert shared == [a for a in theirs if a in ours]
    assert ours.index("seed") == theirs.index("seed") == 5
    for knob in ("prefix_caching", "preempt_limit", "nan_guard"):
        assert knob in shared, knob


@pytest.mark.parametrize("name", ["deadline_ms", "ttft_deadline_ms"])
def test_submit_with_a_deadline_is_enforced(name):
    """A deadline is charged from arrival on the engine's clock: a request
    whose budget has passed before its first step fails with the typed
    deadline error, counted in ``deadline_misses``, and the request beside
    it is served."""
    tm = build_model(tconfigs.reduced(tconfigs.get_config("llama2-110m")))
    clock = SimClock(start=1.0)
    eng = Engine(tm, tm.init(0, device="cpu"), **ENGINE, clock=clock,
                 device="cpu")
    late = eng.submit(np.arange(4, 9, dtype=np.int32), max_new_tokens=3,
                      **{name: 100.0})
    eng.submit(np.arange(4, 11, dtype=np.int32), max_new_tokens=3,
               temperature=0.0)
    clock.advance_ms(150.0)
    done = {r.uid: r for r in eng.run()}
    assert done[late].error_kind == ERR_DEADLINE
    assert done[late].t_done == clock.now() and done[late].output == []
    assert [r.error for u, r in done.items() if u != late] == [None]
    assert eng.metrics["deadline_misses"] == 1
    assert all(rc == 0 for rc in eng.pager.refcount)


@pytest.mark.parametrize("nan_guard", [True, False])
def test_nan_guard_fails_only_the_request_with_non_finite_logits(
        nan_guard, monkeypatch):
    """Decode logits of slot 0 made NaN: with ``nan_guard`` its request
    fails with the typed NaN error and the other completes; without it
    both complete."""
    tm = build_model(tconfigs.reduced(tconfigs.get_config("llama2-110m")))
    eng = Engine(tm, tm.init(0, device="cpu"), **ENGINE, nan_guard=nan_guard,
                 device="cpu")
    step = Model.decode_step

    def poisoned(self, params, cache, tokens, positions=None, mesh=None):
        logits, cache = step(self, params, cache, tokens, positions, mesh)
        logits = logits.clone()
        logits[0] = float("nan")
        return logits, cache

    monkeypatch.setattr(Model, "decode_step", poisoned)
    for n in (5, 7):
        eng.submit(np.arange(4, 4 + n, dtype=np.int32), max_new_tokens=3,
                   temperature=0.0)
    done = sorted(eng.run(), key=lambda r: r.uid)
    kinds = [r.error_kind for r in done]
    assert kinds == ([ERR_NAN, None] if nan_guard else [None, None])
    assert eng.metrics["nan_rows"] == (1 if nan_guard else 0)
    assert [len(r.output) for r in done[1:]] == [3]


def check_engine_parity(traffic: str, kv: str, tol: float,
                        knobs: dict = None) -> None:
    """Serve ``traffic`` through both engines under the strategies the
    ``strategies`` fixture pinned, with ``knobs`` passed to both engines;
    compare plan logs and streams."""
    port_s = tqlinear.default_strategy()
    tag = f"llama2-110m-torch-parity-engine-{port_s}-{kv}"
    jcfg = reduced(get_config("llama2-110m")).with_(arch_id=tag,
                                                    kv_cache_dtype=kv)
    tcfg = tconfigs.reduced(tconfigs.get_config("llama2-110m")).with_(
        arch_id=tag, kv_cache_dtype=kv)
    jm = jax_build_model(jcfg)
    jparams = jm.quantize(jm.init(jax.random.PRNGKey(0)))
    tm = build_model(tcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    _, overrides, _ = TRAFFIC[traffic]
    overrides = dict(overrides, **(knobs or {}))
    waves = _prompts(traffic, seed=1)
    want, want_log = _serve(JaxEngine(jm, jparams, **ENGINE, **overrides),
                            waves)
    eng = Engine(tm, tparams, **ENGINE, **overrides, device="cpu")
    got, got_log = _serve(eng, waves)

    assert got_log == want_log
    if traffic == "preempted":
        assert any(p["preempted"] for p in got_log)
    if traffic == "prefix_warm":
        hits = len(waves[1]) if overrides.get("prefix_caching", True) else 0
        assert eng.metrics["prefix_hits"] == hits
    prompts = [p for wave in waves for p in wave]
    for prompt, g, w in zip(prompts, got, want):
        gaps = _top2_gaps(tm, tparams, prompt, w)
        if port_s == "dequant":
            assert min(gaps) > 10 * tol, gaps        # no near-tie anywhere
            assert g == w
        else:
            part = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b),
                        None)
            assert part is None or gaps[part] < tol, (part, gaps)
