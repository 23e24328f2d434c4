"""The port's open-loop front end against the JAX package's, on the CPU.

``repro_torch.serving.async_serving`` over ``Engine.step_async`` /
``finish_step``, held to the reference module on the same bridged weights,
with both engines pinned to one qlinear strategy (the ``strategies``
fixture of test_torch_engine.py), at the sizes of the reference's own
tests (reduced llama2-110m, 3 slots, pages of 4, chunks of 8):

  * open-loop streams, released by a simulated clock, equal the port's
    closed ``run()`` streams and the JAX engine's open-loop streams
    bitwise, greedy and sampled (against JAX under ``dequant``, where
    sampled streams match; ROADMAP C);
  * deadlines charged from true arrival, the backpressure shed and the
    preemption-thrash shed fail the same uids with the same
    ``error_kind`` as the JAX engine;
  * every token is streamed exactly once and in order, per sibling;
  * the step guard, ``finish_step``'s idempotence and the stall error;
  * the latency helpers and ``poisson_arrivals`` give the reference's
    values.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import build_model as jax_build_model
from repro.serving import async_serving as jas
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax
from repro_torch.core import qlinear as tqlinear
from repro_torch.models.model import build_model
from repro_torch.serving import async_serving as tas
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.faults import (ERR_DEADLINE, ERR_SHED,
                                        SchedulerStall, SimClock)
from repro_torch.serving.scheduler import StepPlan

from test_torch_engine import TRAFFIC
from test_torch_engine import _prompts as engine_prompts
from test_torch_engine import strategies  # noqa: F401  (the fixture)

torch.set_num_threads(2)

TAG = "llama2-110m-torch-async"
ENGINE = dict(max_slots=3, max_seq=64, page_size=4, n_pages=32,
              prefill_chunk_tokens=8)
DEQUANT = [pytest.param(("dequant", "dequant"), id="dequant")]


@pytest.fixture(scope="module")
def models():
    """(JAX model, its Q8_0 params, port model, the bridged params)."""
    jm = jax_build_model(reduced(get_config("llama2-110m")).with_(
        arch_id=TAG))
    jparams = jm.quantize(jm.init(jax.random.PRNGKey(0)))
    tm = build_model(tconfigs.reduced(tconfigs.get_config(
        "llama2-110m")).with_(arch_id=TAG))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return jm, jparams, tm, tparams


class TickClock(SimClock):
    """A simulated clock that moves 1 ms each time it is read, so arrivals
    are released between and inside steps, deterministically."""

    def now(self) -> float:
        self._t += 1e-3
        return self._t


def _port(models, **kw):
    _, _, tm, tparams = models
    return Engine(tm, tparams, **dict(ENGINE, **kw), device="cpu")


def _jax(models, **kw):
    jm, jparams, _, _ = models
    return JaxEngine(jm, jparams, **dict(ENGINE, **kw))


def _prompts(seed, n, lo=4, hi=12):
    rng = np.random.default_rng(seed)
    return [rng.integers(4, 500, size=int(rng.integers(lo, hi)))
            .astype(np.int32) for _ in range(n)]


def _streams(req):
    outs = req.outputs if req.outputs is not None else [req.output or []]
    return tuple(tuple(o) for o in outs)


def _workload(sampled, n=6, rate=200.0):
    prompts = _prompts(12, n)
    kws = [dict(max_new_tokens=4 + i % 3, seed=100 + i,
                temperature=0.8 if sampled and i % 2 == 0 else 0.0,
                top_p=0.95 if sampled else 1.0) for i in range(n)]
    offsets = tas.poisson_arrivals(seed=12, n=n, rate_per_s=rate)
    return [(float(t), p, kw) for t, p, kw in zip(offsets, prompts, kws)]


# -- the acceptance bar: open loop == closed loop == the JAX engine's --------
@pytest.mark.parametrize("strategies", [("dequant", "dequant"),
                                        ("integer", "kernel")],
                         indirect=True, ids=["dequant", "integer"])
@pytest.mark.parametrize("sampled", [False, True],
                         ids=["greedy", "sampled"])
def test_open_loop_streams_equal_closed_and_the_jax_engine(
        models, strategies, sampled):
    workload = _workload(sampled)
    closed = _port(models)
    for _, p, kw in workload:
        closed.submit(p, **kw)
    want = [_streams(r) for r in sorted(closed.run(), key=lambda r: r.uid)]
    compiles = closed.prefill_compile_count()

    eng = _port(models, clock=TickClock())
    handles, report = tas.run_open_loop(eng, workload)
    got = [_streams(h.req) for h in handles]
    assert got == want, "open-loop streams parted from the closed run"
    assert report.midflight_submits > 0, "no arrival landed mid-flight"
    assert report.completed_ok == len(workload) and report.failed == 0
    assert report.neg_latency_samples == 0 and report.goodput_tok_s > 0
    assert all(rc == 0 for rc in eng.pager.refcount)
    assert eng.prefill_compile_count() == compiles
    if tqlinear.default_strategy() == "dequant":
        # the JAX engine's open loop on the same weights (dequant only:
        # under integer arithmetic streams part at near-ties, ROADMAP C)
        jhandles, jreport = jas.run_open_loop(
            _jax(models, clock=TickClock()), workload)
        assert [_streams(h.req) for h in jhandles] == got
        assert jreport.completed_ok == report.completed_ok


@pytest.mark.parametrize("strategies", DEQUANT, indirect=True)
def test_submit_inside_the_overlap_window_keeps_streams(models, strategies):
    """Requests submitted while a decode is in flight (between
    ``step_async`` and ``finish_step``) serve bitwise as the same arrival
    order submitted up front, with no leaked block."""
    prompts = _prompts(3, 5)
    kws = [dict(max_new_tokens=4 + i % 3, seed=50 + i,
                temperature=0.0 if i % 2 else 0.8, top_p=0.95)
           for i in range(len(prompts))]
    eng1 = _port(models)
    for p, kw in zip(prompts, kws):
        eng1.submit(p, **kw)
    want = {r.uid: _streams(r) for r in eng1.run()}

    eng2 = _port(models)
    for p, kw in zip(prompts[:2], kws[:2]):
        eng2.submit(p, **kw)
    done, nxt, in_flight = [], 2, 0
    while eng2.scheduler.has_work() or eng2._pending is not None:
        out, pending = eng2.step_async()
        done.extend(out or [])
        if nxt < len(prompts):
            in_flight += pending is not None
            eng2.submit(prompts[nxt], **kws[nxt])
            nxt += 1
        done.extend(eng2.finish_step(pending))
    assert nxt == len(prompts) and in_flight > 0
    assert {r.uid: _streams(r) for r in done} == want
    assert all(rc == 0 for rc in eng2.pager.refcount)


def test_step_guard_and_finish_idempotence(models):
    eng = _port(models)
    assert eng.finish_step() == []            # nothing pending: no-op
    eng.submit(_prompts(4, 1)[0], max_new_tokens=4, seed=1)
    pending = None
    while pending is None and eng.scheduler.has_work():
        _, pending = eng.step_async()
    assert pending is not None and eng._pending is pending
    with pytest.raises(RuntimeError, match="finish_step"):
        eng.step()
    with pytest.raises(RuntimeError, match="finish_step"):
        eng.step_async()
    steps = eng.metrics["decode_steps"]
    eng.finish_step(pending)
    assert eng._pending is None
    assert eng.finish_step() == [] and eng.metrics["decode_steps"] == steps
    done = eng.run()
    assert [r.error for r in done] == [None]


def test_rejected_request_drains_through_step(models):
    eng = _port(models)
    uid = eng.submit(np.zeros(0, np.int32), max_new_tokens=4)
    out, pending = eng.step_async()
    assert [r.uid for r in out] == [uid] and pending is None
    assert out[0].error is not None
    assert eng.step() is None                 # idle now


def test_an_idle_plan_with_work_raises_the_stall_as_the_reference(
        models, monkeypatch):
    """With work pending and a plan that does nothing, both engines raise
    ``SchedulerStall`` (a RuntimeError) with the same message and queue
    snapshot."""
    raised = []
    for eng in (_port(models), _jax(models)):
        for p in _prompts(5, 2):
            eng.submit(p, max_new_tokens=3)
        monkeypatch.setattr(eng.scheduler, "schedule", lambda: StepPlan())
        with pytest.raises(RuntimeError, match="no progress") as exc:
            eng.step()
        raised.append(exc.value)
    assert isinstance(raised[0], SchedulerStall)
    assert str(raised[0]) == str(raised[1])
    assert raised[0].snapshot == raised[1].snapshot
    assert raised[0].snapshot["waiting"] == [1, 2]


# -- streaming ---------------------------------------------------------------
@pytest.mark.parametrize("interval", [1, 3])
def test_callbacks_deliver_every_token_once_in_order(models, interval):
    server = tas.AsyncServer(_port(models), stream_interval_steps=interval)
    got, finals = {}, {}

    def on_token(handle, sibling, tokens, done):
        got.setdefault(handle.uid, {}).setdefault(sibling, []).extend(tokens)
        if done:
            finals[handle.uid] = finals.get(handle.uid, 0) + 1

    handles = [server.submit(p, on_token=on_token, max_new_tokens=5,
                             seed=60 + i, temperature=0.8 * (i % 2))
               for i, p in enumerate(_prompts(5, 4))]
    while server.has_work():
        server.step()
    for h in handles:
        assert h.done and finals.get(h.uid) == 1
        for s, stream in enumerate(_streams(h.req)):
            assert tuple(got[h.uid].get(s, [])) == stream


@pytest.mark.parametrize("interval", [1, 3])
def test_fanout_siblings_stream_separately(models, interval):
    server = tas.AsyncServer(_port(models), stream_interval_steps=interval)
    h = server.submit(_prompts(6, 1)[0], max_new_tokens=4, n_samples=2,
                      seed=7, temperature=1.0)
    while server.has_work():
        server.step()
    assert h.req.outputs is not None and len(h.req.outputs) == 2
    by_sib = {}
    for s, t in h.buffer:
        by_sib.setdefault(s, []).append(t)
    for s, stream in enumerate(_streams(h.req)):
        assert tuple(by_sib.get(s, [])) == stream


def test_generator_pumps_the_engine(models):
    """The generator steps the engine itself; the other request on the
    same pump completes too."""
    server = tas.AsyncServer(_port(models))
    prompts = _prompts(7, 2)
    h0 = server.submit(prompts[0], max_new_tokens=5, seed=70)
    h1 = server.submit(prompts[1], max_new_tokens=3, seed=71)
    toks = [t for _, t in server.stream(h0)]
    assert tuple(toks) == _streams(h0.req)[0]
    while server.has_work():
        server.step()
    assert h1.done and h1.req.error is None


# -- deadlines and shedding, against the JAX engine --------------------------
def _drive(server, clock, ms_per_step):
    while server.has_work():
        server.step()
        clock.advance_ms(ms_per_step)


def _outcome(handles):
    return [(h.req.uid, h.error_kind, _streams(h.req)) for h in handles]


@pytest.mark.parametrize("strategies", DEQUANT, indirect=True)
def test_deadline_is_charged_from_true_arrival(models, strategies):
    """A request that queued past its deadline before release fails at
    once; one released on time is served."""
    outcomes = []
    for make, pkg in ((_port, tas), (_jax, jas)):
        clock = SimClock(start=10.0)
        eng = make(models, clock=clock)
        server = pkg.AsyncServer(eng)
        stale = server.submit(_prompts(9, 1)[0], max_new_tokens=4,
                              t_arrival=0.0, deadline_ms=1_000.0)
        fresh = server.submit(_prompts(10, 1)[0], max_new_tokens=4,
                              seed=90, deadline_ms=60_000.0)
        _drive(server, clock, 0.0)
        outcomes.append((_outcome([stale, fresh]),
                         eng.metrics["deadline_misses"]))
    assert outcomes[0] == outcomes[1]
    (stale, fresh), misses = outcomes[0]
    assert stale[1] == ERR_DEADLINE and fresh[1] is None and misses == 1


@pytest.mark.parametrize("strategies", DEQUANT, indirect=True)
def test_ttft_deadlines_in_flight_fail_the_same_requests(models, strategies):
    """Five requests on three slots, the clock 10 ms a step: the queued
    requests' 25 ms first-token budget runs out behind the others'
    prefills, in both engines at the same step."""
    outcomes = []
    for make, pkg in ((_port, tas), (_jax, jas)):
        clock = SimClock()
        eng = make(models, clock=clock)
        server = pkg.AsyncServer(eng)
        handles = [server.submit(p, max_new_tokens=6, seed=20 + i,
                                 temperature=0.0,
                                 ttft_deadline_ms=25.0 if i >= 2 else None)
                   for i, p in enumerate(_prompts(21, 5, lo=9, hi=12))]
        _drive(server, clock, 10.0)
        outcomes.append((_outcome(handles), eng.metrics["deadline_misses"],
                         eng.plan_log))
    assert outcomes[0] == outcomes[1]
    kinds = [k for _, k, _ in outcomes[0][0]]
    assert ERR_DEADLINE in kinds and None in kinds


@pytest.mark.parametrize("strategies", DEQUANT, indirect=True)
def test_backpressure_sheds_the_same_requests(models, strategies):
    outcomes = []
    for make, pkg in ((_port, tas), (_jax, jas)):
        eng = make(models)
        server = pkg.AsyncServer(eng, max_queue_depth=2)
        handles = [server.submit(p, max_new_tokens=3, seed=95 + i,
                                 temperature=0.0)
                   for i, p in enumerate(_prompts(11, 6))]
        shed = [h for h in handles if h.error_kind == ERR_SHED]
        assert shed and all(h.done for h in shed)
        while server.has_work():
            server.step()
        outcomes.append((_outcome(handles), eng.metrics["shed_requests"],
                         server.peak_queue_depth))
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][1] == sum(k == ERR_SHED for _, k, _ in outcomes[0][0])


@pytest.mark.parametrize("strategies", DEQUANT, indirect=True)
def test_preemption_thrash_sheds_as_the_reference(models, strategies):
    """``shed_after_preempts=1`` on a pool that must preempt: the first
    preempting step sheds the lowest-value waiter, in both engines."""
    lens_kw = dict(max_slots=2, page_size=8,
                   **TRAFFIC["preempted"][1], shed_after_preempts=1)
    prompts, _ = engine_prompts("preempted", seed=1)
    outcomes = []
    for make in (_port, _jax):
        eng = make(models, **lens_kw)
        for p in prompts:
            eng.submit(p, max_new_tokens=6, temperature=0.0)
        done = sorted(eng.run(), key=lambda r: r.uid)
        outcomes.append(([(r.uid, r.error_kind, _streams(r)) for r in done],
                         eng.metrics["shed_requests"], eng.plan_log))
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][1] >= 1
    assert ERR_SHED in [k for _, k, _ in outcomes[0][0]]


# -- the latency helpers and the arrival process -----------------------------
def _fields(seed, n=12):
    """Request timing fields: some never got a first token (rejected or
    failed early), some errored after it, some emitted a single token."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        t_enq = float(rng.uniform(0, 5))
        first = 0.0 if i % 5 == 0 else t_enq + float(rng.uniform(0, 0.3))
        done = max(first, t_enq) + float(rng.uniform(0, 2))
        toks = [int(t) for t in rng.integers(0, 99, size=int(
            rng.integers(1, 9)))]
        err = "x" if i % 7 == 3 else None
        out.append(dict(t_enqueue=t_enq, t_first_token=first, t_done=done,
                        output=toks, error=err))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_latency_helpers_give_the_reference_values(seed):
    fields = _fields(seed)
    ours = [Request(uid=i, prompt=np.zeros(1, np.int32), **f)
            for i, f in enumerate(fields)]
    theirs = [JaxRequest(uid=i, prompt=np.zeros(1, np.int32), **f)
              for i, f in enumerate(fields)]
    for name in ("first_token_latencies", "time_per_output_token"):
        got, want = getattr(tas, name)(ours), getattr(jas, name)(theirs)
        assert got.dtype == want.dtype and np.array_equal(got, want), name
        assert (tas.latency_summary_ms(got)
                == jas.latency_summary_ms(want)), name
    assert (tas.negative_latency_samples(ours)
            == jas.negative_latency_samples(theirs) == 0)
    assert tas.latency_summary_ms(np.zeros(0)) == jas.latency_summary_ms(
        np.zeros(0))


@pytest.mark.parametrize("seed,n,rate", [(0, 16, 50.0), (12, 6, 200.0),
                                         (7, 100, 3.5)])
def test_poisson_arrivals_equal_the_reference(seed, n, rate):
    got = tas.poisson_arrivals(seed, n, rate)
    want = jas.poisson_arrivals(seed, n, rate)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    with pytest.raises(ValueError, match="positive"):
        tas.poisson_arrivals(seed, n, 0.0)


def test_ttft_filter_excludes_requests_without_a_first_token(models):
    """A rejected request keeps ``t_first_token == 0.0``; with a nonzero
    clock its unfiltered latency is hugely negative, and the helpers
    exclude it."""
    clock = SimClock(start=5.0)
    server = tas.AsyncServer(_port(models, clock=clock))
    valid = [server.submit(p, max_new_tokens=4, seed=80 + i)
             for i, p in enumerate(_prompts(8, 3))]
    invalid = server.submit(np.zeros(0, np.int32), max_new_tokens=4)
    _drive(server, clock, 5.0)
    reqs = [h.req for h in valid + [invalid]]
    assert invalid.req.error is not None
    assert invalid.req.t_first_token == 0.0
    assert min(r.t_first_token - r.t_enqueue for r in reqs) < -1.0
    lat = tas.first_token_latencies(reqs)
    assert len(lat) == len(valid) and np.all(lat >= 0.0)
    assert tas.negative_latency_samples(reqs) == 0
    assert np.all(tas.time_per_output_token(reqs) >= 0.0)


def test_legacy_chunk_shape_keys_equal_the_reference(models):
    """The counterfactual per-shape chunk keys of a churning open-loop
    trace: the port's helper gives the reference's set, larger than the
    one padded shape the chunk step ran with."""
    from repro.serving.engine import legacy_chunk_shape_keys as jkeys
    from repro_torch.serving.engine import legacy_chunk_shape_keys
    eng = _port(models, clock=TickClock())
    tas.run_open_loop(eng, _workload(False, n=8, rate=500.0))
    keys = legacy_chunk_shape_keys(eng.plan_log)
    assert keys == jkeys(eng.plan_log)
    assert len(keys) > 1 and eng.metrics["prefill_compiles"] >= 1
