"""The port's fault domain against the JAX package's, on the CPU.

The same ``FaultPlan`` drives the port's and the JAX engine over the same
traffic and bridged weights, at the sizes of the reference's own tests
(tests/test_faults.py: reduced llama2-110m with f32 weights, 4 slots, pages
of 8, chunks of 16, four seeded requests sampled at temperature 1.0): the
engines must give the same ``fault_log``, injector log, ``error_kind`` s,
fault counters and surviving streams, and the survivors must equal the
port's fault-free run bitwise.  Covered: an empty plan, transient and
persistent step faults (decode and prefill), NaN rows (one request, a
sampling group failing as a unit, a verify row under speculation),
allocator corruption repaired by the audit (refcount, free_dup, index,
untargeted), injected stalls shedding the newest waiter, clock-driven
deadlines, latency faults counted as slow steps, and
``StragglerDetector``.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import build_model as jax_build_model
from repro.runtime.health import StragglerDetector as JaxStraggler
from repro.serving import faults as jfaults
from repro.serving.engine import Engine as JaxEngine
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax
from repro_torch.kernels import build
from repro_torch.models.model import build_model
from repro_torch.runtime.health import StragglerDetector
from repro_torch.serving import faults as tfaults
from repro_torch.serving.engine import Engine
from repro_torch.serving.faults import (ERR_AUDIT, ERR_FAULT, ERR_NAN,
                                        ERR_SHED, FaultInjector, FaultPlan,
                                        InjectedFault, SchedulerStall,
                                        SimClock)
from repro_torch.serving.scheduler import StepPlan

torch.set_num_threads(2)

TAG = "llama2-110m-torch-faults"
ENGINE = dict(max_slots=4, max_seq=64, page_size=8, prefill_chunk_tokens=16)
PROMPT_SIZES = (6, 11, 9, 14)
COUNTERS = ("step_retries", "requests_failed", "requests_rejected",
            "nan_rows", "deadline_misses", "shed_requests", "stalls",
            "audit_repairs", "audit_violations", "slow_steps", "tokens_out",
            "decode_steps", "chunk_batch_calls")


@pytest.fixture(scope="module")
def models():
    """(JAX model, its f32 params, port model, the bridged params)."""
    jm = jax_build_model(reduced(get_config("llama2-110m")).with_(
        arch_id=TAG))
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tconfigs.reduced(tconfigs.get_config(
        "llama2-110m")).with_(arch_id=TAG))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    build.reset_launches()
    yield jm, jparams, tm, tparams
    assert all(v == 0 for v in build.LAUNCHES.values())


def _prompts(seed=0, sizes=PROMPT_SIZES):
    rng = np.random.default_rng(seed)
    return [rng.integers(4, 500, size=n).astype(np.int32) for n in sizes]


def _serve(eng, prompts=None, deadlines=None, n_samples=None, max_new=8):
    """Submit ``prompts`` (uid i+1 sampled with seed 100+i) and drain;
    returns {uid: request}."""
    prompts = _prompts() if prompts is None else prompts
    for i, p in enumerate(prompts):
        eng.submit(p, max_new_tokens=max_new, temperature=1.0, seed=100 + i,
                   deadline_ms=(deadlines or {}).get(i + 1),
                   n_samples=(n_samples or {}).get(i + 1, 1))
    return {r.uid: r for r in eng.run()}


def _both(models, build_plan=None, prompts=None, deadlines=None,
          n_samples=None, max_new=8, **kw):
    """Serve the same traffic under the same plan on both engines; assert
    the engines agree and return the port's (engine, {uid: request})."""
    jm, jparams, tm, tparams = models
    runs = []
    for mod, make in ((jfaults, lambda **a: JaxEngine(jm, jparams, **a)),
                      (tfaults, lambda **a: Engine(tm, tparams,
                                                   device="cpu", **a))):
        # every run, the fault-free one too, reads a simulated clock: on the
        # wall clock a step that the machine's load slows is counted in
        # ``slow_steps`` by one engine and not by the other
        extra = dict(kw, clock=mod.SimClock())
        if build_plan is not None:
            extra.update(faults=build_plan(mod.FaultPlan))
        eng = make(**ENGINE, **extra)
        runs.append((eng, _serve(eng, prompts, deadlines, n_samples,
                                 max_new)))
    (jeng, jby), (eng, by) = runs
    assert {u: (r.outputs, r.error, r.error_kind) for u, r in by.items()} \
        == {u: (r.outputs, r.error, r.error_kind) for u, r in jby.items()}
    assert eng.fault_log == jeng.fault_log
    if build_plan is not None:
        assert eng.faults.log == jeng.faults.log
    assert {c: eng.metrics[c] for c in COUNTERS} \
        == {c: jeng.metrics[c] for c in COUNTERS}
    assert eng.plan_log == jeng.plan_log
    eng.pager.debug_check()
    assert all(rc == 0 for rc in eng.pager.refcount)
    return eng, by


@pytest.fixture(scope="module")
def baseline(models):
    """The port's fault-free streams, equal to the JAX engine's."""
    _, by = _both(models)
    assert all(r.error is None for r in by.values())
    return {u: r.output for u, r in by.items()}


def _survivors_equal(by, baseline, failed):
    assert {u: r.output for u, r in by.items() if u not in failed} \
        == {u: o for u, o in baseline.items() if u not in failed}
    assert all(r.error is None for u, r in by.items() if u not in failed)


# -- determinism and the empty plan ---------------------------------------


def test_empty_plan_is_bitwise_no_fault_layer(models, baseline):
    """Injector, simulated clock and an audit every step, with nothing
    planned: the streams are the fault-free ones, nothing is logged."""
    eng, by = _both(models, lambda P: P(), audit_interval=1)
    assert {u: r.output for u, r in by.items()} == baseline
    assert eng.fault_log == [] and eng.faults.log == []
    assert eng.metrics["requests_failed"] == 0
    assert eng.metrics["audit_repairs"] == 0


def test_a_plan_replays_identically(models):
    plan = (lambda P: P(seed=7).step_exception(step=2, times=1)
            .nan_logits(step=5, uid=3).corrupt_pages(step=6, uid=1))
    runs = []
    for _ in range(2):
        eng, by = _both(models, plan, audit_interval=1)
        runs.append(({u: (r.output, r.error_kind) for u, r in by.items()},
                     eng.faults.log, eng.fault_log))
    assert runs[0] == runs[1]
    kinds = {e["kind"] for e in runs[0][2]}
    assert {"retry", "nan", "audit"} <= kinds, kinds


# -- step faults: a transient one is retried, a persistent one isolated --------


def test_transient_step_fault_is_retried_bitwise(models, baseline):
    eng, by = _both(models, lambda P: P().step_exception(step=2, times=1))
    assert eng.metrics["step_retries"] == 1
    assert eng.metrics["requests_failed"] == 0
    assert {u: r.output for u, r in by.items()} == baseline


@pytest.mark.parametrize("site,step,uid", [("decode", 3, 2),
                                           ("prefill", 1, 3),
                                           ("decode", 6, 4)])
def test_persistent_fault_isolates_only_its_request(models, baseline, site,
                                                    step, uid):
    eng, by = _both(models, lambda P: P().step_exception(
        step=step, uid=uid, site=site, times=10**6))
    assert by[uid].error_kind == ERR_FAULT
    assert f"persistent {site}-step fault" in by[uid].error
    assert eng.metrics["step_retries"] == eng.retry_limit + 1
    assert [e["kind"] for e in eng.fault_log][-1] == "isolated"
    _survivors_equal(by, baseline, {uid})


def test_retry_limit_reaches_the_gate(models, baseline):
    """``retry_limit=0``: the first fire already isolates the request."""
    eng, by = _both(models, lambda P: P().step_exception(
        step=3, uid=1, times=10**6), retry_limit=0)
    assert by[1].error_kind == ERR_FAULT
    assert eng.metrics["step_retries"] == 1
    _survivors_equal(by, baseline, {1})


def test_untargeted_persistent_fault_propagates(models):
    """No uid to isolate: after the retries the fault leaves ``run()``."""
    _, _, tm, tparams = models
    eng = Engine(tm, tparams, **ENGINE, device="cpu", clock=SimClock(),
                 faults=FaultPlan().step_exception(step=2, times=10**6))
    eng.submit(_prompts()[0], max_new_tokens=8, temperature=0.0)
    with pytest.raises(InjectedFault):
        eng.run()
    assert eng.metrics["step_retries"] == eng.retry_limit + 1


# -- NaN rows -----------------------------------------------------------------


@pytest.mark.parametrize("site,step,uid", [("decode", 4, 3),
                                           ("prefill", 1, 2)])
def test_nan_row_fails_only_that_request(models, baseline, site, step, uid):
    eng, by = _both(models, lambda P: P().nan_logits(step=step, uid=uid,
                                                     site=site))
    assert by[uid].error_kind == ERR_NAN and site in by[uid].error
    assert eng.metrics["nan_rows"] == 1
    _survivors_equal(by, baseline, {uid})
    assert eng.pager.n_free() == eng.pager.cfg.n_blocks


def test_nan_fails_a_sampling_group_as_a_unit(models):
    eng, by = _both(models, lambda P: P().nan_logits(step=5, uid=1),
                    prompts=_prompts(sizes=(9, 11)), n_samples={1: 3})
    assert by[1].error_kind == ERR_NAN
    assert by[2].error is None and by[2].output
    assert eng.metrics["nan_rows"] == 1


def test_nan_quarantine_keeps_poisoned_blocks_out_of_the_index(models):
    """A NaN-failed sequence's own blocks never reach the prefix index: the
    same prompt submitted again finds no cached prefix."""
    _, _, tm, tparams = models
    prompt = _prompts(sizes=(24,))[0]          # three full pages
    eng = Engine(tm, tparams, **ENGINE, device="cpu", clock=SimClock(),
                 faults=FaultPlan().nan_logits(step=4, uid=1))
    eng.submit(prompt, max_new_tokens=8, temperature=0.0)
    (r,) = eng.run()
    assert r.error_kind == ERR_NAN
    hits = eng.scheduler.prefix_stats["hits"]
    eng.submit(prompt, max_new_tokens=4, temperature=0.0)
    (r2,) = eng.run()
    assert r2.error is None
    assert eng.scheduler.prefix_stats["hits"] == hits


def test_nan_under_speculation_hits_a_verify_row(models):
    """Greedy, speculating 3 tokens on repetitive prompts: the NaN lands
    on a verify row, fails its request, and the other streams are the
    fault-free speculative ones (and the JAX engine's)."""
    rep = [np.tile(np.asarray([7, 11, 13, 17], np.int32), 4),
           np.tile(np.asarray([23, 29, 31], np.int32), 5)]
    jm, jparams, tm, tparams = models
    kw = dict(ENGINE, spec_tokens=3)
    clean = Engine(tm, tparams, **kw, device="cpu")
    for p in rep:
        clean.submit(p, max_new_tokens=12, temperature=0.0)
    clean_out = {r.uid: r.output for r in clean.run()}
    step = next(i + 1 for i, p in enumerate(clean.plan_log)
                if any(u == 1 for u, _, _ in p["verifies"]))
    outs = []
    for mod, make in ((jfaults, lambda **a: JaxEngine(jm, jparams, **a)),
                      (tfaults, lambda **a: Engine(tm, tparams,
                                                   device="cpu", **a))):
        eng = make(**kw, clock=mod.SimClock(),
                   faults=mod.FaultPlan().nan_logits(step=step, uid=1))
        for p in rep:
            eng.submit(p, max_new_tokens=12, temperature=0.0)
        by = {r.uid: r for r in eng.run()}
        outs.append(({u: (r.output, r.error_kind) for u, r in by.items()},
                     eng.fault_log, eng.faults.log))
    assert outs[0] == outs[1]
    by, log, _ = outs[1]
    assert by[1][1] == ERR_NAN and by[2] == (clean_out[2], None)
    assert log == [{"step": step, "kind": "nan", "site": "decode",
                    "uid": 1}]


# -- allocator corruption and the audit -------------------------------------


@pytest.mark.parametrize("flavor", ["refcount", "free_dup"])
def test_audit_repairs_corruption_failing_only_the_leaseholder(
        models, baseline, flavor):
    eng, by = _both(models, lambda P: P().corrupt_pages(step=3, uid=1,
                                                        flavor=flavor),
                    audit_interval=1)
    assert by[1].error_kind == ERR_AUDIT
    assert eng.metrics["audit_repairs"] == 1
    assert eng.metrics["audit_violations"] >= 1
    _survivors_equal(by, baseline, {1})
    assert eng.pager.n_free() == eng.pager.cfg.n_blocks


def test_index_corruption_repairs_without_failing_anyone(models, baseline):
    eng, by = _both(models, lambda P: P().corrupt_pages(step=4,
                                                        flavor="index"),
                    audit_interval=1)
    assert {u: r.output for u, r in by.items()} == baseline
    assert eng.metrics["requests_failed"] == 0
    assert eng.metrics["audit_repairs"] == 1


@pytest.mark.parametrize("seed", [0, 3])
def test_untargeted_corruption_draws_the_reference_block(models, seed):
    """No uid: the injector's seeded rng picks the block, the same one in
    both packages, and the audit fails whoever leased it."""
    eng, by = _both(models, lambda P: P(seed=seed).corrupt_pages(step=4),
                    audit_interval=2)
    assert eng.metrics["audit_repairs"] == 1
    (corrupt,) = [e for e in eng.faults.log if e["kind"] == "corrupt"]
    assert corrupt["block"] is not None


# -- stalls and deadlines ------------------------------------------------------


def test_injected_stall_sheds_the_newest_waiter(models, baseline):
    eng, by = _both(models, lambda P: P().stall(step=1, times=2))
    shed = sorted(u for u, r in by.items() if r.error_kind == ERR_SHED)
    assert shed == [3, 4]
    assert eng.metrics["stalls"] == 2 and eng.metrics["shed_requests"] == 2
    _survivors_equal(by, baseline, set(shed))


def test_a_stall_with_nothing_to_shed_raises_after_the_limit(models):
    _, _, tm, tparams = models
    eng = Engine(tm, tparams, max_slots=2, max_seq=64, page_size=8,
                 device="cpu", faults=FaultPlan(), clock=SimClock(),
                 stall_shed_limit=2)
    eng.submit(_prompts()[0], max_new_tokens=4, temperature=0.0)
    eng.scheduler.schedule = lambda: StepPlan()
    eng.scheduler.shed_load = lambda k=1: []
    with pytest.raises(SchedulerStall):
        eng.run()
    assert eng.metrics["stalls"] == eng.stall_shed_limit + 1
    assert [e["kind"] for e in eng.fault_log] == ["stall"] * 3


def test_clock_fault_expires_only_the_late_request(models, baseline):
    eng, by = _both(models, lambda P: P().advance_clock(step=5, ms=500.0),
                    deadlines={2: 100.0, 1: 1e4, 3: 1e4, 4: 1e4})
    assert by[2].error_kind == "deadline"
    assert eng.metrics["deadline_misses"] == 1
    assert {"step": 5, "kind": "deadline", "uid": 2, "budget": "total"} \
        in eng.fault_log
    _survivors_equal(by, baseline, {2})


# -- stragglers -------------------------------------------------------------


def test_latency_faults_count_slow_steps(models):
    """A steady 10 ms decode warms the rolling median, then one 200 ms
    step is flagged, on both engines alike."""
    eng, by = _both(
        models, lambda P: (P().advance_clock(step=1, ms=10.0, site="decode",
                                             times=10**6)
                           .advance_clock(step=20, ms=200.0, site="decode",
                                          times=1)),
        prompts=_prompts(sizes=(6,)), max_new=24, eos_id=-1)
    assert eng.metrics["slow_steps"] >= 1
    assert eng.metrics["deadline_misses"] == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_straggler_detector_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    ours, theirs = StragglerDetector(3, window=8), JaxStraggler(3, window=8)
    for _ in range(40):
        host = int(rng.integers(3))
        t = float(rng.exponential(0.01) * (5 if rng.random() < 0.1 else 1))
        assert ours.record_slow(host, t) == theirs.record_slow(host, t)
        ours.record(2, 0.05)
        theirs.record(2, 0.05)
    assert ours.stragglers() == theirs.stragglers()


def test_record_slow_flags_one_spike():
    det = StragglerDetector(n_hosts=1, window=8, threshold=2.0)
    assert not any(det.record_slow(0, 0.1) for _ in range(6))
    assert det.record_slow(0, 0.5)
    assert not det.record_slow(0, 0.1)


# -- the engine's surface ---------------------------------------------------------


def test_a_fault_layer_runs_each_step_to_its_end(models):
    """With faults on, ``step_async`` returns no pending work, as the
    reference does, and a bare plan is wrapped in an injector."""
    _, _, tm, tparams = models
    eng = Engine(tm, tparams, **ENGINE, device="cpu", faults=FaultPlan(),
                 clock=SimClock())
    assert isinstance(eng.faults, FaultInjector)
    assert eng.faults.pager is eng.pager
    eng.submit(_prompts()[0], max_new_tokens=4, temperature=0.0)
    while eng.scheduler.has_work():
        _, pending = eng.step_async()
        assert pending is None
    # a clock fault needs a clock it can move
    with pytest.raises(RuntimeError, match="SimClock"):
        FaultInjector(FaultPlan().advance_clock(step=1, ms=1.0)).pre_step(
            1, None)
