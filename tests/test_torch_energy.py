"""The port's roofline energy model against the reference's, on the CPU.

``repro_torch.launch.roofline`` keeps the reference's ``step_joules``
formula and ``tree_bytes`` count with the H100's data-sheet constants;
``Engine._account_prefix_bytes`` / ``_account_energy`` charge the same
bytes and operations as the reference engine's for the same trace.  So,
on bridged weights and one shared request trace:

  * ``prefix_attn_bytes`` and ``prefix_attn_bytes_gather`` are equal
    exactly (f32 and int8 pools);
  * ``energy_joules`` agrees to a relative 1e-9 once the port's
    constants are swapped for the reference's.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.core import qlinear as jqlinear
from repro.launch import roofline as jroof
from repro.models import build_model as jax_build_model
from repro.models.model import count_params as jax_count_params
from repro.serving.engine import Engine as JaxEngine
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax
from repro_torch.core import qlinear as tqlinear
from repro_torch.launch import roofline as troof
from repro_torch.models.model import build_model, count_params
from repro_torch.serving import engine as tengine
from repro_torch.serving.engine import Engine

torch.set_num_threads(2)

ENGINE = dict(max_slots=3, max_seq=64, page_size=4, n_pages=24,
              prefill_chunk_tokens=8)
REF_CONSTANTS = dict(power_w=jroof.V5E_POWER_W, hbm_bw=jroof.HBM_BW,
                     peak_flops=jroof.PEAK_FLOPS_BF16)


def test_h100_constants_are_the_data_sheet_figures():
    assert troof.HBM_BW == 3.35e12
    assert troof.PEAK_INT8_OPS == 1979e12
    assert troof.PEAK_TF32_FLOPS == 495e12
    assert troof.H100_POWER_W == 700.0
    # the int8 rate is the default compute rate: the served products are
    # int8 codes
    assert troof.step_joules(0.0, 1979e12) == 700.0
    assert troof.step_joules(3.35e12, 0.0) == 700.0


@pytest.mark.parametrize("bytes_moved,flops", [
    (0.0, 0.0), (1.234e8, 5.6e9), (3.3e6, 9.1e13), (7.7e11, 1.0)])
def test_step_joules_equals_the_reference(bytes_moved, flops):
    assert (troof.step_joules(bytes_moved, flops, **REF_CONSTANTS)
            == jroof.step_joules(bytes_moved, flops))
    h100 = dict(power_w=700.0, hbm_bw=3.35e12, peak_flops=1979e12)
    assert (troof.step_joules(bytes_moved, flops)
            == jroof.step_joules(bytes_moved, flops, **h100))


@pytest.mark.parametrize("bits", [8, 4])
def test_tree_bytes_and_count_params_equal_the_reference(bits):
    from repro.core.policy import QuantPolicy
    jm = jax_build_model(reduced(get_config("llama2-110m")))
    raw = jm.init(jax.random.PRNGKey(0))
    for jparams in (raw, jm.quantize(raw, QuantPolicy(bits=bits,
                                                      min_size=512))):
        tparams = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                         jparams),
                                  device="cpu")
        assert troof.tree_bytes(tparams) == jroof.tree_bytes(jparams)
        assert count_params(tparams) == jax_count_params(jparams)


def _prompts():
    rng = np.random.default_rng(4)
    shared = rng.integers(4, 500, size=8)
    out = [rng.integers(4, 500, size=int(n)).astype(np.int32)
           for n in (5, 19, 11, 26)]
    # two more behind a cached two-page prefix
    out += [np.concatenate([shared, rng.integers(4, 500, size=n)])
            .astype(np.int32) for n in (3, 9)]
    out[0] = np.concatenate([shared, out[0]]).astype(np.int32)
    return out


@pytest.fixture(scope="module", params=["float32", "int8"])
def traced(request):
    """One trace through both engines on bridged Q8_0 weights: (port
    engine, JAX engine), both pinned to ``dequant``, the port's energy
    model on the reference's constants."""
    kv = request.param
    tag = f"llama2-110m-torch-energy-{kv}"
    jm = jax_build_model(reduced(get_config("llama2-110m")).with_(
        arch_id=tag, kv_cache_dtype=kv))
    jparams = jm.quantize(jm.init(jax.random.PRNGKey(0)))
    tm = build_model(tconfigs.reduced(tconfigs.get_config(
        "llama2-110m")).with_(arch_id=tag, kv_cache_dtype=kv))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    engines = []
    old = jqlinear.default_strategy(), tqlinear.default_strategy()
    jqlinear.set_default_strategy("dequant")
    tqlinear.set_default_strategy("dequant")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tengine, "step_joules",
                   functools.partial(troof.step_joules, **REF_CONSTANTS))
        for eng in (Engine(tm, tparams, **ENGINE, device="cpu"),
                    JaxEngine(jm, jparams, **ENGINE)):
            for i, p in enumerate(_prompts()):
                eng.submit(p, max_new_tokens=5, temperature=0.0,
                           n_samples=2 if i == 3 else 1, seed=i)
            done = eng.run()
            assert all(r.error is None for r in done)
            engines.append(eng)
    jqlinear.set_default_strategy(old[0])
    tqlinear.set_default_strategy(old[1])
    return engines


def test_prefix_bytes_equal_the_reference_exactly(traced):
    ours, theirs = traced
    assert ours.plan_log == theirs.plan_log
    assert ours.metrics["prefix_hits"] >= 1
    for key in ("prefix_attn_bytes", "prefix_attn_bytes_gather"):
        assert ours.metrics[key] == theirs.metrics[key] > 0, key
    assert (ours.metrics["prefix_attn_bytes"]
            < ours.metrics["prefix_attn_bytes_gather"])


def test_energy_equals_the_reference_under_its_constants(traced):
    ours, theirs = traced
    got, want = ours.metrics["energy_joules"], theirs.metrics["energy_joules"]
    assert want > 0 and abs(got - want) <= 1e-9 * want
    assert ours.metrics["tokens_out"] == theirs.metrics["tokens_out"]
