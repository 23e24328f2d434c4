"""The port's Q8_0 quantization and weight bridge against the JAX package.

Codes and scales are integers / exactly-rounded f32 and must be bitwise
equal; the bridged parameter tree must be bytewise equal to the JAX
package's after ``Model.quantize`` (fused decode operands included)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.core import quantization as jq
from repro.models import build_model as jax_build_model
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax
from repro_torch.core import quantization as tq
from repro_torch.core.policy import PAPER_POLICY, quantize_params
from repro_torch.models.model import build_model

torch.set_num_threads(2)


def _cases():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 256)).astype(np.float32)
    # ties: absmax 127 makes the multiplier exactly 1, so k + 0.5 values
    # land on rounding ties (half to even: 0.5 -> 0, 1.5 -> 2, -2.5 -> -2)
    ties = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5] * 8,
                    np.float32)
    x[0, :64] = ties
    x[1, 64:128] = 0.0                         # an all-zero group
    x[2] *= 1e-30                              # tiny (subnormal products)
    x[3, :64] = -7.0                           # constant group
    return x


@pytest.mark.parametrize("group", [32, 64, 48])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_bitwise(group, bits):
    x = _cases()
    want = jq.quantize(jnp.asarray(x), group_size=group, bits=bits)
    got = tq.quantize(torch.from_numpy(x), group_size=group, bits=bits)
    assert got.group_size == want.group_size
    assert got.orig_dim == want.orig_dim and got.bits == want.bits
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy().view(np.uint32),
                                  np.asarray(want.scale).view(np.uint32))
    np.testing.assert_array_equal(
        got.dequantize().numpy().view(np.uint32),
        np.asarray(want.dequantize()).view(np.uint32))


def test_quantize_ties_round_half_to_even():
    x = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, 3.0]])
    t = tq.quantize(x, group_size=8)
    assert t.q.tolist() == [[127, 0, 2, 2, 0, -2, 126, 3]]
    z = tq.quantize(torch.zeros(2, 64))
    assert not z.q.any() and not z.scale.any()


def test_quantize_rows_bitwise():
    rng = np.random.default_rng(1)
    v = rng.standard_normal((3, 5, 4, 32)).astype(np.float32)
    v[0, 0, 0] = 0.0                           # all-zero vector
    v[1, 1, 1, :8] = [127.0, 0.5, 1.5, -2.5, 0, 0, 0, 0]
    v[1, 1, 1, 8:] = 0.0
    # jitted, as the model calls it: XLA turns `/ 127.0` into a multiply by
    # the f32 reciprocal, which eager dispatch does not
    wq, ws = jax.jit(jq.quantize_rows)(jnp.asarray(v))
    gq, gs = tq.quantize_rows(torch.from_numpy(v))
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(gs.numpy().view(np.uint32),
                                  np.asarray(ws).view(np.uint32))


def test_structural_ops_bitwise():
    rng = np.random.default_rng(2)
    a = rng.standard_normal((3, 4, 8, 64)).astype(np.float32)
    b = rng.standard_normal((3, 2, 8, 64)).astype(np.float32)
    ja, jb = jq.quantize(jnp.asarray(a)), jq.quantize(jnp.asarray(b))
    ta, tb = tq.quantize(torch.from_numpy(a)), tq.quantize(torch.from_numpy(b))
    pairs = [
        (jq.qt_reshape_lead(ja, 3, 32), tq.qt_reshape_lead(ta, 3, 32)),
        (jq.qt_fold_lead_into_groups(ja), tq.qt_fold_lead_into_groups(ta)),
        (jq.qt_concat([ja, jb], axis=1), tq.qt_concat([ta, tb], axis=1)),
    ]
    for want, got in pairs:
        assert got.orig_dim == want.orig_dim
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
        np.testing.assert_array_equal(got.scale.numpy(),
                                      np.asarray(want.scale))


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def test_bridge_bytewise_after_quantize():
    cfg = reduced(get_config("llama2-110m"))
    jm = jax_build_model(cfg)
    jparams = jm.quantize(jm.init(jax.random.PRNGKey(0)))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    port = params_from_jax(tree, device="cpu")
    want = dict(_leaves(tree))
    got = dict(_leaves(port))
    assert set(got) == set(want)
    assert {"/blocks/attn/wqkv", "/blocks/attn/wo_f",
            "/blocks/mlp/w13"} <= set(got)
    n_quant = 0
    for path, w in want.items():
        g = got[path]
        if isinstance(w, jq.QuantizedTensor):
            n_quant += 1
            assert isinstance(g, tq.QuantizedTensor), path
            assert (g.group_size, g.bits, g.orig_dim) == \
                (w.group_size, w.bits, w.orig_dim), path
            assert g.q.dtype == torch.int8 and g.scale.dtype == torch.float32
            assert g.q.numpy().tobytes() == np.asarray(w.q).tobytes(), path
            assert g.scale.numpy().tobytes() == \
                np.asarray(w.scale).tobytes(), path
        else:
            assert g.numpy().tobytes() == np.asarray(w).tobytes(), path
    assert n_quant >= 10


def test_port_quantize_matches_jax_on_bridged_floats():
    """The port's own Model.quantize (policy + fusion) over the bridged
    float weights reproduces the JAX package's quantized tree bitwise."""
    cfg = reduced(get_config("llama2-110m"))
    jm = jax_build_model(cfg)
    jfloat = jm.init(jax.random.PRNGKey(3))
    want = dict(_leaves(jax.tree_util.tree_map(np.asarray,
                                               jm.quantize(jfloat))))
    tm = build_model(tconfigs.reduced(tconfigs.get_config("llama2-110m")))
    got = dict(_leaves(tm.quantize(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jfloat), device="cpu"))))
    assert set(got) == set(want)
    for path, w in want.items():
        g = got[path]
        if isinstance(w, jq.QuantizedTensor):
            assert g.q.numpy().tobytes() == np.asarray(w.q).tobytes(), path
            assert g.scale.numpy().tobytes() == \
                np.asarray(w.scale).tobytes(), path
        else:
            assert g.numpy().tobytes() == np.asarray(w).tobytes(), path


def test_policy_paths():
    p = {"embed": torch.zeros(512, 128), "final_norm": {"gamma":
                                                        torch.ones(128)},
         "blocks": {"norm1": {"gamma": torch.ones(2, 128)},
                    "attn": {"wq": torch.zeros(2, 4, 32, 128)},
                    "small": torch.zeros(8, 8)}}
    q = quantize_params(p, PAPER_POLICY)
    assert isinstance(q["embed"], tq.QuantizedTensor)
    assert isinstance(q["blocks"]["attn"]["wq"], tq.QuantizedTensor)
    assert isinstance(q["final_norm"]["gamma"], torch.Tensor)
    assert isinstance(q["blocks"]["norm1"]["gamma"], torch.Tensor)
    assert isinstance(q["blocks"]["small"], torch.Tensor)
