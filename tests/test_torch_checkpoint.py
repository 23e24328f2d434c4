"""The port's checkpoint store and GGML export against the JAX package.

``checkpoint/store.py`` keeps the reference's layout, so a checkpoint
written by either package restores in the other bit for bit: a train state
(the reduced llama2-110m's parameters, AdamW moments and step) and a
quantized tree (Q8_0 and Q4_0 leaves), each way.  Then the reference's
``TestCheckpoint`` cases on the port: round trips, quantized leaves, latest
and prune, the crash-safe tmp directory, the async save (which holds the
values at the call, whatever the train loop writes in place after it).

``checkpoint/ggml_export.py`` writes, for the same tree, the reference's
file byte for byte (Q8_0 at groups 64 and 32, Q4_0, float leaves), and its
``read_back`` holds the reference test's bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ggml_export as jggml
from repro.checkpoint import store as jstore
from repro.configs import get_config, reduced
from repro.core import QuantPolicy as JQuantPolicy
from repro.core import quantize as jquantize
from repro.models import build_model as jax_build_model
from repro.optim import adamw as jadamw
from repro_torch.bridge import params_from_jax
from repro_torch.checkpoint import ggml_export as tggml
from repro_torch.checkpoint import store as tstore
from repro_torch.core.quantization import QuantizedTensor, quantize
from repro_torch.core.tree import items, keystr


def _train_state():
    """The reduced llama2-110m's JAX train state after two AdamW steps
    (moments and step nonzero), and the same state in the port."""
    m = jax_build_model(reduced(get_config("llama2-110m")))
    p = m.init(jax.random.PRNGKey(0))
    opt = jadamw.init_state(p)
    g = jax.tree_util.tree_map(lambda x: jnp.full_like(x, 1e-3), p)
    for _ in range(2):
        p, opt, _, _ = jadamw.apply_updates(p, opt, g, jadamw.AdamWConfig())
    state = {"params": p, "opt": opt}
    return state, params_from_jax(jax.tree_util.tree_map(np.asarray, state),
                                  device="cpu")


def _quantized():
    m = jax_build_model(reduced(get_config("llama2-110m")))
    p = m.init(jax.random.PRNGKey(1))
    q8 = m.quantize(p, JQuantPolicy(min_size=256))
    q4 = m.quantize(p, JQuantPolicy(bits=4, min_size=256))
    tree = {"q8": q8, "q4": q4}
    return tree, params_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                                 device="cpu")


def _bitwise(port_tree, jax_tree):
    jflat = jax.tree_util.tree_flatten_with_path(
        jax_tree, is_leaf=lambda x: hasattr(x, "group_size"))[0]
    tflat = items(port_tree)
    assert [keystr(p) for p, _ in tflat] == [
        jax.tree_util.keystr(p) for p, _ in jflat]
    for (_, t), (_, j) in zip(tflat, jflat):
        if isinstance(t, QuantizedTensor):
            assert (t.group_size, t.bits, t.orig_dim) == (
                j.group_size, j.bits, j.orig_dim)
            pairs = [(t.q, j.q), (t.scale, j.scale)]
        else:
            pairs = [(t, j)]
        for a, b in pairs:
            b = np.asarray(b)
            assert a.numpy().dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("tree", ["train_state", "quantized"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_restore_across_packages(tree, writer, tmp_path):
    jtree, ttree = _train_state() if tree == "train_state" else _quantized()
    extra = {"data_state": {"step": 3, "buf": [1, 2]}, "loss": 1.5}
    if writer == "jax":
        jstore.save(tmp_path, 7, jtree, extra=extra)
        got, step, ex = tstore.restore(tmp_path, ttree, device="cpu")
        _bitwise(got, jtree)
    else:
        tstore.save(tmp_path, 7, ttree, extra=extra)
        got, step, ex = jstore.restore(tmp_path, jtree)
        _bitwise(ttree, got)
    assert step == 7 and ex == extra
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "LATEST", "step_00000007"]
    assert sorted(p.name for p in (tmp_path / "step_00000007").iterdir()) \
        == ["host_0.npz", "manifest_0.json"]


def test_roundtrip(tmp_path):
    state = {"params": {"w": torch.arange(12.0).reshape(3, 4)},
             "opt": {"m": {"w": torch.ones((3, 4))},
                     "step": torch.tensor(7, dtype=torch.int32)}}
    tstore.save(tmp_path, 7, state, extra={"note": "x"})
    got, step, extra = tstore.restore(tmp_path, state, device="cpu")
    assert step == 7 and extra["note"] == "x"
    assert torch.equal(got["params"]["w"], state["params"]["w"])
    assert got["opt"]["step"].dtype == torch.int32


def test_quantized_leaves_roundtrip(tmp_path):
    qt = quantize(torch.arange(256.0).reshape(2, 128))
    tstore.save(tmp_path, 1, {"w": qt})
    got, _, _ = tstore.restore(tmp_path, {"w": qt}, device="cpu")
    assert torch.equal(got["w"].q, qt.q)
    assert torch.equal(got["w"].scale, qt.scale)
    assert (got["w"].group_size, got["w"].bits, got["w"].orig_dim) == (
        qt.group_size, qt.bits, qt.orig_dim)


def test_latest_and_prune(tmp_path):
    s = {"x": torch.zeros(3)}
    for step in (10, 20, 30, 40):
        tstore.save(tmp_path, step, s)
    assert tstore.latest_step(tmp_path) == 40
    tstore.prune(tmp_path, keep=2)
    assert tstore.latest_step(tmp_path) == 40
    assert sorted(p.name for p in tmp_path.glob("step_*")) == [
        "step_00000030", "step_00000040"]
    _, step, _ = tstore.restore(tmp_path, s, device="cpu")
    assert step == 40
    (tmp_path / "LATEST").unlink()            # the marker lost in a crash
    assert tstore.latest_step(tmp_path) == 40


def test_crash_safe_tmp_dir(tmp_path):
    """A leftover .tmp directory of a crashed writer does not count."""
    tstore.save(tmp_path, 5, {"x": torch.ones(4)})
    (tmp_path / ".tmp_step_00000009_0").mkdir()
    assert tstore.latest_step(tmp_path) == 5


def test_async_save_holds_the_values_at_the_call(tmp_path):
    x = torch.ones(1 << 16)
    t = tstore.save(tmp_path, 3, {"x": x}, async_=True)
    x.mul_(2)                       # the train loop updates in place
    t.join()
    assert tstore.latest_step(tmp_path) == 3
    got, _, _ = tstore.restore(tmp_path, {"x": x}, device="cpu")
    assert torch.equal(got["x"], torch.ones(1 << 16))


def test_restore_without_a_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        tstore.restore(tmp_path, {"x": torch.ones(1)}, device="cpu")


# ---------------------------------------------------------------------------
# GGML export
# ---------------------------------------------------------------------------


def test_ggml_export_is_the_reference_file_byte_for_byte(tmp_path):
    jtree, ttree = _quantized()
    jw = jax.random.normal(jax.random.PRNGKey(3), (8, 96))
    jtree["g32"] = jquantize(jw, group_size=32)
    ttree["g32"] = params_from_jax(
        {"t": jax.tree_util.tree_map(np.asarray, jtree["g32"])},
        device="cpu")["t"]
    jm = jggml.export(str(tmp_path / "jax.rpq8"), jtree)
    tm = tggml.export(str(tmp_path / "port.rpq8"), ttree)
    assert tm == jm
    assert (tmp_path / "port.rpq8").read_bytes() == \
        (tmp_path / "jax.rpq8").read_bytes()
    back = tggml.read_back(str(tmp_path / "port.rpq8"))
    want = jggml.read_back(str(tmp_path / "jax.rpq8"))
    assert back.keys() == want.keys()
    for k in back:
        assert back[k][0] == want[k][0]
        np.testing.assert_array_equal(back[k][1], want[k][1])


def test_ggml_roundtrip_fidelity(tmp_path):
    """The reference's test on the port: re-blocked 64 -> 32, each value
    within half a 32-block step plus the f16 scale's rounding."""
    w = torch.randn((16, 128), generator=torch.Generator().manual_seed(0)) \
        * 2.0
    t = quantize(w, group_size=64)
    path = str(tmp_path / "model.rpq8")
    manifest = tggml.export(path, {"w": t, "norm": torch.ones(128)})
    assert set(manifest) == {"['w']", "['norm']"}
    back = tggml.read_back(path)
    shape, arr = back["['w']"]
    assert tuple(shape) == (16, 128)
    src = t.dequantize().numpy()
    step = np.abs(src.reshape(16, 4, 32)).max(-1, keepdims=True) / 127.0
    assert np.all(np.abs(arr - src).reshape(16, 4, 32) <= step * 0.51 + 1e-3)
    np.testing.assert_array_equal(back["['norm']"][1], np.ones(128,
                                                               np.float32))
    codes, _ = tggml._reblock_q8(quantize(w[:4, :64], group_size=32))
    np.testing.assert_array_equal(
        codes, quantize(w[:4, :64], group_size=32).q.numpy())
