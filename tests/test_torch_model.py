"""The port's dense model against the JAX package on the CPU.

Both packages get the same weights (JAX ``init`` + ``Model.quantize``,
carried across by ``repro_torch.bridge``) and the same token inputs.  The
JAX side runs as its own tests run it, with ``REPRO_FUSED_PREFILL=interpret``
(the prefix-attention Pallas kernel in interpret mode).  The parity configs
carry arch ids no other test uses, because the JAX chunk step is cached per
config and reads the strategy at trace time.

Two strategy pairs:

* ``dequant`` on both sides: no activation quantization, so the two differ
  only by f32 summation order (XLA vs PyTorch reductions, online vs
  one-pass softmax): logits and f32 pool rows within atol = rtol = 1e-5,
  int8 pool codes within one.
* the paper's integer arithmetic, JAX ``"integer"`` against the port's
  ``"kernel"`` strategy (on the CPU its plain version, which folds groups in
  the reference's order).  Activations are requantized to int8 at every
  projection, so a last-place difference upstream (here from the prefix
  attention's summation order) can flip one activation code by one and
  move that row's logits by ~1e-2 and its later K/V rows by ~2e-2.  Bound:
  3e-2 on logits, 5e-2 on pool rows; all other rows agree to ~1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.core import qlinear as jqlinear
from repro.models import build_model as jax_build_model
from repro.models import layers as JL
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_jax
from repro_torch.core import qlinear as tqlinear
from repro_torch.kernels import build
from repro_torch.models import layers as TL
from repro_torch.models.model import build_model

torch.set_num_threads(2)

# (JAX strategy, port strategy) -> (logits tol, pool tol)
PAIRS = {("dequant", "dequant"): (dict(atol=1e-5, rtol=1e-5),
                                  dict(atol=1e-5, rtol=1e-5)),
         ("integer", "kernel"): (dict(atol=3e-2, rtol=0),
                                 dict(atol=5e-2, rtol=0))}


@pytest.fixture
def strategies(monkeypatch, request):
    """Pin both packages' qlinear strategies (restored after) and check
    that CPU tensors never reached a CUDA kernel."""
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


def _models(kv: str, tag: str):
    tag = f"llama2-110m-torch-parity-{tag}-{kv}"
    jcfg = reduced(get_config("llama2-110m")).with_(arch_id=tag,
                                                    kv_cache_dtype=kv)
    tcfg = tconfigs.reduced(tconfigs.get_config("llama2-110m")).with_(
        arch_id=tag, kv_cache_dtype=kv)
    jm = jax_build_model(jcfg)
    jparams = jm.quantize(jm.init(jax.random.PRNGKey(0)))
    tm = build_model(tcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return jm, jparams, tm, tparams


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _check_pool(jcache, tcache, int8, pool_tol):
    for key in jcache["attn"]:
        want, got = _np(jcache["attn"][key]), _np(tcache["attn"][key])
        if int8 and key in ("k", "v"):
            codes = 1 if pool_tol["atol"] < 1e-3 else 8
            assert np.abs(got.astype(np.int32) - want).max() <= codes, key
        elif int8:
            np.testing.assert_allclose(got, want, err_msg=key, rtol=1e-5,
                                       atol=pool_tol["atol"] / 127)
        else:
            np.testing.assert_allclose(got, want, err_msg=key, **pool_tol)
    np.testing.assert_array_equal(_np(tcache["lens"]), _np(jcache["lens"]))


@pytest.mark.parametrize("strategies", list(PAIRS), indirect=True,
                         ids=["dequant", "integer-kernel"])
@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_chunked_prefill_then_decode_matches_jax(kv, strategies):
    logit_tol, pool_tol = strategies
    jm, jparams, tm, tparams = _models(
        kv, "model-" + tqlinear.default_strategy())
    int8 = kv == "int8"
    b, bs, nb, mb = 3, 8, 24, 8
    jcache = jm.init_paged_cache(b, block_size=bs, n_blocks=nb,
                                 max_blocks_per_seq=mb)
    tcache = tm.init_paged_cache(b, block_size=bs, n_blocks=nb,
                                 max_blocks_per_seq=mb, device="cpu")
    pt = np.full((b, mb), -1, np.int32)
    pt[0, :5] = [3, 5, 1, 0, 9]
    pt[1, :6] = [2, 7, 4, 11, 12, 13]
    pt[2, :2] = [6, 8]
    jcache["page_table"] = jnp.asarray(pt)
    tcache["page_table"] = torch.from_numpy(pt.copy())
    rng = np.random.default_rng(0)
    # two chunk steps: the second attends a non-empty prefix (whole and
    # partial pages), row 2 is padding in the first and short in the second
    steps = [(np.array([0, 1, -1]), np.array([0, 0, 0]),
              np.array([16, 10, 0])),
             (np.array([0, 1, 2]), np.array([16, 10, 0]),
              np.array([12, 16, 9]))]
    for slots, offs, lens in steps:
        toks = rng.integers(4, 500, size=(b, 16)).astype(np.int32)
        jl, jcache = jm.prefill_chunk_batch(jparams, toks, jcache, slots,
                                            offs, chunk_lens=lens)
        tl, tcache = tm.prefill_chunk_batch(tparams, toks, tcache, slots,
                                            offs, chunk_lens=lens)
        live = slots >= 0
        np.testing.assert_allclose(_np(tl)[live], _np(jl)[live], **logit_tol)
        _check_pool(jcache, tcache, int8, pool_tol)

    jdecode = jax.jit(jm.decode_step)
    for step in range(3):
        if step == 2:
            # slot 2 released: its write is dropped, its length pinned to 0
            pt[2] = -1
            jcache["page_table"] = jnp.asarray(pt)
            tcache["page_table"] = torch.from_numpy(pt.copy())
        toks = rng.integers(4, 500, size=(b,)).astype(np.int32)
        jl, jcache = jdecode(jparams, jcache, jnp.asarray(toks))
        tl, tcache = tm.decode_step(tparams, tcache, torch.from_numpy(toks))
        np.testing.assert_allclose(_np(tl)[:2], _np(jl)[:2], **logit_tol)
        _check_pool(jcache, tcache, int8, pool_tol)
    assert _np(tcache["lens"]).tolist() == [31, 29, 0]


def test_attention_chunk_merge_matches_jax():
    """Both merge forms: the gathered prefix and a precomputed flash state,
    with an empty-prefix row that must equal plain causal attention."""
    rng = np.random.default_rng(3)
    b, c, h, kvh, d, p = 2, 8, 4, 2, 16, 12
    q = rng.standard_normal((b, c, h, d)).astype(np.float32) / 4
    kc, vc = (rng.standard_normal((b, c, kvh, d)).astype(np.float32)
              for _ in range(2))
    kp, vp = (rng.standard_normal((b, p, kvh, d)).astype(np.float32)
              for _ in range(2))
    offs = np.array([5, 0])
    q_pos = offs[:, None] + np.arange(c)[None]
    pfx_valid = np.arange(p)[None] < offs[:, None]
    chunk_valid = np.arange(c)[None] < np.array([8, 6])[:, None]
    jcfg = JL.AttnConfig(h, kvh, d, q_chunk=4)
    tcfg = TL.AttnConfig(h, kvh, d, q_chunk=4)
    want = np.asarray(JL.attention_chunk_merge(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(kc),
        jnp.asarray(vc), jcfg, jnp.asarray(q_pos), jnp.asarray(pfx_valid),
        jnp.asarray(chunk_valid)))
    t = torch.from_numpy
    got = TL.attention_chunk_merge(t(q), t(kp), t(vp), t(kc), t(vc), tcfg,
                                   t(q_pos), t(pfx_valid), t(chunk_valid))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=0)
    # flash-state form with an empty prefix on row 1: exact (0, -1e30, 0)
    state = (torch.zeros(b, c, h, d), torch.full((b, h, c, 1), -1e30),
             torch.zeros(b, h, c, 1))
    got_s = TL.attention_chunk_merge(t(q), None, None, t(kc), t(vc), tcfg,
                                     t(q_pos), None, t(chunk_valid),
                                     pfx_state=state)
    np.testing.assert_array_equal(got_s[1].numpy(), got[1].numpy())


def test_norm_and_rope_match_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 4, 32)).astype(np.float32)
    g = rng.standard_normal((32,)).astype(np.float32)
    np.testing.assert_allclose(
        TL.rms_norm(torch.from_numpy(x), torch.from_numpy(g)).numpy(),
        np.asarray(JL.rms_norm(jnp.asarray(x), jnp.asarray(g))),
        atol=1e-6, rtol=1e-6)
    pos = np.array([[0, 5, 1023]], np.int32)
    jc, js = JL.rope_angles(jnp.asarray(pos), 32, 1e4)
    tc, ts = TL.rope_angles(torch.from_numpy(pos), 32, 1e4)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=2e-5)
    xr = x[:1, :3]
    np.testing.assert_allclose(
        TL.apply_rope(torch.from_numpy(xr), tc[..., None, :],
                      ts[..., None, :]).numpy(),
        np.asarray(JL.apply_rope(jnp.asarray(xr), jc[..., None, :],
                                 js[..., None, :])), atol=1e-5)


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_paged_decode_write_equals_the_nonzero_form(kv, monkeypatch):
    """The paged decode step writes every row, sending rows without a
    target block to the pool's scratch block, so that no host read picks
    the live rows.  Its pool stays bitwise what the former write gave:
    each layer's K/V rows of ``nonzero(block >= 0)`` written at (block,
    offset), the rest dropped.  Rows: live mid-block, live at a block's
    first offset, released (all -1) and mid-prefill (its next block not
    leased yet); the pool starts random, so a stray write would show."""
    from repro_torch.models import transformer
    cfg = tconfigs.reduced(tconfigs.get_config("llama2-110m")).with_(
        kv_cache_dtype=kv)
    tm = build_model(cfg)
    params = tm.quantize(tm.init(0, device="cpu"))
    b, bs, nb, mb = 4, 4, 12, 4
    cache = tm.init_paged_cache(b, block_size=bs, n_blocks=nb,
                                max_blocks_per_seq=mb, device="cpu")
    gen = torch.Generator().manual_seed(5)
    for name, buf in cache["attn"].items():
        if buf.dtype == torch.int8:
            buf.copy_(torch.randint(-127, 128, buf.shape, generator=gen))
        else:
            buf.copy_(torch.rand(buf.shape, generator=gen))
    pt = torch.full((b, mb), -1, dtype=torch.int32)
    pt[0, :2] = torch.tensor([3, 7])          # live, pos 6: block 7 off 2
    pt[1, :3] = torch.tensor([0, 5, 9])       # live, pos 8: block 9 off 0
    pt[3, :1] = torch.tensor([2])             # mid-prefill, pos 5: no block
    cache["page_table"] = pt
    cache["lens"] = torch.tensor([6, 8, 0, 5], dtype=torch.int32)
    before = {n: buf.clone() for n, buf in cache["attn"].items()}

    seen = []
    write = transformer._write_rows

    def spy(lc, k, v, blk, off):
        seen.append((k.clone(), v.clone()))
        write(lc, k, v, blk, off)

    monkeypatch.setattr(transformer, "_write_rows", spy)
    tm.decode_step(params, cache, torch.tensor([5, 6, 7, 8]))
    assert len(seen) == cfg.n_layers

    pos = torch.tensor([6, 8, 0, 5])
    blk_id = pt[torch.arange(b), torch.clamp(pos // bs, 0, mb - 1)]
    rows = torch.nonzero(blk_id >= 0).squeeze(1)
    assert rows.tolist() == [0, 1]
    for i, (k, v) in enumerate(seen):
        write({n: buf[i] for n, buf in before.items()}, k[rows], v[rows],
              blk_id[rows].long(), (pos % bs)[rows].long())
    for name, buf in cache["attn"].items():
        assert torch.equal(buf, before[name]), name
