"""The port's communication-avoiding sampler against the JAX package's.

``gumbel_argmax`` and ``distributed_sample`` draw JAX's tokens from JAX's
keys (``core/prng``'s threefry ``uniform`` and ``categorical``) at several
temperatures, top-p values and strip widths, mirroring
``tests/test_extensions.py``'s ``TestDistributedSampling``; then the
vocab-sharded form over gloo, at 2 and 4 ranks (``_torch_mesh_worker``),
gives the unsharded tokens, ties to the lowest global index.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_worker as worker
from repro.serving import sampling_distributed as jsd
from repro_torch.core import prng
from repro_torch.serving import sampling_distributed as tsd

TEMPS = (0.0, 0.5, 1.0, 1.7)
TOP_PS = (0.3, 0.9, 1.0)


def _logits(b=6, v=512, seed=0, scale=3.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, v)) * scale).astype(np.float32)


@pytest.mark.parametrize("v", [512, 1000, 32000])
def test_gumbel_argmax_matches_jax(v):
    lg = _logits(v=v)
    for seed in range(4):
        for t in TEMPS:
            want = np.asarray(jsd.gumbel_argmax(jax.random.PRNGKey(seed),
                                                jnp.asarray(lg), t))
            got = tsd.gumbel_argmax(prng.prng_key(seed), torch.tensor(lg), t)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k", [8, 64, 512])
def test_distributed_sample_matches_jax(k):
    lg = _logits(v=1000, seed=1)
    for seed in range(4):
        for t in TEMPS:
            for p in TOP_PS:
                want = np.asarray(jsd.distributed_sample(
                    jax.random.PRNGKey(seed), jnp.asarray(lg), t, p, k=k))
                got = tsd.distributed_sample(prng.prng_key(seed),
                                             torch.tensor(lg), t, p, k=k)
                np.testing.assert_array_equal(got.numpy(), want)


def test_topk_candidates_tie_order_matches_lax_top_k():
    """Ties go to the lower index, as ``lax.top_k`` orders them."""
    lg = np.round(_logits(v=300, seed=2), 0)          # many ties
    jv, ji = jsd.topk_candidates(jnp.asarray(lg), 40)
    tv, ti = tsd.topk_candidates(torch.tensor(lg), 40)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_sample_topp_from_candidates_matches_jax():
    lg = _logits(v=64, seed=3)
    vals, idx = jsd.topk_candidates(jnp.asarray(lg), 16)
    tvals, tidx = torch.tensor(np.asarray(vals)), torch.tensor(
        np.asarray(idx))
    for seed in range(6):
        for t in TEMPS:
            for p in TOP_PS:
                want = jsd.sample_topp_from_candidates(
                    jax.random.PRNGKey(seed), vals, idx, t, p)
                got = tsd.sample_topp_from_candidates(
                    prng.prng_key(seed), tvals, tidx, t, p)
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gumbel_matches_categorical_distribution():
    """The reference's frequency check, on the port's draws."""
    logits = torch.log(torch.tensor([[0.6, 0.3, 0.1, 1e-9]]))
    counts = np.zeros(4)
    for i in range(600):
        counts[int(tsd.gumbel_argmax(prng.prng_key(i), logits)[0])] += 1
    np.testing.assert_allclose((counts / counts.sum())[:3], [0.6, 0.3, 0.1],
                               atol=0.07)


# the sharded cases: (seed, temperature, top_p, k); logits with exact ties
# across the shards' seams, where the lowest global index must win
CASES = [(s, t, p, k) for s in range(3) for t in TEMPS for p in TOP_PS
         for k in (8, 64)]
VOCAB = 1000


def _tied_logits():
    lg = _logits(b=5, v=VOCAB, seed=4)
    lg[0, :] = 0.0                                  # every index ties
    lg[1, [10, 260, 510, 760]] = 50.0              # one tie a shard
    lg[2, [499, 500]] = 40.0                       # a tie on the seam
    return lg


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    lg = _tied_logits()
    d = tmp_path_factory.mktemp("sampling_lane")
    lanes = {n: worker.Lane("sampling", n, d, logits=lg, cases=CASES,
                            vocab=VOCAB) for n in (2, 4)}
    return lg, {n: lane.finish(240) for n, lane in lanes.items()}


@pytest.mark.parametrize("n", [2, 4])
def test_vocab_sharded_sampling_matches_unsharded(sharded, n):
    lg, outs = sharded
    want = [tsd.distributed_sample(prng.prng_key(s), torch.tensor(lg), t, p,
                                   k).tolist() for s, t, p, k in CASES]
    for out in outs[n]:
        assert out["result"] == want, out["rank"]
        assert not any(out["reductions"].values())
    # the ties: greedy rows take the lowest global index
    greedy = [i for i, c in enumerate(CASES) if c[1] == 0.0]
    assert all(want[i][:3] == [0, 10, 499] for i in greedy)


def test_vocab_range_tiles_the_vocab():
    class M:
        def __init__(self, n, r):
            self.shape, self.coords = {"model": n}, {"model": r}
    for v in (1000, 1001, 7, 32000):
        for n in (1, 2, 3, 4):
            parts = [tsd.vocab_range(v, M(n, r)) for r in range(n)]
            assert sum(length for _, length in parts) == v
            assert [s for s, _ in parts] == sorted(s for s, _ in parts)
            assert all(a[0] + a[1] == b[0] for a, b in zip(parts, parts[1:]))
