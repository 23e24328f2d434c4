"""The serve-side executors on a mesh, every other family and split: the
port's ``jit_prefill_step``, ``jit_serve_step`` and
``jit_serve_sample_step`` over gloo on the CPU, with
``test_torch_serve_mesh.py``'s lanes, bound and JAX reference, each config
reduced and in f32:

* glm4-9b (2 KV heads): at 1 x 4 its KV heads do not divide the model
  axis, so the cache splits its positions (Q8_0 weights, an int8 cache:
  the scales follow); at 2 x 2 its KV heads split and its rows too;
* zamba2-1.2b (the hybrid): at 1 x 2 the shared block's KV heads, the
  Mamba2 layers' SSM heads and their x conv ring's channels split over
  ``model``; at 2 x 2 a batch of 1, replicated, as ``long_500k``'s but at
  a short length (an int8 cache);
* mamba2-370m (Q8_0): at 2 x 2 its SSM heads and conv channels over
  ``model`` and its rows over ``data``; at 2 x 1 a batch of 1;
* qwen3-moe-30b-a3b (Q8_0, ``moe_shard="ep_data"``): at 2 x 2 its expert
  banks split over ``data`` as well, gathered whole on use;
* qwen2-vl-7b: the prefill on stub patch embeddings, at 1 x 2;
* whisper-small (frames and prompts, the self and the cross cache): at
  1 x 4 with its 4 KV heads split, and with 2 KV heads, where both caches
  split their positions.

Each case's logits, caches and sampled tokens bit for bit the unsharded
steps', within ``LOGIT_BOUND`` of the JAX package's wrappers on the same
mesh (every family's wrappers run on host devices), each rank holding
``per_device_bytes`` of its specs; the specs the wrappers used show each
split.
"""

import pytest

import _torch_serve_worker as worker
from test_torch_serve_mesh import STEPS, hold_to_jax, make_case, start_lanes

Q8 = dict(quantized=True)
CASES = [
    make_case("glm4_1x4", "glm4-9b", "q8_int8", "1x4"),
    make_case("glm4_2x2", "glm4-9b", "f32", "2x2"),
    make_case("zamba2_1x2", "zamba2-1.2b", "f32", "1x2"),
    make_case("zamba2_b1_2x2", "zamba2-1.2b", "f32", "2x2", b=1, kv="int8"),
    make_case("mamba2_2x2", "mamba2-370m", "f32", "2x2", **Q8),
    make_case("mamba2_b1_2x1", "mamba2-370m", "f32", "2x1", b=1),
    make_case("qwen3_moe_2x2", "qwen3-moe-30b-a3b", "f32", "2x2", **Q8),
    make_case("qwen2_vl_1x2", "qwen2-vl-7b", "f32", "1x2"),
    make_case("whisper_1x4", "whisper-small", "f32", "1x4", **Q8),
    make_case("whisper_gqa_1x4", "whisper-small", "f32", "1x4",
              over={"n_kv_heads": 2}),
]
NAMES = [c["name"] for c in CASES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    port, ref = start_lanes(CASES, tmp_path_factory.mktemp("serve_fam"),
                            "families")()
    return {"port": port, "jax": ref}


@pytest.mark.parametrize("name", NAMES)
def test_wrappers_bitwise_against_unsharded(runs, name):
    for r in runs["port"][name]:
        assert all(r["checks"].values()), r["checks"]


@pytest.mark.parametrize("name", NAMES)
def test_wrappers_match_jax_on_the_same_mesh(runs, name):
    case = next(c for c in CASES if c["name"] == name)
    cfg = worker.config(case["arch"], case["kv"], **case["over"])
    inputs = worker.inputs(cfg, case["batch"], case["seq"], STEPS)
    worst = hold_to_jax(runs["port"][name][0]["got"], runs["jax"][name],
                        inputs)
    print(f"{name}: logits within {worst:.3g} of JAX's")


@pytest.mark.parametrize("name", NAMES)
def test_held_bytes_are_per_device_bytes(runs, name):
    for r in runs["port"][name]:
        for what, (held, reckoned) in r["bytes"].items():
            assert held == reckoned, (what, held, reckoned)


def _specs(runs, name):
    return runs["port"][name][0]["specs"]


def test_kv_heads_over_model(runs):
    assert _specs(runs, "zamba2_1x2")["decode_cache"]["/attn/k"] == \
        (None, "data", None, "model", None)
    sp = _specs(runs, "whisper_1x4")["decode_cache"]
    assert sp["/self/k"] == sp["/cross/v"] == (None, "data", None, "model",
                                               None)


def test_sequence_over_model(runs):
    """Where the KV heads do not divide the model axis, the positions
    split: glm4-9b's cache and its int8 scales, both of whisper's caches
    at 2 KV heads."""
    sp = _specs(runs, "glm4_1x4")["decode_cache"]
    assert sp["/attn/k"] == (None, "data", "model", None, None)
    assert sp["/attn/ks"] == (None, "data", "model", None)
    sp = _specs(runs, "whisper_gqa_1x4")["decode_cache"]
    assert sp["/self/k"] == sp["/cross/k"] == (None, "data", "model", None,
                                               None)


def test_ssm_heads_and_conv_channels_over_model(runs):
    sp = _specs(runs, "mamba2_2x2")["decode_cache"]
    assert sp["/ssm/state"] == (None, "data", "model", None, None)
    assert sp["/ssm/conv/0"] == (None, "data", None, "model")
    assert sp["/ssm/conv/1"] == sp["/ssm/conv/2"] == (None, "data", None,
                                                      None)
    sp = _specs(runs, "zamba2_1x2")["decode_cache"]
    assert sp["/ssm_main/state"] == (None, None, "data", "model", None,
                                     None)
    assert sp["/ssm_tail/conv/0"] == (None, "data", None, "model")


def test_rows_over_data(runs):
    for name in ("glm4_2x2", "mamba2_2x2", "qwen3_moe_2x2"):
        sp = _specs(runs, name)
        assert sp["decode_cache"]["/lens"] == ("data",)
        assert sp["tokens"] == sp["sample_tokens"] == ("data",)
        assert sp["logits"] == ("data", "model")


def test_batch_of_one_is_replicated(runs):
    """``long_500k``'s rule at a short length: a batch of 1 on a data axis
    of 2 is replicated, its tokens, logits and cache rows alike."""
    for name in ("mamba2_b1_2x1", "zamba2_b1_2x2"):
        sp = _specs(runs, name)
        assert sp["decode_cache"]["/lens"] == (None,)
        assert sp["tokens"] == sp["sample_tokens"] == (None,)
        assert sp["logits"] == (None, "model")
        assert sp["batch"]["tokens"] == (None, None)
