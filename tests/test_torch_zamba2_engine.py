"""zamba2-1.2b's reduced engine against the JAX engine in bf16, with a bf16
and an int8 KV cache, and with Q4_0 weights, on the CPU.

``tests/test_torch_zamba2.py`` holds the rest of the hybrid (its f32
engine among it); these three cases run on their own, each with its own
JAX engines' compiles.  Plan logs equal; greedy streams held to the JAX
engine's for each prompt alone, with f32 compute equal (Q4_0), in bf16
parting only at a step whose top-2 logit gap is below twice the logits'
bound (``tests/test_torch_mamba2.py``).
"""

import pytest
import torch

from test_torch_mamba2 import engines_match, pinned  # noqa: F401

torch.set_num_threads(2)


@pytest.mark.parametrize("case", ["bf16", "int8-kv", "q4_0-f32"])
def test_engine_matches_jax_engine(case, pinned):
    engines_match("zamba2-1.2b", case)
