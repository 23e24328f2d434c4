"""The port's Engine on its ``"kernel"`` strategy against the JAX Engine on
``"integer"`` (the paper's int8 arithmetic on both sides), on the CPU.

On CPU tensors the kernel strategy runs the kernels' plain versions, so
this checks the wiring the card's run goes through -- activation
quantization, the GEMV/GEMM dispatch, the paged attention wrappers --
against the reference engine: equal plan logs, and streams that part only
at a near-tie (top-2 logit gap below the 3e-2 an activation code flip can
move a logit; see test_torch_engine.py and test_torch_model.py).
"""

import pytest
import torch

from test_torch_engine import TRAFFIC, check_engine_parity
from test_torch_engine import strategies  # noqa: F401  (the fixture)

torch.set_num_threads(2)


@pytest.mark.parametrize("strategies", [("integer", "kernel")],
                         indirect=True, ids=["integer-kernel"])
@pytest.mark.parametrize("kv", ["float32", "int8"])
@pytest.mark.parametrize("traffic", list(TRAFFIC))
def test_kernel_engine_matches_jax_integer_engine(traffic, kv, strategies):
    check_engine_parity(traffic, kv, strategies)
