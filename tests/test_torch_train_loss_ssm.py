"""The port's training loss and gradients at the configs' own dtypes, part
two: the bf16 SSM, hybrid and audio families (mamba2-370m, zamba2-1.2b,
whisper-small), held as ``test_torch_train_loss_bf16.py`` holds the
attention families, each with every leaf's gradient checked there
(``check_every_leaf``).
"""

import pytest
import torch

from test_torch_train_loss_bf16 import check_bf16, check_every_leaf

torch.set_num_threads(2)

SSM_ARCHS = ["mamba2-370m", "zamba2-1.2b", "whisper-small"]


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_bf16_loss_and_grads_as_close_as_the_reference(arch):
    check_bf16(arch)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_every_leaf_gets_a_gradient(arch):
    check_every_leaf(arch)
