"""Carry parameters across from the JAX package.

``params_from_jax`` turns a JAX parameter tree whose leaves are numpy arrays
(``jax.tree_util.tree_map(np.asarray, params)``) into the port's parameter
tree, copying every byte verbatim: int8 codes stay int8, f32 scales and
float weights keep their dtype (bfloat16 ones too).  A quantized leaf is recognised by its fields -- an
object or mapping with ``q``, ``scale``, ``group_size``, ``bits`` and
``orig_dim`` -- so this module imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.core.device import Device, resolve_device
from repro_torch.core.quantization import QuantizedTensor

_QT_FIELDS = ("q", "scale", "group_size", "bits", "orig_dim")


def _field(leaf, name):
    return leaf[name] if isinstance(leaf, Mapping) else getattr(leaf, name)


def _is_quantized(leaf) -> bool:
    if isinstance(leaf, Mapping):
        return all(f in leaf for f in _QT_FIELDS)
    return all(hasattr(leaf, f) for f in _QT_FIELDS)


def _tensor(a, dev: torch.device) -> torch.Tensor:
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":          # ml_dtypes' bfloat16: its bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(
            dev)
    return torch.from_numpy(a).to(dev)


def params_from_jax(tree: Any, device: Device = None) -> Any:
    dev = resolve_device(device)

    def convert(leaf):
        if _is_quantized(leaf):
            return QuantizedTensor(
                q=_tensor(_field(leaf, "q"), dev),
                scale=_tensor(_field(leaf, "scale"), dev),
                group_size=int(_field(leaf, "group_size")),
                bits=int(_field(leaf, "bits")),
                orig_dim=int(_field(leaf, "orig_dim")))
        if isinstance(leaf, Mapping):
            return {k: convert(v) for k, v in leaf.items()}
        return _tensor(leaf, dev)

    return convert(tree)
