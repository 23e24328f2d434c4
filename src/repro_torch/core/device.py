"""Device selection for the port's entry points.

Every entry point takes ``device``.  ``None`` means the card: the port runs
on CUDA unless the caller asks for the CPU, and with no card it raises rather
than drifting to the CPU.  ``"meta"`` makes trees of shapes and dtypes
alone, which the spec tools of ``launch/steps.py`` read.
"""

from __future__ import annotations

from typing import Union

import torch

Device = Union[str, torch.device, None]


def resolve_device(device: Device = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch runs on CUDA unless device='cpu' is "
                           "passed, and no CUDA device is available")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda":
        # the dequant products (torch.matmul, as XLA did them) stay in full
        # f32: TF32 would keep ~3 decimal digits
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
