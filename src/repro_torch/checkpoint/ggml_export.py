"""GGML-compatible Q8_0 block export.

PyTorch counterpart of ``repro/checkpoint/ggml_export.py``: for the same
tree the file is byte for byte the reference's.  Each quantized leaf is
dequantized where it lives (an f32 product of each code and its scale, one
rounding, the same on the card as on the host) and re-blocked on the host
in numpy, as there; tensors are written in the reference's order
(``core.tree.items``: sorted keys) under its ``keystr`` names.

The paper's quantization is literally GGML's "Q8_0" (it cites Gerganov's
library); this module serializes our QuantizedTensor into GGML's on-disk
block layout so quantized checkpoints interoperate with the llama.cpp
ecosystem the paper built on:

    Q8_0 block (GGML block size 32):  [ scale: f16 ][ 32 x int8 ]
    Q4_0 block:                       [ scale: f16 ][ 16 bytes = 32 nibbles ]

Our group size is configurable (default 64 = the paper's burst width);
export re-blocks to GGML's fixed 32 by re-quantizing the dequantized
groups.  When the source group is already 32 the codes are preserved
bit-exactly; otherwise each 64-group splits into two 32-blocks whose
absmax may shrink, so codes re-round — error bounded by half a (smaller)
quantization step plus f16 scale rounding.
"""

from __future__ import annotations

import struct
from typing import BinaryIO

import numpy as np

from repro_torch.core.quantization import QuantizedTensor
from repro_torch.core.tree import items, keystr

GGML_BLOCK = 32
MAGIC = b"RPQ8"          # repro quantized export, versioned container


def _reblock_q8(t: QuantizedTensor) -> tuple[np.ndarray, np.ndarray]:
    """-> (codes int8 (rows, K), scales f16 (rows, K/32)) in GGML blocks."""
    deq = t.dequantize().cpu().numpy()
    rows = deq.reshape(-1, deq.shape[-1])
    k = rows.shape[-1]
    if k % GGML_BLOCK:
        raise ValueError(f"K={k} not divisible by GGML block {GGML_BLOCK}")
    g = rows.reshape(rows.shape[0], k // GGML_BLOCK, GGML_BLOCK)
    absmax = np.abs(g).max(axis=-1, keepdims=True)
    scale = (absmax / 127.0).astype(np.float16)
    inv = np.where(absmax > 0, 127.0 / absmax, 0.0)
    codes = np.clip(np.rint(g * inv), -127, 127).astype(np.int8)
    return codes.reshape(rows.shape[0], k), scale[..., 0]


def write_tensor(f: BinaryIO, name: str, t: QuantizedTensor) -> int:
    """Append one tensor; returns bytes written."""
    codes, scales = _reblock_q8(t)
    nb = name.encode()
    shape = (*t.q.shape[:-1], t.orig_dim)
    header = struct.pack("<I", len(nb)) + nb
    header += struct.pack("<I", len(shape)) + struct.pack(
        f"<{len(shape)}q", *shape)
    payload = scales.tobytes() + codes.tobytes()
    f.write(header)
    f.write(struct.pack("<Q", len(payload)))
    f.write(payload)
    return len(header) + 8 + len(payload)


def export(path: str, params, policy=None) -> dict:
    """Write every QuantizedTensor leaf of ``params`` in GGML Q8_0 blocks.

    Returns {name: bytes} manifest.  Float leaves (norms — the paper
    keeps them fp32) are stored raw f32.
    """
    manifest = {}
    with open(path, "wb") as f:
        f.write(MAGIC + struct.pack("<I", 1))
        flat = items(params)
        f.write(struct.pack("<I", len(flat)))
        for keypath, leaf in flat:
            name = keystr(keypath)
            if isinstance(leaf, QuantizedTensor):
                manifest[name] = write_tensor(f, name, leaf)
            else:
                arr = leaf.detach().float().cpu().numpy()
                nb = name.encode()
                f.write(struct.pack("<I", len(nb)) + nb)
                f.write(struct.pack("<I", len(arr.shape)))
                f.write(struct.pack(f"<{len(arr.shape)}q", *arr.shape))
                payload = b"F32!" + arr.tobytes()
                f.write(struct.pack("<Q", len(payload)))
                f.write(payload)
                manifest[name] = len(payload)
    return manifest


def read_back(path: str) -> dict:
    """Parse the container back into {name: (shape, np.ndarray f32)} —
    dequantized; used by tests to verify round-trip fidelity."""
    out = {}
    with open(path, "rb") as f:
        magic = f.read(4)
        assert magic == MAGIC, magic
        (_version,) = struct.unpack("<I", f.read(4))
        (n,) = struct.unpack("<I", f.read(4))
        for _ in range(n):
            (ln,) = struct.unpack("<I", f.read(4))
            name = f.read(ln).decode()
            (nd,) = struct.unpack("<I", f.read(4))
            shape = struct.unpack(f"<{nd}q", f.read(8 * nd))
            (plen,) = struct.unpack("<Q", f.read(8))
            payload = f.read(plen)
            if payload[:4] == b"F32!":
                arr = np.frombuffer(payload[4:], np.float32).reshape(shape)
            else:
                k = shape[-1]
                rows = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
                nblk = k // GGML_BLOCK
                scales = np.frombuffer(
                    payload[: rows * nblk * 2], np.float16
                ).reshape(rows, nblk).astype(np.float32)
                codes = np.frombuffer(
                    payload[rows * nblk * 2:], np.int8
                ).reshape(rows, nblk, GGML_BLOCK)
                arr = (codes * scales[..., None]).reshape(shape)
            out[name] = (shape, arr)
    return out
