"""Counter-based PRNG keys and draws, bitwise equal to ``jax.random``.

The reference samples with ``jax.random`` under its defaults: the
threefry-2x32 generator with ``jax_threefry_partitionable=True``.  This
module computes the same keys and the same draws:

- ``prng_key(seed)`` is ``[seed >> 32, seed & 0xFFFFFFFF]``;
- ``split(key, n)[i]`` and ``fold_in(key, i)`` both hash the counter pair
  ``(0, i)`` with the key (the partitionable split; fold_in hashes the
  seed of ``i``, which is that pair);
- ``random_bits(key, shape)`` hashes the pair ``(j >> 32, j & 0xFFFFFFFF)``
  of each element's row-major index ``j`` and xors the two output words;
- ``uniform`` puts the top 23 bits into the mantissa of a float in [1, 2)
  and subtracts 1; ``gumbel`` is ``-log(-log(u))`` with ``u`` uniform in
  ``[tiny, 1)``; ``categorical`` is the argmax of gumbel noise plus logits.

Keys are ``(2,)`` or ``(B, 2)`` int64 tensors holding two 32-bit words;
every word operation runs in int64 masked to 32 bits, so it computes the
same on the CPU and on the card.  A ``(B, 2)`` key batch draws one row per
key, as ``jax.vmap`` over the keys does.  Everything runs on the device of
its inputs.

``log`` is XLA's own f32 logarithm on the CPU (a Cephes polynomial), not
``torch.log``: the two differ in the last place for about one value in
seven, which would move a gumbel draw.  XLA contracts a multiply feeding an
add into one fused multiply-add (the CPU has FMA), and so does ``uniform``'s
scale-and-shift; :func:`_fma` computes it in float64, where the product is
exact, and rounds once more to float32.  That second rounding differs from
a true fused multiply-add only when the float64 sum lands exactly on a
float32 midpoint (about once in 2**29 operations).  Each step is a
correctly rounded IEEE operation, so the card gives the same bits as the
CPU.
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Data = Union[int, torch.Tensor]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(k1, k2, x0, x1):
    """The threefry-2x32 block function (20 rounds) on 32-bit words held in
    int64 tensors; all four operands broadcast.  Returns the two output
    words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + k1) & M32
    x1 = (x1 + k2) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def _hash(key: torch.Tensor, hi, lo):
    """Hash counter pairs with ``key`` (..., 2); ``hi``/``lo`` broadcast
    against the key's leading axes."""
    return threefry2x32(key[..., 0], key[..., 1], hi, lo)


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the key ``[seed >> 32, seed & M32]``."""
    return torch.tensor([(seed >> 32) & M32, seed & M32], dtype=torch.int64,
                        device=device)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``num`` new keys, (..., num, 2)."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    b1, b2 = _hash(key[..., None, :], 0, i)
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data: Data) -> torch.Tensor:
    """``jax.random.fold_in``; ``data`` is an int or, for a (B, 2) key
    batch, a (B,) tensor of one datum per key."""
    if isinstance(data, torch.Tensor):
        data = data.to(device=key.device, dtype=torch.int64)
    b1, b2 = _hash(key, 0, data & M32)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32-bit draws of ``shape`` per key: (*key.shape[:-1], *shape) int64."""
    shape = tuple(shape)
    j = torch.arange(math.prod(shape), dtype=torch.int64, device=key.device)
    return bits_at(key, j).reshape(*key.shape[:-1], *shape)


def bits_at(key: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """The 32-bit draws at flat positions ``index`` (int64) of any draw
    ``random_bits(key, shape)`` covering them: each draw is a function of
    its own position alone, so a slice of a draw costs only the slice."""
    b1, b2 = _hash(key[..., None, :], index >> 32, index & M32)
    return b1 ^ b2


def _f32(v: float) -> float:
    """``v`` rounded to float32, as a Python float (exact in f32 arithmetic
    with an f32 tensor, and no device copy)."""
    return float(np.float32(v))


def _fma(a, b, c) -> torch.Tensor:
    """``a * b + c`` of float32 operands (tensors or Python floats holding
    float32 values) rounded as one fused multiply-add, to float32."""
    a = a.double() if isinstance(a, torch.Tensor) else a
    c = c.double() if isinstance(c, torch.Tensor) else c
    return (a * b + c).float()


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """Float32 draws in ``[minval, maxval)``, as ``jax.random.uniform``."""
    return _uniform_of(random_bits(key, shape), minval, maxval)


def uniform_at(key: torch.Tensor, index: torch.Tensor, minval: float = 0.0,
               maxval: float = 1.0) -> torch.Tensor:
    """The draws of ``uniform`` at flat positions ``index`` of its shape
    (``bits_at``)."""
    return _uniform_of(bits_at(key, index), minval, maxval)


def _uniform_of(bits: torch.Tensor, minval: float,
                maxval: float) -> torch.Tensor:
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = mant.view(torch.float32) - 1.0
    lo = _f32(minval)
    span = _f32(np.float32(maxval) - np.float32(minval))
    return torch.clamp(_fma(floats, span, lo), min=lo)


# XLA's f32 log on the CPU: Cephes' polynomial, as XLA emits it
_SQRTHF = _f32(0.707106781186547524)
_LOG_P = [_f32(v) for v in (7.0376836292e-2, -1.1514610310e-1,
                            1.1676998740e-1, -1.2420140846e-1,
                            1.4249322787e-1, -1.6668057665e-1,
                            2.0000714765e-1, -2.4999993993e-1,
                            3.3333331174e-1)]
_LOG_Q1 = _f32(-2.12194440e-4)
_LOG_Q2 = _f32(0.693359375)
_FLT_MIN = float(np.finfo(np.float32).tiny)


def log(x: torch.Tensor) -> torch.Tensor:
    """Natural log of an f32 tensor, bitwise as XLA computes it on the CPU.

    The argument splits into a mantissa ``m`` in [sqrt(1/2), sqrt(2)) and an
    exponent ``e``; ``log = (m - 1) - (m - 1)^2 / 2 + poly + e * log(2)``
    with log(2) split in two parts.  0 and subnormals (XLA reads them as 0)
    give -inf, +inf gives +inf, negative or NaN arguments NaN."""
    xc = torch.clamp(x, min=_FLT_MIN)
    bits = xc.view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    m = ((bits & -0x7F800001) | 0x3F000000).view(torch.float32)
    small = m < _SQRTHF
    e = e - small.to(torch.float32)
    z = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    z2 = z * z
    z3 = z2 * z
    p = _LOG_P
    a, b, c = _fma(z, p[0], p[1]), _fma(z, p[3], p[4]), _fma(z, p[6], p[7])
    a, b, c = _fma(a, z, p[2]), _fma(b, z, p[5]), _fma(c, z, p[8])
    y = _fma(_fma(a, z3, b), z3, c)
    y = _fma(y, z3, e * _LOG_Q1)
    r = _fma(e, _LOG_Q2, (z - z2 * 0.5) + y)
    # XLA's NaN for a negative or NaN argument has every bit set
    nan = torch.full_like(bits, -1).view(torch.float32)
    r = torch.where(x > 0, r, nan)
    r = torch.where(x.abs() < _FLT_MIN, torch.full_like(r, -math.inf), r)
    return torch.where(x == math.inf, x, r)


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Standard Gumbel noise, ``jax.random.gumbel`` in its default "low"
    mode."""
    return -log(-log(uniform(key, shape, _FLT_MIN, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis.  A (2,)
    key draws noise over the whole of ``logits``; a (B, 2) key batch draws
    row ``b`` of (B, V) logits with ``key[b]``, as ``jax.vmap`` does."""
    shape = logits.shape if key.dim() == 1 else logits.shape[1:]
    return torch.argmax(gumbel(key, shape) + logits, dim=-1)
