"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's nine CUDA kernels from ``src/repro_torch/kernels/csrc``
(phase 1), holds each against its plain PyTorch version at the shapes the
llama2-110m paths give it (phase 2), and serves llama2-110m at full width
through ``repro_torch.serving.engine.Engine`` on the card: the paged pool
with f32 and int8 KV (phases 3-4), the reduced config on the card against
the same weights on the CPU, greedy and sampled, with the threefry gumbel
noise bitwise (phase 5), the dense per-slot cache with f32 and int8 KV
(phase 7), Q4_0 weights on both caches (phase 8), the paper's batch-1
single stream (phase 9), ``launch/serve.py`` at its own sampling defaults
(phase 11) and best-of-4 sampling groups over shared blocks (phase 12).
Every served path resets the launch counters before it runs and asserts
exactly the launches its shape implies after.  Any failed phase exits
non-zero.  The last line of standard output is ``{"ok": true, "device":
{...}}``; the lines before it give the card's name and power limit and
list every kernel with its launches on the main paths, its error and its
times.

It imports nothing of JAX or of the JAX package.  With no CUDA device, or
without the rest of the repository beside it, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SRC = Path(__file__).resolve().parent / "src"

# H100 SXM published peaks (NVIDIA data sheet, dense): the bound of each
# kernel is max(bytes / HBM rate, operations / peak rate of their type).
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12


T0 = time.perf_counter()


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(msg: str) -> None:
    log(f"{msg}  [t = {time.perf_counter() - T0:.1f} s]")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, CUDA events.  A
    busy-wait kernel queued first keeps the card occupied while the host
    enqueues the calls, so the window holds device time only, not the
    Python launch overhead between short kernels."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(4e5 * iters))       # ~0.2 ms of clock per call
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rotating(make, nbytes: int, budget: int = 160 << 20):
    """Enough copies of an operand set that cycling through them exceeds the
    50 MB L2 cache, so each timed call finds its weights cold, as a decode
    step does."""
    n = max(2, math.ceil(budget / max(nbytes, 1)))
    copies = [make() for _ in range(min(n, 400))]
    state = {"i": 0}

    def nxt():
        state["i"] = (state["i"] + 1) % len(copies)
        return copies[state["i"]]
    return nxt


def bound(bytes_moved: float, ops: float, rate: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Report:
    """Collects one record per kernel for the ``kernels`` line."""

    def __init__(self):
        self.rows = {}

    def add(self, name, **kw):
        self.rows[name] = kw


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version at the main path's shapes
# ---------------------------------------------------------------------------


def _q8_operands(gen, dev):
    from repro_torch.core.quantization import quantize

    def operands(m, n, k, gs=64):
        x = torch.randn((m, k), generator=gen, device=dev)
        w = torch.randn((n, k), generator=gen, device=dev) / math.sqrt(k)
        xt, wt = quantize(x, gs), quantize(w, gs)
        assert xt.group_size == gs and wt.group_size == gs
        return xt.q, xt.scale, wt.q, wt.scale
    return operands


def _quant_check(kernel, plain, name, m, n, k, gs, xq, xs, wq, ws):
    """Hold one call of a Q8_0 x Q8_0 or Q8_0 x Q4_0 product against its
    plain version (``ref_q8_matmul``, ``ref_q4_matvec``): the same exact
    per-group products; a GEMV (M <= 32) may sum the f32 groups in another
    order, a GEMM (M > 32) folds them in the plain version's and must be
    bitwise equal to it."""
    from repro_torch.kernels import ops
    got = kernel(xq, xs, wq, ws, gs)
    want = plain(xq, xs, wq, ws, gs)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    tol = 2e-5 * max(1.0, want.abs().max().item())
    if not err <= tol:
        raise AssertionError(f"{name} M={m} N={n} K={k} gs={gs}: max abs "
                             f"err {err:.3g} > tol {tol:.3g}")
    if m > ops.MATVEC_MAX_ROWS and not torch.equal(got, want):
        raise AssertionError(f"{name} M={m} N={n} K={k} gs={gs}: not "
                             "bitwise equal to its plain version")
    return err, tol


def _quant_timed(kernel, plain, name, operands, m, n, k, dev):
    """Check and time one call at group 64 (weights cold in L2) beside the
    plain version and ``torch.matmul`` on the dequantized operands."""
    xq, xs, wq, ws = operands(m, n, k)
    err, tol = _quant_check(kernel, plain, name, m, n, k, 64, xq, xs, wq, ws)
    g = k // 64
    w_bytes = wq.numel() + 4 * ws.numel()     # Q4_0 packs two codes a byte
    nb = m * k + 4 * m * g + w_bytes + 4 * m * n
    b_ms, b_by = bound(nb, 2.0 * m * n * k, INT8_OPS_PER_S)
    nxt = rotating(lambda: operands(m, n, k), w_bytes)
    ms = time_ms(lambda: kernel(*nxt(), 64))
    plain_ms = time_ms(lambda: plain(*nxt(), 64), iters=5)
    xf = (xq.float().reshape(m, g, 64) * xs[..., None]).reshape(m, k)
    wfs = rotating(lambda: torch.randn((n, k), device=dev), 4 * n * k)
    lib = time_ms(lambda: torch.matmul(xf, wfs().T))
    log(f"  {name:10s} M={m:5d} N={n:6d} K={k:5d}  err {err:.2e} "
        f"(tol {tol:.1e})  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
        f"torch.matmul {lib:.4f} ms  bound {b_ms:.4f} ms ({b_by}), "
        f"{100 * b_ms / ms:.1f}% of it")
    return err, ms, plain_ms, lib, b_ms, b_by


def check_q8_matvec(report, dev):
    """q8_matvec at the decode path's shapes: the layer GEMVs and the head
    at M = 1 and 8 slots, summed per decode step; then the GEMV's edges:
    every row-count template boundary, group sizes 16 to 512, a ragged
    last chunk (K % 32 == 16), K past one staged slab, a ragged N (a tile's
    last rows, or whole warps, past N), and a repeated head call that must
    be bitwise equal."""
    from repro_torch.kernels import ops, ref

    operands = _q8_operands(torch.Generator(device=dev).manual_seed(0), dev)
    kernel, plain = ops.q8_matvec_kernel, ref.ref_q8_matmul
    # decode step: per layer wqkv, wo_f, w13, w2; then the head (M = slots)
    layer = [(2304, 768), (768, 768), (4096, 768), (768, 2048)]
    head = (32000, 768)
    step = {"err": 0.0, "ms": 0.0, "plain": 0.0, "lib": 0.0, "bound": 0.0}
    for m in (1, 8):
        for n, k in layer + [head]:
            err, ms, plain_ms, lib, b_ms, _ = _quant_timed(
                kernel, plain, "q8_matvec", operands, m, n, k, dev)
            step["err"] = max(step["err"], err)
            if m == 8:
                w = 12 if (n, k) != head else 1
                for key, v in (("ms", ms), ("plain", plain_ms), ("lib", lib),
                               ("bound", b_ms)):
                    step[key] += w * v
    log(f"  q8_matvec per decode step (12 layers x 4 + head, M=8): kernel "
        f"{step['ms']:.4f} ms, torch.matmul {step['lib']:.4f} ms, bound "
        f"{step['bound']:.4f} ms, {100 * step['bound'] / step['ms']:.1f}% "
        f"of it")

    # the GEMV's edges, untimed: (M, N, K, group)
    edges = [(m, 100, 768, 64) for m in (1, 2, 3, 4, 5, 8, 9, 16, 17, 32)]
    edges += [(8, 768, 2048, gs) for gs in (16, 32, 128, 512)]
    edges += [(3, 100, 784, 16), (17, 100, 784, 16),   # ragged last chunk
              (8, 300, 4160, 64), (32, 200, 4112, 16),  # past one slab
              (8, 99, 768, 64), (8, 4100, 768, 64)]     # ragged N
    worst = 0.0
    for m, n, k, gs in edges:
        worst = max(worst, _quant_check(kernel, plain, "q8_matvec", m, n, k,
                                        gs, *operands(m, n, k, gs))[0])
    xq, xs, wq, ws = operands(8, *head)
    first = kernel(xq, xs, wq, ws, 64)
    again = kernel(xq, xs, wq, ws, 64)
    torch.cuda.synchronize()
    if not torch.equal(first, again):
        raise AssertionError("q8_matvec: a repeated call is not bitwise "
                             "equal to the first")
    step["err"] = max(step["err"], worst)
    log(f"  q8_matvec edges: {len(edges)} cases (M 1..32 at N=100, groups "
        f"16..512, K=784 at group 16, K past one slab, ragged N) within "
        f"tolerance, worst err {worst:.2e}; a repeated head call bitwise "
        f"equal")
    report.add("q8_matvec", route="cuda",
               source="src/repro_torch/kernels/csrc/q8_matvec.cu",
               replaces="src/repro/kernels/q8_matvec.py:67",
               max_abs_err=step["err"], ms=step["ms"],
               plain_ms=step["plain"], bound_ms=step["bound"],
               bound_by="bytes", library_ms=step["lib"],
               per="decode step at 8 slots: 48 layer GEMVs + head")


def q8_matmul_chunk(dev, m, operands):
    """The chunk step's MLP products at m rows, 12 layers x (w13, w2): each
    call checked (bitwise) and timed by ``_quant_timed``, with ``torch._int_mm`` on the raw codes beside it for
    information only (the tensor cores' integer product without the group
    scales).  Returns the per-step sums.  Runs on any tree's
    ``q8_matmul_kernel``, so parent and change can be timed in turns."""
    from repro_torch.kernels import ops, ref
    chunk = {"err": 0.0, "ms": 0.0, "plain": 0.0, "lib": 0.0, "bound": 0.0}
    for n, k in [(4096, 768), (768, 2048)]:
        err, ms, plain, lib, b_ms, b_by = _quant_timed(
            ops.q8_matmul_kernel, ref.ref_q8_matmul, "q8_matmul", operands,
            m, n, k, dev)
        chunk["err"] = max(chunk["err"], err)
        chunk.setdefault("by", b_by)      # w13's: the larger product
        for key, v in (("ms", ms), ("plain", plain), ("lib", lib),
                       ("bound", b_ms)):
            chunk[key] += 12 * v
        codes = rotating(lambda: operands(m, n, k)[::2], m * k + n * k)

        def int_mm():
            xq, wq = codes()
            return torch._int_mm(xq, wq.T)
        try:
            imm = f"{time_ms(int_mm):.4f} ms"
        except RuntimeError as exc:
            imm = f"not measured ({str(exc).splitlines()[0][:80]})"
        log(f"    torch._int_mm on the codes (no group scales; information "
            f"only): {imm}")
    log(f"  q8_matmul per chunk step (12 x (w13, w2), M={m}): kernel "
        f"{chunk['ms']:.4f} ms, torch.matmul {chunk['lib']:.4f} ms, bound "
        f"{chunk['bound']:.4f} ms, {100 * chunk['bound'] / chunk['ms']:.1f}%"
        f" of it; bitwise")
    return chunk


def check_q8_matmul(report, dev):
    """q8_matmul at the chunk step's MLP shapes (8 x 256 rows) and at
    ``launch/serve.py``'s chunk (8 x 512 rows), bitwise equal to its plain
    version and timed (``q8_matmul_chunk``); then untimed edges, bitwise: M
    33 to 2047 across both tile sizes, a ragged and an odd N, groups 16 to
    512, K = 784 at group 16, both non-tensor-core cases (a group not a
    multiple of 16, codes not 16-byte aligned), and a repeated call.  The
    kernel must hold s8 IMMA instructions: it runs its products on the
    tensor cores; and only the two non-tensor-core cases may reach the dp4a
    kernel (``q8_matmul_dp4a`` launches)."""
    from repro_torch.kernels import build, ops, ref

    imma = sass_count("q8_matmul", "IMMA")
    log(f"  q8_matmul: {imma} IMMA instructions in its SASS (cuobjdump "
        "-sass)")
    if imma == 0:
        raise AssertionError("q8_matmul: no IMMA in its SASS: the kernel "
                             "does not run on the tensor cores")
    operands = _q8_operands(torch.Generator(device=dev).manual_seed(1), dev)
    kernel, plain = ops.q8_matmul_kernel, ref.ref_q8_matmul
    dp4a = build.LAUNCHES["q8_matmul_dp4a"]
    main, big = [q8_matmul_chunk(dev, m, operands) for m in (2048, 4096)]

    # untimed edges, bitwise: (M, N, K, group)
    edges = [(m, 768, 768, 64) for m in (33, 63, 64, 65, 127, 600)]
    edges += [(2047, 4096, 768, 64),                  # ragged M, 128 tiles
              (200, 100, 768, 64), (2048, 4100, 768, 64),  # ragged N
              (2047, 4099, 768, 64), (600, 99, 768, 64)]   # odd N
    edges += [(200, 768, 1536, gs) for gs in (16, 32, 48, 128, 512)]
    edges += [(2048, 4096, 768, 48), (2048, 4096, 1024, 512),
              (100, 300, 784, 16)]                    # K = 784 at group 16
    worst = 0.0
    for m, n, k, gs in edges:
        worst = max(worst, _quant_check(kernel, plain, "q8_matmul", m, n, k,
                                        gs, *operands(m, n, k, gs))[0])
    if build.LAUNCHES["q8_matmul_dp4a"] != dp4a:
        raise AssertionError("q8_matmul: a shape the tensor cores take ran "
                             "on the dp4a kernel")
    edges.append((100, 300, 760, 20))                 # dp4a: group 20
    worst = max(worst, _quant_check(kernel, plain, "q8_matmul (group 20)",
                                    100, 300, 760, 20,
                                    *operands(100, 300, 760, 20))[0])
    xq, xs, wq, ws = operands(100, 300, 768)
    flat = torch.empty(xq.numel() + 4, dtype=torch.int8, device=dev)
    xq4 = flat[4:].view(xq.shape)
    xq4.copy_(xq)
    assert xq4.data_ptr() % 16 == 4
    worst = max(worst, _quant_check(kernel, plain,
                                    "q8_matmul (4-byte aligned codes)",
                                    100, 300, 768, 64, xq4, xs, wq, ws)[0])
    if build.LAUNCHES["q8_matmul_dp4a"] != dp4a + 2:
        raise AssertionError("q8_matmul: group 20 and 4-byte aligned codes "
                             "did not both run on the dp4a kernel")
    xq, xs, wq, ws = operands(2048, 4096, 768)
    first = kernel(xq, xs, wq, ws, 64)
    again = kernel(xq, xs, wq, ws, 64)
    torch.cuda.synchronize()
    if not torch.equal(first, again):
        raise AssertionError("q8_matmul: a repeated call is not bitwise "
                             "equal to the first")
    log(f"  q8_matmul edges: {len(edges) + 1} cases (M 33..2047, ragged and "
        f"odd N, groups 16..512, K=784 at group 16, group 20 and 4-byte "
        f"aligned codes on the dp4a kernel) bitwise, worst err {worst:.2e}; "
        f"a repeated w13 call bitwise equal")
    report.add("q8_matmul", route="cuda",
               source="src/repro_torch/kernels/csrc/q8_matmul.cu",
               replaces="src/repro/kernels/q8_matmul.py:92",
               max_abs_err=max(main["err"], big["err"], worst),
               ms=main["ms"], plain_ms=main["plain"],
               bound_ms=main["bound"], bound_by=main["by"],
               library_ms=main["lib"], imma=imma,
               chunk512_ms=big["ms"], chunk512_library_ms=big["lib"],
               chunk512_bound_ms=big["bound"],
               per="chunk step at 8 x 256 rows: 12 layers x (w13, w2) "
                   "(chunk512_*: 8 x 512 rows)")


def _q4_operands(gen, dev):
    from repro_torch.core.quantization import quantize

    def operands(m, n, k, gs=64):
        x = torch.randn((m, k), generator=gen, device=dev)
        w = torch.randn((n, k), generator=gen, device=dev) / math.sqrt(k)
        xt, wt = quantize(x, gs), quantize(w, gs, bits=4)
        assert xt.group_size == gs and wt.group_size == gs
        return xt.q, xt.scale, wt.q, wt.scale
    return operands


def q4_matmul_chunk(dev, m, operands):
    """The Q4_0 chunk step's MLP products at m rows, 12 layers x (w13, w2):
    each call checked (bitwise) and timed by ``_quant_timed``, with ``q8_matmul`` on the unpacked codes of the same
    weights beside it (the same function at Q8_0's bytes; information
    only).  Returns the per-step sums.  Runs on any tree's
    ``q4_matvec_kernel``, so parent and change can be timed in turns."""
    from repro_torch.core.quantization import _unpack_nibbles
    from repro_torch.kernels import ops, ref
    chunk = {"err": 0.0, "ms": 0.0, "plain": 0.0, "lib": 0.0, "bound": 0.0,
             "q8": 0.0}
    for n, k in [(4096, 768), (768, 2048)]:
        err, ms, plain, lib, b_ms, _ = _quant_timed(
            ops.q4_matvec_kernel, ref.ref_q4_matvec, "q4_matvec", operands,
            m, n, k, dev)
        chunk["err"] = max(chunk["err"], err)

        def q8_operands():
            xq, xs, wq, ws = operands(m, n, k)
            return xq, xs, _unpack_nibbles(wq), ws
        q8 = rotating(q8_operands, n * k + 4 * n * (k // 64))
        q8_ms = time_ms(lambda: ops.q8_matmul_kernel(*q8(), 64))
        log(f"    q8_matmul on the same weights' unpacked codes "
            f"(information only): {q8_ms:.4f} ms")
        for key, v in (("ms", ms), ("plain", plain), ("lib", lib),
                       ("bound", b_ms), ("q8", q8_ms)):
            chunk[key] += 12 * v
    log(f"  q4_matvec per chunk step (12 x (w13, w2), M={m}): kernel "
        f"{chunk['ms']:.4f} ms, torch.matmul {chunk['lib']:.4f} ms, "
        f"q8_matmul {chunk['q8']:.4f} ms, bound {chunk['bound']:.4f} ms, "
        f"{100 * chunk['bound'] / chunk['ms']:.1f}% of it; bitwise")
    return chunk


def check_q4(report, dev):
    """q4_matvec at the Q4 path's shapes: the decode GEMVs and the head at
    M = 1 and 8 slots; the chunk step's MLP (the tiled path, M > 32) at 8 x
    256 rows and at ``launch/serve.py``'s 8 x 512, bitwise and timed
    (``q4_matmul_chunk``).  Then the GEMV's edges: every row-count template
    boundary, group sizes 16 to 512, a ragged N, a ragged last chunk (K %
    32 == 16), K past one staged slab, 8-byte aligned weights, and a
    repeated call that must be bitwise equal.  Then the tiled path's edges,
    bitwise: M 33 to 2047 across both tile sizes, ragged and odd N, groups
    16 to 512, and a repeated call.  The library must hold s8 IMMA
    instructions, and only the two shapes the tensor cores cannot take (K
    % 32 == 16, 8-byte aligned weights) may reach the tiled path's dp4a
    kernel (``q4_matvec_dp4a`` launches)."""
    from repro_torch.kernels import build, ops, ref

    imma = sass_count("q4_matvec", "IMMA")
    log(f"  q4_matvec: {imma} IMMA instructions in its SASS (cuobjdump "
        "-sass)")
    if imma == 0:
        raise AssertionError("q4_matvec: no IMMA in its SASS: the tiled "
                             "path does not run on the tensor cores")
    operands = _q4_operands(torch.Generator(device=dev).manual_seed(2), dev)
    kernel, plain = ops.q4_matvec_kernel, ref.ref_q4_matvec

    def check(m, n, k, gs, xq, xs, wq, ws, name="q4_matvec"):
        return _quant_check(kernel, plain, name, m, n, k, gs, xq, xs, wq,
                            ws)[0]

    layer = [(2304, 768), (768, 768), (4096, 768), (768, 2048)]
    head = (32000, 768)
    step = {"err": 0.0, "ms": 0.0, "plain": 0.0, "lib": 0.0, "bound": 0.0}
    for m in (1, 8):
        for n, k in layer + [head]:
            err, ms, plain_ms, lib, b_ms, _ = _quant_timed(
                kernel, plain, "q4_matvec", operands, m, n, k, dev)
            step["err"] = max(step["err"], err)
            if m == 8:
                w = 12 if (n, k) != head else 1
                for key, v in (("ms", ms), ("plain", plain_ms), ("lib", lib),
                               ("bound", b_ms)):
                    step[key] += w * v
    log(f"  q4_matvec per decode step (12 layers x 4 + head, M=8): kernel "
        f"{step['ms']:.4f} ms, torch.matmul {step['lib']:.4f} ms, bound "
        f"{step['bound']:.4f} ms, {100 * step['bound'] / step['ms']:.1f}% "
        f"of it")
    dp4a = build.LAUNCHES["q4_matvec_dp4a"]
    chunk, big = [q4_matmul_chunk(dev, m, operands) for m in (2048, 4096)]

    # the GEMV's edges, untimed: (M, N, K, group)
    edges = [(m, 100, 768, 64) for m in (1, 2, 3, 4, 5, 8, 9, 16, 17, 32)]
    edges += [(8, 768, 2048, gs) for gs in (16, 32, 128, 512)]
    edges += [(3, 100, 784, 16), (17, 100, 784, 16),   # ragged last chunk
              (8, 300, 4160, 64), (32, 200, 4112, 16)]  # past one slab
    worst = 0.0
    for m, n, k, gs in edges:
        worst = max(worst, check(m, n, k, gs, *operands(m, n, k, gs)))
    # weights 8 bytes past a 16-byte boundary take the 8-byte loads
    xq, xs, wq, ws = operands(8, 100, 768)
    flat = torch.empty(wq.numel() + 8, dtype=torch.int8, device=dev)
    wq8 = flat[8:].view(wq.shape)
    wq8.copy_(wq)
    assert wq8.data_ptr() % 16 == 8
    worst = max(worst, check(8, 100, 768, 64, xq, xs, wq8, ws,
                             "q4_matvec (8-byte aligned weights)"))
    xq, xs, wq, ws = operands(8, *head)
    first = kernel(xq, xs, wq, ws, 64)
    again = kernel(xq, xs, wq, ws, 64)
    torch.cuda.synchronize()
    if not torch.equal(first, again):
        raise AssertionError("q4_matvec: a repeated call is not bitwise "
                             "equal to the first")
    step["err"] = max(step["err"], worst)
    log(f"  q4_matvec edges: {len(edges) + 1} cases (M 1..32 at N=100, "
        f"groups 16..512, K=784 at group 16, K past one slab, 8-byte "
        f"aligned weights) within tolerance, worst err {worst:.2e}; a "
        f"repeated head call bitwise equal")

    # the tiled path's edges, untimed, bitwise: (M, N, K, group)
    tiled = [(m, 768, 768, 64) for m in (33, 63, 64, 65, 127, 600)]
    tiled += [(2047, 4096, 768, 64),                  # ragged M, 128 tiles
              (200, 100, 768, 64), (2048, 4100, 768, 64),  # ragged N
              (2047, 4099, 768, 64), (600, 99, 768, 64)]   # odd N
    tiled += [(200, 768, 1536, gs) for gs in (16, 32, 128, 256, 512)]
    tiled += [(2048, 4096, 768, 16), (2048, 4096, 1024, 512)]
    tworst = 0.0
    for m, n, k, gs in tiled:
        tworst = max(tworst, check(m, n, k, gs, *operands(m, n, k, gs)))
    if build.LAUNCHES["q4_matvec_dp4a"] != dp4a:
        raise AssertionError("q4_matvec: a shape the tensor cores take ran "
                             "on the dp4a kernel")
    tiled.append((100, 300, 784, 16))                 # K % 32 == 16: dp4a
    tworst = max(tworst, check(100, 300, 784, 16,
                               *operands(100, 300, 784, 16),
                               "q4_matvec (K % 32 == 16)"))
    xq, xs, wq, ws = operands(100, 300, 768)
    flat = torch.empty(wq.numel() + 8, dtype=torch.int8, device=dev)
    wq8 = flat[8:].view(wq.shape)
    wq8.copy_(wq)
    tworst = max(tworst, check(100, 300, 768, 64, xq, xs, wq8, ws,
                               "q4_matvec (8-byte aligned weights)"))
    if build.LAUNCHES["q4_matvec_dp4a"] != dp4a + 2:
        raise AssertionError("q4_matvec: K % 32 == 16 and 8-byte aligned "
                             "weights did not both run on the dp4a kernel")
    xq, xs, wq, ws = operands(2048, 4096, 768)
    first = kernel(xq, xs, wq, ws, 64)
    again = kernel(xq, xs, wq, ws, 64)
    torch.cuda.synchronize()
    if not torch.equal(first, again):
        raise AssertionError("q4_matvec: a repeated M=2048 call is not "
                             "bitwise equal to the first")
    log(f"  q4_matvec tiled edges: {len(tiled) + 1} cases (M 33..2047, "
        f"ragged and odd N, groups 16..512, K=784 at group 16 and 8-byte "
        f"aligned weights on the dp4a kernel) bitwise, worst err "
        f"{tworst:.2e}; a repeated w13 call at M=2048 bitwise equal")
    report.add("q4_matvec", route="cuda",
               source="src/repro_torch/kernels/csrc/q4_matvec.cu",
               replaces="src/repro/kernels/q4_matmul.py:69",
               max_abs_err=max(step["err"], chunk["err"], big["err"],
                               tworst),
               ms=step["ms"], plain_ms=step["plain"],
               bound_ms=step["bound"], bound_by="bytes",
               library_ms=step["lib"], imma=imma,
               chunk_ms=chunk["ms"], chunk_library_ms=chunk["lib"],
               chunk_bound_ms=chunk["bound"], chunk_q8_matmul_ms=chunk["q8"],
               chunk512_ms=big["ms"], chunk512_library_ms=big["lib"],
               chunk512_bound_ms=big["bound"],
               per="decode step at 8 slots: 48 layer GEMVs + head "
                   "(chunk_*: chunk step, 12 x (w13, w2) at M=2048; "
                   "chunk512_*: at M=4096)")


def check_dense_attention(report, dev):
    """decode_attention at the dense decode's shapes (8 slots x 1024,
    f32 and int8), bitwise against the paged kernel on the same rows."""
    from repro_torch.core.quantization import quantize_rows
    from repro_torch.kernels import ops, ref
    b, s, kvh, hq, d = 8, 1024, 12, 1, 64
    h = kvh * hq
    gen = torch.Generator(device=dev).manual_seed(3)
    lens_l = [0, 1, 63, 64, 65, 1024, 300, 777]
    lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
    # the identity page table over the same rows: the paged kernel reads
    # exactly what the dense one reads
    pt = torch.arange(b * s // 64, dtype=torch.int32,
                      device=dev).reshape(b, s // 64)

    def cache(int8):
        k = torch.randn((b, s, kvh, d), generator=gen, device=dev)
        v = torch.randn((b, s, kvh, d), generator=gen, device=dev)
        if not int8:
            return k, v, None, None
        (kq, ks), (vq, vs) = quantize_rows(k), quantize_rows(v)
        return kq, vq, ks, vs

    rec = {}
    for int8 in (False, True):
        kind = "int8" if int8 else "f32"
        k, v, ksc, vsc = cache(int8)
        q = torch.randn((b, kvh, hq, d), generator=gen, device=dev) / 8.0
        got = ops.decode_attention_kernel(q, k, v, lens, ksc, vsc)
        want = ref.ref_decode_attention(q, k, v, lens.reshape(b, 1), ksc, vsc)
        pool = [None if t is None else t.reshape(b * s // 64, 64,
                                                 *t.shape[2:])
                for t in (k, v, ksc, vsc)]
        paged = ops.paged_decode_attention_kernel(q, pool[0], pool[1], pt,
                                                  lens, pool[2], pool[3])
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        tol = 2e-5   # online vs one-pass softmax: f32 summation order only
        if not (err <= tol and got[0].abs().max().item() == 0.0
                and torch.equal(got, paged)):
            raise AssertionError(
                f"decode_attention {kind}: err {err:.3g} (tol {tol}), len=0 "
                f"row exactly 0: {got[0].abs().max().item() == 0.0}, bitwise "
                f"equal to the paged kernel: {torch.equal(got, paged)}")
        elem = 1 if int8 else 4
        nrows = sum(lens_l)
        nbytes = (2 * nrows * kvh * d * elem + (8 * nrows * kvh if int8 else 0)
                  + 2 * b * h * d * 4 + 4 * b)
        b_ms, b_by = bound(nbytes, 4.0 * nrows * h * d, F32_FLOPS_PER_S)
        nxt = rotating(lambda: (q, *cache(int8)), 2 * b * s * kvh * d * elem,
                       budget=96 << 20)

        def run_kernel():
            qq, kk, vv, kks, vvs = nxt()
            ops.decode_attention_kernel(qq, kk, vv, lens, kks, vvs)

        def run_plain():
            qq, kk, vv, kks, vvs = nxt()
            ref.ref_decode_attention(qq, kk, vv, lens.reshape(b, 1), kks, vvs)

        ms = time_ms(run_kernel)
        plain = time_ms(run_plain, iters=5)
        kf, vf = k.float(), v.float()
        if int8:
            kf, vf = kf * ksc[..., None], vf * vsc[..., None]
        kf, vf = kf.transpose(1, 2), vf.transpose(1, 2)       # (B, H, S, D)
        mask = (torch.arange(s, device=dev)[None] < lens[:, None])
        mask = mask[:, None, None, :]
        qs = q.reshape(b, h, 1, d)
        lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qs, kf, vf, attn_mask=mask, scale=1.0))
        log(f"  decode_attention {kind}: B {b} x S {s}, lens {lens_l}  err "
            f"{err:.2e} (tol {tol:.0e}), bitwise = paged kernel  kernel "
            f"{ms:.4f} ms  plain {plain:.4f} ms  sdpa {lib:.4f} ms  bound "
            f"{b_ms:.4f} ms ({b_by})")
        rec[kind] = (err, ms, plain, lib, b_ms, b_by)
    f, i8 = rec["f32"], rec["int8"]
    report.add("decode_attention", route="cuda",
               source="src/repro_torch/kernels/csrc/decode_attention.cu",
               replaces="src/repro/kernels/decode_attention.py:206",
               max_abs_err=max(f[0], i8[0]), ms=f[1], plain_ms=f[2],
               library_ms=f[3], bound_ms=f[4], bound_by=f[5],
               int8_ms=i8[1], int8_bound_ms=i8[4],
               per="one layer's call, f32 cache (int8_* for the int8 cache)")


def sass_count(name: str, *words: str) -> int:
    """Lines of kernel ``name``'s built library, disassembled by
    ``cuobjdump -sass``, that hold every one of ``words``."""
    from repro_torch.kernels import build
    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(build.library_path(name))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    return sum(all(w in line for w in words) for line in sass.splitlines())


def launched_kernels(fn) -> list:
    """Names of the device kernels one call of ``fn`` launched."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA})


def check_flash_prefill(report, dev):
    """flash_prefill at the one-shot prefill's shapes (B = 1, H = 12,
    D = 64; a prime 17, a tile multiple, a ragged 600 and the full max_seq
    1024), then per-row extents with GQA, D = 32 and 128, and the
    non-causal form: within 2e-5 of the plain version on every case, dead
    query rows exactly 0.  The D = 64 causal cases are timed, the one-shot
    ones beside SDPA (``is_causal``) on the same rotating q/k/v.  The bound
    is the 3xTF32 floor (three TF32 products a product at the dense TF32
    rate); the f32 CUDA-core floor is printed beside it.  The kernel must
    hold TF32 HMMA instructions: it runs on the tensor cores."""
    from repro_torch.kernels import ops, ref
    hmma = sass_count("flash_prefill", "HMMA", "TF32")
    log(f"  flash_prefill: {hmma} TF32 HMMA instructions in its SASS "
        "(cuobjdump -sass)")
    if hmma == 0:
        raise AssertionError("flash_prefill: no TF32 HMMA in its SASS: the "
                             "kernel does not run on the tensor cores")
    gen = torch.Generator(device=dev).manual_seed(4)
    cases = [dict(b=1, sq=n, sk=n, h=12, kvh=12) for n in (17, 256, 600,
                                                         1024)]
    cases.append(dict(b=4, sq=200, sk=456, h=12, kvh=6,
                      off=[256, 0, 100, 37], ql=[200, 150, 0, 77],
                      kl=[456, 150, 300, 114]))
    cases += [dict(b=2, sq=150, sk=150, h=4, kvh=2, d=dd) for dd in (32, 128)]
    cases.append(dict(b=2, sq=100, sk=300, h=4, kvh=4, causal=False,
                      kl=[300, 131]))
    err_max, timed, sdpa_kernels = 0.0, {}, None
    for c in cases:
        bb, sq, sk, hh, kv = c["b"], c["sq"], c["sk"], c["h"], c["kvh"]
        d, causal = c.get("d", 64), c.get("causal", True)

        def mk():
            return (torch.randn((bb, sq, hh, d), generator=gen, device=dev),
                    torch.randn((bb, sk, kv, d), generator=gen, device=dev),
                    torch.randn((bb, sk, kv, d), generator=gen, device=dev))

        ext = [None if c.get(key) is None else
               torch.tensor(c[key], dtype=torch.int32, device=dev)
               for key in ("off", "ql", "kl")]
        q, k, v = mk()
        got = ops.flash_prefill_kernel(q, k, v, *ext, causal)
        want = ref.ref_flash_prefill(q, k, v, causal, *ext)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        tol = 2e-5
        dead = want.abs().amax(dim=(2, 3)) == 0       # rows with no output
        if not (err <= tol and bool((got[dead] == 0).all())):
            raise AssertionError(f"flash_prefill {c}: err {err:.3g} > {tol} "
                                 "or a dead query row not exactly 0")
        err_max = max(err_max, err)
        shape = (f"B={bb} Sq={sq} Sk={sk} H={hh} KVH={kv} D={d}"
                 f"{'' if causal else ' non-causal'}"
                 f"{' with per-row extents' if 'off' in c else ''}")
        if d != 64 or not causal:
            log(f"  flash_prefill {shape}  err {err:.2e} (tol {tol:.0e}), "
                f"{int(dead.sum())} dead rows exactly 0")
            continue
        offs = c.get("off", [0] * bb)
        qls, kls = c.get("ql", [sq] * bb), c.get("kl", [sk] * bb)
        pairs = sum(sum(max(0, min(kl, o + i + 1)) for i in range(ql))
                    for o, ql, kl in zip(offs, qls, kls))
        nbytes = 4 * d * (bb * sq * hh * 2 + 2 * bb * sk * kv) + 12 * bb
        flops = 4.0 * pairs * hh * d
        b_ms, b_by = bound(nbytes, 3 * flops, TF32_FLOPS_PER_S)
        f32_ms, f32_by = bound(nbytes, flops, F32_FLOPS_PER_S)
        nxt = rotating(mk, 4 * d * bb * (sq * hh + 2 * sk * kv),
                       budget=96 << 20)
        ms = time_ms(lambda: ops.flash_prefill_kernel(*nxt(), *ext))
        plain = time_ms(lambda: ref.ref_flash_prefill(*nxt(), True, *ext),
                        iters=5)
        lib = None
        if "off" not in c:
            def sdpa():
                qt, kt, vt = (t.transpose(1, 2) for t in nxt())
                return torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True)
            lib = time_ms(sdpa)
            if sdpa_kernels is None:
                sdpa_kernels = launched_kernels(sdpa)
                log(f"  SDPA (f32, is_causal) launched: {sdpa_kernels}")
        log(f"  flash_prefill {shape}  err {err:.2e} (tol {tol:.0e})  "
            f"kernel {ms:.4f} ms  plain {plain:.4f} ms  sdpa "
            f"{'-' if lib is None else f'{lib:.4f}'} ms  bound {b_ms:.4f} ms "
            f"({b_by}, 3xTF32 tensor cores; f32 CUDA cores {f32_ms:.4f} ms, "
            f"{f32_by})")
        timed[sq if "off" not in c else "extents"] = dict(
            ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
            bound_by=b_by, f32_bound_ms=f32_ms)
    last = timed[600]
    report.add("flash_prefill", route="cuda",
               source="src/repro_torch/kernels/csrc/flash_prefill.cu",
               replaces="src/repro/kernels/flash_prefill.py:173",
               max_abs_err=err_max, **last, hmma_tf32=hmma,
               sdpa_kernels=sdpa_kernels,
               by_prompt={str(n): timed[n] for n in timed},
               per="one layer's call, one 600-token prompt")


def check_rope(report, dev):
    """rope on the q and k heads of a fused qkv row (read in place) at
    B = 1 and 8 slots; bitwise against the plain version."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models.layers import rope_angles
    gen = torch.Generator(device=dev).manual_seed(5)
    nh, kvh, d = 12, 12, 64
    for b in (1, 8):
        def mk():
            qkv = torch.randn((b, (nh + 2 * kvh) * d), generator=gen,
                              device=dev)
            pos = torch.randint(0, 1024, (b,), generator=gen, device=dev)
            return (qkv.reshape(b, nh + 2 * kvh, d)[:, :nh + kvh],
                    *rope_angles(pos, d, 1e4))
        x, cos, sin = mk()
        got = ops.rope_kernel(x, cos, sin)
        want = ref.ref_rope(x, cos, sin)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not err == 0.0:
            raise AssertionError(f"rope B={b}: max abs err {err:.3g}, "
                                 "expected bitwise equality")
        nbytes = 2 * b * (nh + kvh) * d * 4 + 2 * b * d * 4
        b_ms, b_by = bound(nbytes, 4.0 * b * (nh + kvh) * d, F32_FLOPS_PER_S)
        ms = time_ms(lambda: ops.rope_kernel(x, cos, sin), iters=50)
        plain = time_ms(lambda: ref.ref_rope(x, cos, sin), iters=50)
        log(f"  rope B={b} heads {nh + kvh} D={d}: err {err:.1e} (bitwise)  "
            f"kernel {ms:.4f} ms  plain {plain:.4f} ms  bound {b_ms:.6f} ms "
            f"({b_by})")
    report.add("rope", route="cuda",
               source="src/repro_torch/kernels/csrc/rope.cu",
               replaces="src/repro/kernels/rope.py:48", max_abs_err=err,
               ms=ms, plain_ms=plain, library_ms=None, bound_ms=b_ms,
               bound_by=b_by,
               per="one layer's call at 8 slots: q and k heads of qkv")


def check_rmsnorm_quant(report, dev):
    """rmsnorm_quant at the decode step's rows (M = 1, 8 slots) and a chunk
    step's (M = 8 x 256), K = 768, random gamma, one all-zero group and one
    row at large magnitude.  Codes are held within 1 (the count printed),
    scales within a relative 3e-7.  The kernel sums mean(x^2) in the order
    of torch.mean on the card; the same kernel is also run with another
    number of threads a row (another order), and how far its scales part
    from the plain version's is printed, not held."""
    from repro_torch.kernels import build, ops, ref
    gen = torch.Generator(device=dev).manual_seed(6)
    k, gs, eps = 768, 64, 1e-5
    gamma = torch.randn((k,), generator=gen, device=dev)
    rec = {}
    for m in (1, 8, 2048):
        def mk():
            x = torch.randn((m, k), generator=gen, device=dev)
            x[0, 64:128] = 0.0
            x[-1] *= 1e4
            return x
        x = mk()
        q, sc = ops.rmsnorm_quant_kernel(x, gamma, eps, gs)
        wq, ws = ref.ref_rmsnorm_quant(x, gamma, eps, gs)
        torch.cuda.synchronize()
        dq = (q.int() - wq.int()).abs()
        n_diff = int((dq > 0).sum().item())
        rel = ((sc - ws).abs() / ws.abs().clamp(min=1e-30)).max().item()
        zero_ok = bool((q[0, 64:128] == 0).all()) and sc[0, 1].item() == 0.0
        deq = (q.float().reshape(m, -1, gs) * sc[..., None]
               - wq.float().reshape(m, -1, gs) * ws[..., None])
        err = deq.abs().max().item()
        if not (dq.max().item() <= 1 and rel <= 3e-7 and zero_ok):
            raise AssertionError(
                f"rmsnorm_quant M={m}: codes differ by up to "
                f"{dq.max().item()} ({n_diff} of {m * k}), scales by "
                f"{rel:.3g} relative, zero group exact {zero_ok}; the kernel "
                f"sums in torch {ops.TORCH_ROW_MEAN_ORDER_OF}'s row-mean "
                f"order, this is torch {torch.__version__}")
        width, factor = ops._torch_row_mean_order(m, k)
        alt = 32 if width != 32 else 128
        aq = torch.empty_like(q)
        asc = torch.empty_like(sc)
        build.launch("rmsnorm_quant", x.data_ptr(), gamma.data_ptr(),
                     aq.data_ptr(), asc.data_ptr(), m, k, gs, eps, factor,
                     alt, torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        alt_codes = int((aq != wq).sum().item())
        alt_scales = int((asc != ws).sum().item())
        alt_rel = ((asc - ws).abs() / ws.abs().clamp(min=1e-30)).max().item()
        nbytes = m * k * 4 + k * 4 + m * k + m * (k // gs) * 4
        b_ms, b_by = bound(nbytes, 6.0 * m * k, F32_FLOPS_PER_S)
        nxt = rotating(mk, m * k * 4)
        ms = time_ms(lambda: ops.rmsnorm_quant_kernel(nxt(), gamma, eps, gs),
                     iters=50)
        plain = time_ms(lambda: ref.ref_rmsnorm_quant(nxt(), gamma, eps, gs),
                        iters=20)
        log(f"  rmsnorm_quant M={m:5d} K={k}: {n_diff} of {m * k} codes differ"
            f" by 1, max scale diff {rel:.2e} relative (tol 3e-7), "
            f"dequantized max abs err {err:.2e}  kernel "
            f"{ms:.4f} ms  plain {plain:.4f} ms  library - (no single call)"
            f"  bound {b_ms:.6f} ms ({b_by}); summed by {alt} threads a "
            f"row instead of torch's {width}: {alt_codes} codes and "
            f"{alt_scales} of {sc.numel()} scales differ, max "
            f"{alt_rel:.2e} relative")
        rec[m] = (ms, plain, b_ms, b_by, n_diff, rel, err)
    ms, plain, b_ms, b_by = rec[8][:4]
    report.add("rmsnorm_quant", route="cuda",
               source="src/repro_torch/kernels/csrc/rmsnorm_quant.cu",
               replaces="src/repro/kernels/rmsnorm_quant.py:58",
               max_abs_err=max(r[6] for r in rec.values()), ms=ms,
               plain_ms=plain, library_ms=None, bound_ms=b_ms, bound_by=b_by,
               m2048_ms=rec[2048][0], m2048_plain_ms=rec[2048][1],
               m2048_bound_ms=rec[2048][2],
               codes_differing={str(m): r[4] for m, r in rec.items()},
               scale_rel_err=max(r[5] for r in rec.values()),
               per="one call at M=8 decode rows, K=768 (m2048_* for a chunk "
                   "step's 2048 rows); max_abs_err on the dequantized "
                   "values code * scale")


def _pools(gen, dev, nb, bs, kvh, d, int8):
    from repro_torch.core.quantization import quantize_rows
    k = torch.randn((nb, bs, kvh, d), generator=gen, device=dev)
    v = torch.randn((nb, bs, kvh, d), generator=gen, device=dev)
    if not int8:
        return k, v, None, None
    kq, ks = quantize_rows(k)
    vq, vs = quantize_rows(v)
    return kq, vq, ks, vs


def _page_table(gen, dev, b, mb, nb, live_blocks):
    """Distinct random blocks for each row's live pages, -1 past them."""
    perm = torch.randperm(nb, generator=gen, device=dev)
    pt = torch.full((b, mb), -1, dtype=torch.int32, device=dev)
    used = 0
    for i, n in enumerate(live_blocks):
        pt[i, :n] = perm[used:used + n].int()
        used += n
    return pt


def check_attention(report, dev):
    from repro_torch.kernels import ops, ref
    b, kvh, hq, d, bs, mb = 8, 12, 1, 64, 64, 16
    h = kvh * hq
    nb = b * mb
    gen = torch.Generator(device=dev).manual_seed(1)
    rec = {}
    # ---- paged decode: lens cover 0, 1, one page -1/+0/+1, the full table
    lens_l = [0, 1, 63, 64, 65, 1024, 300, 777]
    lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
    live = [max(1, -(-n // bs)) if n else 0 for n in lens_l]
    for int8 in (False, True):
        kind = "int8" if int8 else "f32"
        pools = _pools(gen, dev, nb, bs, kvh, d, int8)
        pt = _page_table(gen, dev, b, mb, nb, live)
        q = torch.randn((b, kvh, hq, d), generator=gen, device=dev) / 8.0
        got = ops.paged_decode_attention_kernel(q, pools[0], pools[1], pt,
                                                lens, pools[2], pools[3])
        want = ref.ref_paged_decode_attention(q, pools[0], pools[1], pt,
                                              lens, pools[2], pools[3])
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        tol = 2e-5   # online vs one-pass softmax: f32 summation order only
        if not err <= tol or got[0].abs().max().item() != 0.0:
            raise AssertionError(f"paged_decode_attention {kind}: err "
                                 f"{err:.3g} > {tol} or len=0 row not 0")
        elem = 1 if int8 else 4
        nrows = sum(lens_l)
        nbytes = (2 * nrows * kvh * d * elem + (8 * nrows * kvh if int8 else 0)
                  + 2 * b * h * d * 4 + 4 * b * mb + 4 * b)
        b_ms, b_by = bound(nbytes, 4.0 * nrows * h * d, F32_FLOPS_PER_S)
        nxt = rotating(lambda: (q, *_pools(gen, dev, nb, bs, kvh, d, int8)),
                       2 * nb * bs * kvh * d * elem, budget=96 << 20)

        def run_kernel():
            qq, kp, vp, ksp, vsp = nxt()
            ops.paged_decode_attention_kernel(qq, kp, vp, pt, lens, ksp, vsp)

        def run_plain():
            qq, kp, vp, ksp, vsp = nxt()
            ref.ref_paged_decode_attention(qq, kp, vp, pt, lens, ksp, vsp)

        ms = time_ms(run_kernel)
        plain = time_ms(run_plain, iters=5)
        kg = ref.gather_rows(pools[0], pt).float()
        vg = ref.gather_rows(pools[1], pt).float()
        if int8:
            kg = kg * ref.gather_rows(pools[2], pt)[..., None]
            vg = vg * ref.gather_rows(pools[3], pt)[..., None]
        kg, vg = kg.transpose(1, 2), vg.transpose(1, 2)      # (B, H, S, D)
        mask = (torch.arange(mb * bs, device=dev)[None] < lens[:, None])
        mask = mask[:, None, None, :]
        qs = q.reshape(b, h, 1, d)
        lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qs, kg, vg, attn_mask=mask, scale=1.0))
        log(f"  paged_decode_attention {kind}: lens {lens_l}  err {err:.2e} "
            f"(tol {tol:.0e})  kernel {ms:.4f} ms  plain {plain:.4f} ms  "
            f"sdpa {lib:.4f} ms  bound {b_ms:.4f} ms ({b_by})")
        rec[("dec", kind)] = (err, ms, plain, lib, b_ms, b_by)

    # ---- paged prefill prefix: empty prefix, partial pages, padded q rows
    c = 256
    pfx_l = [0, 64, 128, 300, 511, 700, 1, 768]
    qlen_l = [256, 256, 100, 256, 17, 0, 256, 255]
    pfx = torch.tensor(pfx_l, dtype=torch.int32, device=dev)
    qlens = torch.tensor(qlen_l, dtype=torch.int32, device=dev)
    live = [-(-p // bs) + (1 if i % 2 else 0) for i, p in enumerate(pfx_l)]
    for int8 in (False, True):
        kind = "int8" if int8 else "f32"
        pools = _pools(gen, dev, nb, bs, kvh, d, int8)
        pt = _page_table(gen, dev, b, mb, nb, live)
        q = torch.randn((b, c, kvh, hq, d), generator=gen, device=dev) / 8.0
        out, m, l = ops.paged_prefill_attention_kernel(
            q, pools[0], pools[1], pt, pfx, qlens, pools[2], pools[3])
        wo, wm, wl = ref.ref_paged_prefill_attention(
            q.reshape(b, c, h, d), pools[0], pools[1], pt, pfx, pools[2],
            pools[3])
        torch.cuda.synchronize()
        wm = wm[..., 0].transpose(1, 2).reshape(b, c, kvh, hq)
        wl = wl[..., 0].transpose(1, 2).reshape(b, c, kvh, hq)
        wo = wo.reshape(b, c, kvh, hq, d)
        rows = torch.arange(c, device=dev)[None] < qlens[:, None]   # (B, C)
        err = max((out - wo).abs()[rows].max().item(),
                  (m - wm).abs()[rows].max().item(),
                  ((l - wl).abs() / wl.clamp(min=1.0))[rows].max().item())
        tol = 2e-5
        empty_exact = (bool((out[0] == 0).all()) and bool((l[0] == 0).all())
                       and bool((m[0] == -1e30).all()))
        skipped = ~rows
        skipped_exact = (bool((out[skipped] == 0).all())
                         and bool((m[skipped] == -1e30).all()))
        if not (err <= tol and empty_exact and skipped_exact):
            raise AssertionError(
                f"paged_prefill_attention {kind}: err {err:.3g} (tol {tol}), "
                f"empty prefix exact {empty_exact}, skipped rows exact "
                f"{skipped_exact}")
        elem = 1 if int8 else 4
        kv_rows = sum(pfx_l)
        q_rows = sum(qlen_l)
        nbytes = (2 * kv_rows * kvh * d * elem
                  + (8 * kv_rows * kvh if int8 else 0)
                  + q_rows * h * d * 4 + b * c * h * (d + 2) * 4
                  + 4 * b * mb + 8 * b)
        ops_n = 4.0 * sum(p * n for p, n in zip(pfx_l, qlen_l)) * h * d
        b_ms, b_by = bound(nbytes, ops_n, F32_FLOPS_PER_S)
        nxt = rotating(lambda: (q, *_pools(gen, dev, nb, bs, kvh, d, int8)),
                       2 * nb * bs * kvh * d * elem, budget=96 << 20)

        def run_kernel():
            qq, kp, vp, ksp, vsp = nxt()
            ops.paged_prefill_attention_kernel(qq, kp, vp, pt, pfx, qlens,
                                               ksp, vsp)

        def run_plain():
            qq, kp, vp, ksp, vsp = nxt()
            ref.ref_paged_prefill_attention(qq.reshape(b, c, h, d), kp, vp,
                                            pt, pfx, ksp, vsp)

        ms = time_ms(run_kernel)
        plain = time_ms(run_plain, iters=5)
        kg = ref.gather_rows(pools[0], pt).float()
        vg = ref.gather_rows(pools[1], pt).float()
        if int8:
            kg = kg * ref.gather_rows(pools[2], pt)[..., None]
            vg = vg * ref.gather_rows(pools[3], pt)[..., None]
        kg, vg = kg.transpose(1, 2), vg.transpose(1, 2)
        mask = (torch.arange(mb * bs, device=dev)[None] < pfx[:, None])
        mask = mask[:, None, None, :]
        qs = q.reshape(b, c, h, d).transpose(1, 2)
        lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qs, kg, vg, attn_mask=mask, scale=1.0))
        log(f"  paged_prefill_attention {kind}: pfx {pfx_l} q_lens {qlen_l}"
            f"  err {err:.2e} (tol {tol:.0e})  kernel {ms:.4f} ms  plain "
            f"{plain:.4f} ms  sdpa {lib:.4f} ms  bound {b_ms:.4f} ms "
            f"({b_by})")
        rec[("pre", kind)] = (err, ms, plain, lib, b_ms, b_by)

    for key, name, src, replaces in (
            ("dec", "paged_decode_attention",
             "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
             "src/repro/kernels/paged_decode_attention.py:138"),
            ("pre", "paged_prefill_attention",
             "src/repro_torch/kernels/csrc/paged_prefill_attention.cu",
             "src/repro/kernels/paged_prefill_attention.py:215")):
        f, i8 = rec[(key, "f32")], rec[(key, "int8")]
        report.add(name, route="cuda", source=src, replaces=replaces,
                   max_abs_err=max(f[0], i8[0]), ms=f[1], plain_ms=f[2],
                   library_ms=f[3], bound_ms=f[4], bound_by=f[5],
                   int8_ms=i8[1], int8_bound_ms=i8[4],
                   per="one layer's call, f32 pool (int8_* for the int8 pool)")


# ---------------------------------------------------------------------------
# phases 3-10: the main paths through the Engine
# ---------------------------------------------------------------------------


def _requests(n, lo, hi, vocab, seed, shared_len=0, shared_at=()):
    """Seeded prompts; those at ``shared_at`` start with one common
    ``shared_len``-token prefix."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(4, vocab, size=shared_len)
    out = []
    for i in range(n):
        p = rng.integers(4, vocab, size=int(rng.integers(lo, hi + 1)))
        if i in shared_at:
            p = np.concatenate([shared, p])[:max(len(p), shared_len + 1)]
        out.append(p.astype(np.int32))
    return out


def serve(model, params, prompts, dev, max_new, sampling=None, **engine_kw):
    """Serve ``prompts`` greedily, or with the per-request ``sampling``
    keyword dicts; returns the engine, each request's streams (its output,
    or its list of sibling outputs when it has several) and the wall
    time."""
    from repro_torch.serving.engine import Engine
    eng = Engine(model, params, device=dev, **engine_kw)
    for i, p in enumerate(prompts):
        kw = dict(temperature=0.0) if sampling is None else sampling[i]
        eng.submit(p, max_new_tokens=max_new, **kw)
    t0 = time.perf_counter()
    done = sorted(eng.run(), key=lambda r: r.uid)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    bad = [(r.uid, r.error) for r in done if r.error is not None]
    if bad or len(done) != len(prompts):
        raise AssertionError(f"requests failed: {bad}")
    return eng, [list(r.output) if len(r.outputs) == 1 else
                 [list(o) for o in r.outputs] for r in done], wall


def engine_line(tag, eng, streams, wall):
    m = eng.metrics
    toks = sum(len(s) for s in streams)
    dec = m["t_decode"] / max(1, m["decode_steps"]) * 1e3
    n_pre = m["chunk_batch_calls"] if eng.paged else m["prefill_chunks"]
    pre = m["t_prefill"] / max(1, n_pre) * 1e3
    log(f"  {tag}: {len(streams)} requests, {toks} tokens in {wall:.3f} s "
        f"= {toks / wall:.1f} tok/s; {m['decode_steps']} decode steps "
        f"{dec:.3f} ms each; {n_pre} "
        f"{'chunk steps' if eng.paged else 'whole-prompt prefills'} "
        f"{pre:.3f} ms each; prefix hits {m['prefix_hits']} "
        f"({m['prefix_cached_tokens']} tokens); preemptions "
        f"{m['preemptions']}")
    return {"tok_s": toks / wall, "decode_step_ms": dec,
            ("chunk_step_ms" if eng.paged else "prefill_ms"): pre}


def device_launches(prof):
    """(device operations, PyTorch elementwise kernels among them) that a
    profile recorded."""
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.count for e in events),
            sum(e.count for e in events if "elementwise" in e.key))


def decode_step_launches(model, params, dev):
    """Device operations of one dense decode step at 8 slots with the fused
    norm-and-quantize, and with the unfused pair (the norm, then the
    product's own quantization) put back in its place for the count."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import qlinear
    from repro_torch.kernels import build
    from repro_torch.kernels.ref import rms_norm
    from repro_torch.models import layers, transformer
    cache = model.init_cache(8, 64, device=dev)
    tokens = torch.arange(8, device=dev)
    out = {}
    try:
        for name, fn in (("fused", qlinear.norm_qdot),
                         ("unfused", lambda x, g, eps, w: qlinear.qdot(
                             rms_norm(x, g, eps), w))):
            transformer.norm_qdot = layers.norm_qdot = fn
            before = build.LAUNCHES["rmsnorm_quant"]
            model.decode_step(params, cache, tokens)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                model.decode_step(params, cache, tokens)
                torch.cuda.synchronize()
            out[name] = device_launches(prof)
            fused = build.LAUNCHES["rmsnorm_quant"] - before
            if (fused > 0) != (name == "fused"):
                raise AssertionError(
                    f"the {name} decode step launched rmsnorm_quant {fused} "
                    f"times: the swap of norm_qdot no longer reaches the "
                    f"step")
    finally:
        transformer.norm_qdot = layers.norm_qdot = qlinear.norm_qdot
    log(f"  one dense decode step at 8 slots: {out['fused'][0]} device "
        f"operations ({out['fused'][1]} elementwise) with rmsnorm_quant, "
        f"{out['unfused'][0]} ({out['unfused'][1]}) with the unfused pair")
    return out


def profiled(fn):
    """Run ``fn`` under ``torch.profiler``; print the kernels that took the
    most device time and return (fn's result, share of the wall time the
    card was busy).  The profiler's own host overhead lengthens the wall
    time, so the share is a lower bound."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    if busy == 0:
        log("  profiler: no device time recorded (not measured)")
        return out, None
    n_all, n_elem = device_launches(prof)
    log(f"  profiler: card busy {busy:.3f} s of {wall:.3f} s wall "
        f"({100 * busy / wall:.1f}%); {n_all} device operations, {n_elem} "
        "of them PyTorch elementwise kernels; top kernels by device time:")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"    {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:6d}  "
            f"{e.key[:90]}")
    return out, busy / wall


def check_launches(eng, launches, cfg, counted, bits=8):
    """Every kernel of the run's path ran, and exactly as often as the
    path's shape says.  Each decode step: 4 GEMVs per layer + the head, one
    rope and one attention call per layer, and one rmsnorm_quant per
    norm-then-product pair (norm1 -> wqkv, norm2 -> w13 per layer, the
    final norm -> head: 2 per layer + 1).  Paged, each chunk step: the
    MLP's two products per layer, the head's GEMV, one prefix-attention
    call per layer and rmsnorm_quant for norm2 -> w13 and the final norm
    (1 per layer + 1).  Dense, each whole-prompt prefill of S tokens: one
    flash_prefill per layer, the MLP's two products per layer at M = S, the
    head's GEMV and rmsnorm_quant as the chunk step.  Q4_0 weights put every
    product on q4_matvec.  No q8_matmul or tiled q4_matvec call of a served
    path may take its dp4a kernel (``q8_matmul_dp4a`` and
    ``q4_matvec_dp4a`` stay 0, as every counter the path does not set):
    llama2-110m's group 64 with 16-byte aligned codes runs on the tensor
    cores.  The counts are added
    to ``counted`` for the kernels line."""
    from repro_torch.kernels import build
    nl = cfg.n_layers
    d = eng.metrics["decode_steps"]
    gemv = "q8_matvec" if bits == 8 else "q4_matvec"
    gemm = "q8_matmul" if bits == 8 else "q4_matvec"
    want = dict.fromkeys(build.LAUNCHES, 0)
    want[gemv] += (4 * nl + 1) * d
    want["rope"] += nl * d
    want["rmsnorm_quant"] += (2 * nl + 1) * d
    if eng.paged:
        attn = ("paged_decode_attention", "paged_prefill_attention")
        c = eng.metrics["chunk_batch_calls"]
        rows = eng.max_slots * eng.prefill_chunk_tokens
        want[gemm if rows > 32 else gemv] += 2 * nl * c
        want[gemv] += c
        want["rmsnorm_quant"] += (nl + 1) * c
        want[attn[0]] += nl * d
        want[attn[1]] += nl * c
    else:
        attn = ("decode_attention", "flash_prefill")
        pre = [e - s for plan in eng.plan_log for _, s, e in plan["prefills"]]
        for n in pre:
            want[gemm if n > 32 else gemv] += 2 * nl
            want[gemv] += 1
            want["rmsnorm_quant"] += nl + 1
        want[attn[0]] += nl * d
        want[attn[1]] += nl * len(pre)
    path = {gemv, gemm, "rope", "rmsnorm_quant", *attn}
    if launches != want or min(launches[k] for k in path) <= 0:
        raise AssertionError(f"launches {launches} != expected {want}")
    for k, v in launches.items():
        counted[k] = counted.get(k, 0) + v
    log(f"  launches {dict((k, v) for k, v in launches.items() if v)}: "
        f"{4 * nl + 1} {gemv}, {2 * nl + 1} rmsnorm_quant, {nl} rope and "
        f"{nl} {attn[0]} per decode step over {d} steps")


def compare_streams(tag, got, want, prompts, gap_fn, tol):
    """Streams that should agree: equal, or parting only at a step whose
    top-2 logit gap (perturbed by the step's gumbel noise when sampled) is
    below ``tol`` (an int8 activation code flipped by a last-place
    difference upstream moves a logit by up to that).  ``gap_fn`` takes
    the sequence before the step, its prompt length and the stream's
    index."""
    for i, (a, b) in enumerate(zip(got, want)):
        part = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                    None)
        if part is None and len(a) == len(b):
            continue
        part = min(len(a), len(b)) if part is None else part
        seq = np.concatenate([prompts[i], np.asarray(b[:part], np.int32)])
        gap = gap_fn(seq, len(prompts[i]), i)
        log(f"  {tag}: request {i} parts at token {part}, top-2 gap "
            f"{gap:.3g}")
        if not gap < tol:
            raise AssertionError(f"{tag}: request {i} parts at token {part} "
                                 f"with top-2 gap {gap} >= {tol}")
    same = sum(a == b for a, b in zip(got, want))
    log(f"  {tag}: {same}/{len(want)} streams equal; any parting is at a "
        "near-tie")


def _chunk_logits(model, params, seq, device):
    """Logits after ``seq``, computed as one whole-sequence paged chunk."""
    n = len(seq)
    nb = -(-n // 16)
    cache = model.init_paged_cache(1, block_size=16, n_blocks=nb,
                                   max_blocks_per_seq=nb, device=device)
    cache["page_table"] = torch.arange(nb, dtype=torch.int32,
                                       device=device)[None]
    logits, _ = model.prefill_chunk_batch(params, seq[None], cache, [0],
                                          [0], chunk_lens=[n])
    return logits[0]


def _top2_gap(model, params, seq, device):
    top = torch.topk(_chunk_logits(model, params, seq, device), 2).values
    return float(top[0] - top[1])


def _sampled_gap(model, params, device, streams, t, top_p):
    """The perturbed top-2 gap of a sampled step, in logit units: the draw
    after ``seq`` is the argmax of ``logits / t + gumbel`` over the top-p
    nucleus, with the key of stream ``i``'s ``(seed, stream)`` at its
    position, so a logit difference below the gap cannot move it."""
    from repro_torch.core import prng

    def gap(seq, n_prompt, i):
        seed, stream = streams[i]
        logits = _chunk_logits(model, params, seq, device).float()
        key = prng.fold_in(prng.fold_in(prng.prng_key(seed, device),
                                        stream), len(seq) - n_prompt)
        scaled = logits / t
        srt = torch.sort(scaled, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        keep = torch.cumsum(probs, dim=-1) - probs < top_p
        masked = torch.where(scaled >= srt[keep].min(), scaled, -math.inf)
        top = torch.topk(masked + prng.gumbel(key, masked.shape), 2).values
        return float(top[0] - top[1]) * t
    return gap


def check_flip_scale(tag, model, params, prompts, dev):
    """First-token logits of the dense path (one-shot prefill) against the
    paged path (one whole-prompt chunk) on the same weights: under the
    integer arithmetic they differ only by flipped activation codes, which
    must stay within FULL_FLIP_TOL."""
    delta = max((model.prefill(params, {"tokens": p[None]})[0][0]
                 - _chunk_logits(model, params, p, dev)).abs().max().item()
                for p in prompts)
    log(f"  {tag}: first-token logits, one-shot prefill vs paged chunk, "
        f"max |diff| {delta:.4g} over {len(prompts)} prompts (tol "
        f"{FULL_FLIP_TOL})")
    if not delta <= FULL_FLIP_TOL:
        raise AssertionError(f"{tag}: first-token logits differ by {delta}")


# a flipped int8 activation code moves a logit by up to ~3e-2 in the
# reduced config (phase 5) and up to ~7e-2 at full width (dense one-shot
# prefill against the paged chunk, measured on the card: max 0.052 for Q8_0,
# 0.071 for Q4_0 over the 16 phase-3 prompts; 5e-6 without activation
# quantization)
FLIP_TOL = 3e-2
FULL_FLIP_TOL = 0.1
PAGED_KW = dict(max_slots=8, max_seq=1024, page_size=64,
                prefill_chunk_tokens=256)
DENSE_KW = dict(max_slots=8, max_seq=1024, cache_kind="dense")


def main_path(dev, counted):
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models.model import build_model
    cfg = get_config("llama2-110m")
    model = build_model(cfg)
    params = model.quantize(model.init(seed=0, device=dev))
    kw = PAGED_KW
    prompts = _requests(16, 16, 600, cfg.vocab_size, seed=0, shared_len=128,
                        shared_at=(0, 9, 12, 15))
    phase("phase 3: llama2-110m full width, f32 KV pool, 16 greedy requests")
    build.reset_launches()
    eng, streams, wall = serve(model, params, prompts, dev, 32, **kw)
    check_launches(eng, dict(build.LAUNCHES), cfg, counted)
    if eng.metrics["prefix_hits"] < 1:
        raise AssertionError("the shared-prefix requests never hit the "
                             "prefix cache")
    e2e = engine_line("kernel strategy", eng, streams, wall)
    again, e2e["device_busy_share"] = profiled(
        lambda: serve(model, params, prompts, dev, 32, **kw)[1])
    if again != streams:
        raise AssertionError("a second run gave different greedy streams")
    log("  second run (profiled): identical streams")
    e2e["decode_step_launches"] = decode_step_launches(model, params, dev)

    phase("phase 4: llama2-110m full width, int8 KV pool, 8 greedy requests")
    m8 = build_model(cfg.with_(kv_cache_dtype="int8"))
    build.reset_launches()
    eng8, s8, wall8 = serve(m8, params, prompts[:8], dev, 32, **kw)
    check_launches(eng8, dict(build.LAUNCHES), cfg, counted)
    e2e_int8 = engine_line("kernel strategy, int8 pool", eng8, s8, wall8)
    paged = {"float32": streams, "int8": s8}
    return cfg, params, prompts, paged, e2e, e2e_int8


def dense_path(dev, cfg, params, prompts, paged, counted):
    """The dense Engine on the phase-3 requests (f32) and phase-4 requests
    (int8): whole-prompt prefill on flash_prefill, decode on
    decode_attention and rope.  Its streams against the paged ones."""
    from repro_torch.kernels import build
    from repro_torch.models.model import build_model
    out = {}
    for kv, want in paged.items():
        phase(f"phase 7: llama2-110m full width, dense {kv} cache 8 slots x "
              f"1024, {len(want)} greedy requests")
        m = build_model(cfg.with_(kv_cache_dtype=kv))
        reqs = prompts[:len(want)]
        build.reset_launches()
        eng, got, wall = serve(m, params, reqs, dev, 32, **DENSE_KW)
        check_launches(eng, dict(build.LAUNCHES), cfg, counted)
        out[kv] = engine_line(f"dense {kv} cache", eng, got, wall)
        compare_streams(f"dense {kv} vs paged", got, want, reqs,
                        lambda seq, *_: _top2_gap(m, params, seq, dev),
                        FULL_FLIP_TOL)
    check_flip_scale("Q8_0", m, params, prompts[:4], dev)
    return out


def param_bytes(tree):
    if isinstance(tree, dict):
        return sum(param_bytes(v) for v in tree.values())
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return param_bytes({"q": tree.q, "scale": tree.scale})


def q4_path(dev, cfg, prompts, params8, counted):
    """The weights ``launch/serve.py --bits 4`` serves (Q4_0 under
    QuantPolicy(bits=4, min_size=512)) through the paged and the dense
    Engine: q4_matvec is the only GEMM/GEMV kernel."""
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.kernels import build
    from repro_torch.models.model import build_model
    model = build_model(cfg)
    p4 = model.quantize(model.init(seed=0, device=dev),
                        QuantPolicy(bits=4, min_size=512))
    phase(f"phase 8: llama2-110m full width, Q4_0 weights (parameter tree "
          f"with its fused decode copies {param_bytes(p4) / 1e6:.1f} MB "
          f"against {param_bytes(params8) / 1e6:.1f} MB for Q8_0), 8 "
          "greedy requests, paged then dense")
    reqs = prompts[:8]
    out, streams = {}, {}
    for kind, kw in (("paged", PAGED_KW), ("dense", DENSE_KW)):
        build.reset_launches()
        eng, streams[kind], wall = serve(model, p4, reqs, dev, 32, **kw)
        check_launches(eng, dict(build.LAUNCHES), cfg, counted, bits=4)
        out[kind] = engine_line(f"Q4_0 {kind}", eng, streams[kind], wall)
    compare_streams("Q4_0 dense vs paged", streams["dense"],
                    streams["paged"], reqs,
                    lambda seq, *_: _top2_gap(model, p4, seq, dev),
                    FULL_FLIP_TOL)
    check_flip_scale("Q4_0", model, p4, reqs[:4], dev)
    return model, p4, out


def single_stream(dev, model, by_bits):
    """The counterpart of benchmarks/throughput.py:_decode_loop at batch 1
    on the dense cache: prefill 16 tokens, then 64 greedy decode steps."""
    phase("phase 9: batch-1 single stream (prefill 16, decode 64, dense "
          "cache)")
    out = {}
    for name, params in by_bits.items():
        logits, cache = model.prefill(params,
                                      {"tokens": np.ones((1, 16), np.int32)},
                                      max_seq=160)
        logits, cache = model.decode_step(params, cache,
                                          torch.argmax(logits, -1))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(64):
            logits, cache = model.decode_step(params, cache,
                                              torch.argmax(logits, -1))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        out[name] = {"ms_per_token": dt / 64 * 1e3, "tok_s": 64 / dt}
        log(f"  {name}: {dt / 64 * 1e3:.3f} ms/token = {64 / dt:.1f} tok/s")
    return out


def reduced_cpu_vs_card(dev):
    """The reduced config with the same weights: plain versions on the CPU
    against the kernels on the card, on the paged and the dense Engine.
    Logits may differ by the ~3e-2 an int8 activation code flipped by a
    last-place difference moves them (the CPU tests measure this); streams
    may part only at a step whose top-2 gap is below that."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.model import build_model, params_to
    cfg = reduced(get_config("llama2-110m"))
    model = build_model(cfg)
    p_cpu = model.quantize(model.init(seed=0, device="cpu"))
    p_dev = params_to(p_cpu, dev)
    cpu = torch.device("cpu")
    kw = dict(max_slots=4, max_seq=128, page_size=16,
              prefill_chunk_tokens=32)
    prompts = _requests(6, 5, 60, cfg.vocab_size, seed=1, shared_len=32,
                        shared_at=(0, 5))

    def first_logits(params, device):
        cache = model.init_paged_cache(4, block_size=16, n_blocks=32,
                                       max_blocks_per_seq=8, device=device)
        pt = torch.arange(32, dtype=torch.int32).reshape(4, 8)
        cache["page_table"] = pt.to(device)
        toks = np.zeros((4, 32), np.int32)
        lens = np.array([min(len(p), 32) for p in prompts[:4]], np.int32)
        for i, p in enumerate(prompts[:4]):
            toks[i, :lens[i]] = p[:lens[i]]
        logits, _ = model.prefill_chunk_batch(params, toks, cache,
                                              [0, 1, 2, 3], [0] * 4,
                                              chunk_lens=lens)
        return logits.cpu()

    def prefill_logits(params):
        return model.prefill(params, {"tokens": prompts[1][None]},
                             max_seq=128)[0].cpu()

    diff = (first_logits(p_cpu, cpu)
            - first_logits(p_dev, dev)).abs().max().item()
    ddiff = (prefill_logits(p_cpu) - prefill_logits(p_dev)).abs().max().item()
    phase(f"phase 5: reduced config, CPU plain vs card kernels: first chunk "
          f"step logits max |diff| {diff:.3g}, whole-prompt prefill logits "
          f"{ddiff:.3g} (tol {FLIP_TOL})")
    if not (diff <= FLIP_TOL and ddiff <= FLIP_TOL):
        raise AssertionError(f"first-step logits differ by {diff}, {ddiff}")
    for extra in ({}, {"cache_kind": "dense"}):
        _, cpu_streams, _ = serve(model, p_cpu, prompts, cpu, 8, **kw,
                                  **extra)
        _, dev_streams, _ = serve(model, p_dev, prompts, dev, 8, **kw,
                                  **extra)
        compare_streams(f"{extra.get('cache_kind', 'paged')} CPU vs card",
                        dev_streams, cpu_streams, prompts,
                        lambda seq, *_: _top2_gap(model, p_cpu, seq, cpu),
                        FLIP_TOL)
    check_sampling_cpu_vs_card(model, p_cpu, p_dev, prompts, dev, kw)


# the sampled phases' settings (phases 5 and 12)
TEMP, TOP_P = 0.8, 0.95


def check_sampling_cpu_vs_card(model, p_cpu, p_dev, prompts, dev, kw):
    """The threefry gumbel noise on the card equals the CPU's bit for bit;
    sampled streams from both are equal or part only at a near-tie."""
    from repro_torch.core import prng
    cpu = torch.device("cpu")
    keys = prng.split(prng.prng_key(1234), 8)
    want = prng.gumbel(keys, (32000,))
    got = prng.gumbel(keys.to(dev), (32000,)).cpu()
    n_diff = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    phase(f"phase 5: gumbel noise for 8 keys x 32000 on the card vs the "
          f"CPU: {n_diff} of {want.numel()} values differ in any bit")
    if n_diff:
        raise AssertionError(f"threefry gumbel noise differs on the card in "
                             f"{n_diff} values")
    sampling = [dict(temperature=TEMP, top_p=TOP_P, seed=100 + i)
                for i in range(len(prompts))]
    gap = _sampled_gap(model, p_cpu, cpu,
                       [(100 + i, 0) for i in range(len(prompts))], TEMP,
                       TOP_P)
    for extra in ({}, {"cache_kind": "dense"}):
        _, cpu_streams, _ = serve(model, p_cpu, prompts, cpu, 8, sampling,
                                  **kw, **extra)
        _, dev_streams, _ = serve(model, p_dev, prompts, dev, 8, sampling,
                                  **kw, **extra)
        compare_streams(f"sampled (t {TEMP}, top_p {TOP_P}) "
                        f"{extra.get('cache_kind', 'paged')} CPU vs card",
                        dev_streams, cpu_streams, prompts, gap, FLIP_TOL)


def serve_cli(dev, cfg, counted):
    """Phase 11: ``launch/serve.py``'s closed batch at full width, at the
    CLI's own sampling defaults (temperature 1.0, top-p 1.0), for Q8_0 with
    an f32 pool, the int8 pool and Q4_0; Q8_0 twice with one seed gives the
    same streams; then the module entry point itself as a subprocess."""
    from repro_torch.kernels import build
    from repro_torch.launch import serve as cli
    out = {}
    kw = dict(arch="llama2-110m", use_reduced=False, requests=16, slots=8,
              max_seq=1024, max_new=48, device="cuda")
    for tag, extra in (("Q8_0 f32 pool", {}), ("Q8_0 int8 pool",
                                               {"kv_int8": True}),
                       ("Q4_0 f32 pool", {"bits": 4})):
        phase(f"phase 11: launch/serve.py run(), llama2-110m full width, "
              f"{tag}, 16 requests x 48 tokens at temperature 1.0, top_p 1.0")
        build.reset_launches()
        eng, done = cli.run(**kw, **extra)
        check_launches(eng, dict(build.LAUNCHES), cfg, counted,
                       bits=extra.get("bits", 8))
        bad = [(r.uid, r.error) for r in done if r.error is not None]
        if bad or len(done) != 16:
            raise AssertionError(f"serve.run {tag}: failed {bad}")
        streams = [r.outputs for r in done]
        toks = sum(len(o) for r in done for o in r.outputs)
        wall = max(r.t_done for r in done) - min(r.t_enqueue for r in done)
        lat = cli.first_token_latencies(done) * 1e3
        m = eng.metrics
        out[tag] = {"tok_s": toks / wall,
                    "decode_step_ms": m["t_decode"] / m["decode_steps"] * 1e3,
                    "ttft_p50_ms": float(np.median(lat)),
                    "ttft_p95_ms": float(np.percentile(lat, 95))}
        log(f"  {tag}: {toks} tokens over {wall:.3f} s = "
            f"{out[tag]['tok_s']:.1f} tok/s; decode step "
            f"{out[tag]['decode_step_ms']:.3f} ms over {m['decode_steps']} "
            f"steps; TTFT p50 {out[tag]['ttft_p50_ms']:.1f} ms, p95 "
            f"{out[tag]['ttft_p95_ms']:.1f} ms")
        if not extra:
            build.reset_launches()
            eng2, again = cli.run(**kw)
            check_launches(eng2, dict(build.LAUNCHES), cfg, counted)
            if [r.outputs for r in again] != streams:
                raise AssertionError("serve.run with the same seed gave "
                                     "different streams")
            log("  second run with the same seed: identical streams")
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--full",
           "--requests", "16", "--slots", "8", "--max-seq", "1024"]
    phase(f"phase 11: {' '.join(cmd[1:])} as a subprocess")
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(SRC)))
    secs = time.perf_counter() - t0
    for line in res.stdout.splitlines():
        log(f"    {line}")
    if res.returncode != 0 or "[serve] 16/16 requests" not in res.stdout:
        raise AssertionError(f"the serve module exited {res.returncode}: "
                             f"{res.stderr[-2000:]}")
    log(f"  the module entry point ran in {secs:.1f} s (process start, "
        "weights, quantization and the batch)")
    out["module_s"] = secs
    return out


def best_of_n(dev, cfg, params, counted):
    """Phase 12: 4 requests of n_samples=4 at temperature 0.8, top_p 0.95
    on the paged f32 pool at full width: siblings share their prompt's
    blocks and each equals an independent (seed, stream=i) request; then
    the sampler's own cost on (8, 32000) logits."""
    from repro_torch.kernels import build
    from repro_torch.models.model import build_model
    model = build_model(cfg)
    prompts = _requests(4, 100, 400, cfg.vocab_size, seed=7)
    n = 4
    phase(f"phase 12: best-of-{n} at full width, paged f32 pool, 4 requests "
          f"at temperature {TEMP}, top_p {TOP_P}")
    group = [dict(temperature=TEMP, top_p=TOP_P, seed=200 + i, n_samples=n)
             for i in range(len(prompts))]
    build.reset_launches()
    eng, grouped, wall = serve(model, params, prompts, dev, 32, group,
                               **PAGED_KW)
    check_launches(eng, dict(build.LAUNCHES), cfg, counted)
    m = eng.metrics
    log(f"  {len(prompts)} groups of {n}: {m['fanouts']} fanouts, "
        f"{sum(len(o) for g in grouped for o in g)} tokens in {wall:.3f} s; "
        f"peak blocks live {m['blocks_live_peak']}, saved by sharing "
        f"{m['blocks_saved_by_sharing_peak']}; {m['cow_copies']} "
        "copy-on-write block copies")
    if m["fanouts"] != len(prompts) or m["blocks_saved_by_sharing_peak"] <= 0:
        raise AssertionError("the groups did not fan out over shared blocks")
    solo_prompts = [p for p in prompts for _ in range(n)]
    solo = [dict(temperature=TEMP, top_p=TOP_P, seed=200 + i, stream=j)
            for i in range(len(prompts)) for j in range(n)]
    _, reruns, _ = serve(model, params, solo_prompts, dev, 32, solo,
                         **PAGED_KW)
    compare_streams(f"best-of-{n} siblings vs (seed, stream) reruns",
                    [o for g in grouped for o in g], reruns, solo_prompts,
                    _sampled_gap(model, params, dev,
                                 [(200 + i, j) for i in range(len(prompts))
                                  for j in range(n)], TEMP, TOP_P),
                    FULL_FLIP_TOL)
    return eng.metrics["fanouts"], sampler_cost(dev)


def sampler_cost(dev):
    """sample_logits_per_row on (8, 32000) against the greedy argmax: host
    wall ms per call (it is launch-bound), and the device time and device
    operations per call from a profile of five calls."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import prng
    from repro_torch.serving.engine import sample_logits_per_row
    gen = torch.Generator(device=dev).manual_seed(8)
    logits = torch.randn((8, 32000), generator=gen, device=dev) * 0.5
    keys = prng.split(prng.prng_key(3), 8).to(dev)
    t = torch.full((8,), TEMP, device=dev)
    p = torch.full((8,), TOP_P, device=dev)
    rec = {}
    for name, fn in (("sample_logits_per_row",
                      lambda: sample_logits_per_row(keys, logits, t, p)),
                     ("argmax", lambda: torch.argmax(logits, dim=-1))):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 20 * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        rec[name] = {"wall_ms": wall, "device_ms": None,
                     "device_launches": None}
        if events:
            rec[name].update(device_ms=sum(
                e.self_device_time_total for e in events) / 5e3,
                device_launches=device_launches(prof)[0] / 5)
        log(f"  {name} on (8, 32000): {wall:.3f} ms wall per call; device "
            + ("time and operations not measured (the profile recorded no "
               "device events)" if not events else
               f"{rec[name]['device_ms']:.4f} ms, "
               f"{rec[name]['device_launches']} operations per call"))
    return rec


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found: run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    card = card_line()
    log(f"phase 1: card {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    secs = build.build()
    phase(f"phase 1: built {len(build.SIGNATURES)} kernels in {secs:.1f} s")
    for name in build.SIGNATURES:
        tail = (build.BUILD_DIR / f"{name}.log")
        if tail.exists():
            for line in tail.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  {name}: {line.strip()}")

    from repro_torch.core import qlinear
    qlinear.set_default_strategy("kernel")
    report = Report()
    phase("phase 2: kernels against their plain versions")
    check_q8_matvec(report, dev)
    check_q8_matmul(report, dev)
    check_attention(report, dev)
    check_q4(report, dev)
    check_dense_attention(report, dev)
    check_flash_prefill(report, dev)
    check_rope(report, dev)
    check_rmsnorm_quant(report, dev)

    counted = {}
    cfg, params, prompts, paged, e2e, e2e_int8 = main_path(dev, counted)
    reduced_cpu_vs_card(dev)
    phase(f"phase 6: end to end (f32 pool) {json.dumps(e2e)}; int8 pool "
          f"{json.dumps(e2e_int8)}")
    dense = dense_path(dev, cfg, params, prompts, paged, counted)
    model, p4, q4 = q4_path(dev, cfg, prompts, params, counted)
    b1 = single_stream(dev, model, {"Q8_0": params, "Q4_0": p4})
    phase(f"phase 10: dense cache {json.dumps(dense)}; Q4_0 {json.dumps(q4)}; "
          f"batch 1 {json.dumps(b1)}")
    cli = serve_cli(dev, cfg, counted)
    fanouts, sampler = best_of_n(dev, cfg, params, counted)
    phase(f"phase 12: serve CLI {json.dumps(cli)}; best-of-4 fanouts "
          f"{fanouts}; sampler {json.dumps(sampler)}")
    kernels = []
    for name, row in report.rows.items():
        kernels.append({"name": name, **row,
                        "launches": counted.get(name, 0)})
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
