"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--only phase2,main_path,bf16_paths,ssm_paths,
                                  vlm_audio_paths,interleave_paths,
                                  train_paths,mesh_paths,analysis_paths]

With no argument every group of phases runs, in that order; ``--only``
runs a selection, each group with the phase-2 checks of its own shapes.

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` (nine
sources, ten entry points: ``rmsnorm_quant.cu`` also holds ``quantize``;
phase 1), holds each against its plain PyTorch version at the shapes the
served paths give it (phase 2), and serves llama2-110m at full width
through ``repro_torch.serving.engine.Engine`` on the card: the paged pool
with f32 and int8 KV (phases 3-4), the reduced config on the card against
the same weights on the CPU, greedy and sampled, with the threefry gumbel
noise bitwise (phase 5), the dense per-slot cache with f32 and int8 KV
(phase 7), Q4_0 weights on both caches (phase 8), the paper's batch-1
single stream (phase 9), ``launch/serve.py`` at its own sampling defaults
(phase 11), best-of-4 sampling groups over shared blocks (phase 12) and
open-loop serving (phase 13): seeded Poisson arrivals through
``serving/async_serving.py`` bitwise equal to the closed batch, a decode
step dispatched under CUDA's sync debug mode, deadlines, shedding and
``serve.py --open-loop``, speculative decoding (phase 14): n-gram drafts
verified on the f32 pool at 8 x 5 rows and the int8 pool at 8 x 4, f32
weights, a replay oracle, always-wrong drafts and a draft model, the
verify step's logits held against the decode step's, and the streams
against the plain ones, to a fixed bound counted from the rounding sites
where the two paths part (``verify_decode_bound``, at the plain
versions' logits' scale), which planted faults on the verify path must
exceed (``VERIFY_CONTROLS``, ``F32_VERIFY_CONTROLS``), and the
fault domain (phase 15): retries, isolation, NaN rows (a verify row too),
the allocator audit and slow steps, survivors bitwise.  Phase 2 also
holds the kernels at the verify's shapes, and every kernel at
llama3.2-3b's (GQA 24/8, head_dim 128, bf16 and int8 pools, K 3072 and
8192, the 128256-row head): the seven of the paged path, and since then
the dense cache's ``flash_prefill`` (bf16, 24 / 8 heads, one prompt of
17..1024 tokens) and ``decode_attention`` (bf16 and int8 caches, bitwise
equal to the paged kernel) and ``q4_matvec`` (GEMVs and the tiled M =
2048 path), ``q8_matvec`` at phi4-mini-3.8b's 200192-row head, and every
kernel of the paged path at glm4-9b's shapes (``check_glm4``: both decode
attentions at 16 query heads a KV head of 128, cut into two head groups,
bitwise equal to two calls on q's halves and to each other; the GEMVs at
K 13696 and the 151552-row head; ``q8_matmul`` at N 27392 and K 13696;
``quantize`` at K 13696; ``rmsnorm_quant`` at K 4096, 0 codes apart; the
prefix attention at HQ 16; rope on 34 heads) and at command-r-35b's
(``check_command_r``: the GEMVs at K 8192 and 22528 and the 256000-row
head, ``q8_matmul`` at N 45056, K 22528 and the verify step's head,
``rmsnorm_quant`` at K 8192, where PyTorch's row mean splits a row over
its warp-rows, 0 codes apart with every scale equal, the decode and
prefix attentions at 8 query heads a KV head, rope on 72 heads at theta
8e6) and at qwen3-moe-30b-a3b's (``check_qwen3_moe``: both decode
attentions, the prefix attention and ``flash_prefill`` at 4 KV heads x HQ
8 x D 64 in bf16, the first bf16 config at D 64; the GEMVs at K 2048 and
the 152064-row head, the verify head at M 40, ``rmsnorm_quant`` and
``quantize`` at K 2048, rope on 36 heads at theta 1e6) and at the SSM
families' (``check_mamba2``, ``check_zamba2``: the GEMVs of a decode
step, wB / wC at N 128 and 64, out_proj at K 2048 and 4096, the 50432-
and 32000-row heads, ``q8_matmul`` at one 577-token prefill,
``rmsnorm_quant`` on the gated norm's f32 rows at K 2048 and 4096,
``quantize`` at K 1024 and 2048, and zamba2-1.2b's shared block:
``decode_attention`` at 32 KV heads x HQ 1 x D 64, bf16 and int8,
``flash_prefill`` at 32 / 32 heads of 64, rope on 64 heads); phase 5
also runs the reduced llama3.2-3b on both caches; phase 16 serves
llama3.2-3b at full width (bf16 compute; its 28 layers cut to 14 for
time) on a bf16 and an int8 pool, held against the same engine on the
plain versions; phase 17 serves it on the dense cache (bf16, int8) and
with Q4_0 weights (paged and dense); phase 18 serves phi4-mini-3.8b at
full width (vocab 200064; its 32 layers cut to 12 for time) on a bf16
pool, phase 19 glm4-9b (d_model 4096, 32 query heads over 2 KV heads of
128, d_ff 13696, vocab 151552; its 40 layers cut to 4 for time) the same
way, phase 20 command-r-35b (d_model 8192, 64 query heads over 8 KV
heads of 128, d_ff 22528, vocab 256000; its 40 layers cut to 4) and
phase 21 qwen3-moe-30b-a3b (d_model 2048, 32 query heads over 4 KV heads
of 64, 128 experts of d_ff 768, top 8, vocab 151936: the MoE router and
both dispatches in plain PyTorch, as the reference's jnp; its 48 layers
cut to 4), its f32 tree never held: phases 18-21 draw through
``Model.init_quantized``, which phase 16 holds bitwise against
``Model.quantize(Model.init(0))``, and phase 21 again for the MoE tree
at 2 layers.  Phases 22 and 23 serve the SSM families at full width and
depth, mamba2-370m (48 Mamba2 layers) and zamba2-1.2b (38 Mamba2 layers
and one shared attention block applied after every 6th), through
``Engine(model, params)`` with the default ``cache_kind``, which falls
back to the dense per-slot cache; the scan, the convolutions and the
recurrence are plain PyTorch, as the reference's jnp; their logits are
held to the fixed bound counted from the Mamba2 layer's and the shared
block's code (``delta_sites``), the one-shot prefill at every position
(``every_position_lambda``).  Phase 24 serves qwen2-vl-7b (the vlm
family: 28 query heads over 4 KV heads of 128, d_ff 18944, vocab 152064,
M-RoPE; its 28 layers cut to 4 for time) as phases 18-21 on text tokens,
then one model-level ``Model.prefill`` on stub patch embeddings at three
distinct M-RoPE position streams (``vlm_prefill``); phase 25 runs
whisper-small (the audio family's encoder-decoder) at full width and
depth at the model level, as the reference serves it (its engine cannot
prefill frames, so the port's refuses the family): ``Model.prefill`` on
stub frames, then 32 greedy ``decode_step``s on a bf16 and an int8
cache, held to the fixed bound at every prefill position and decode step
(``whisper_plain_delta``) with its own planted faults
(``_whisper_controls``); phase 2 holds the kernels at both configs'
shapes (``check_qwen2_vl``, ``check_whisper``).  Phase 26 serves
llama4-maverick-400b-a17b (the llama4 interleave: a dense layer and an
MoE layer in turn, d_model 5120, 40 query heads over 8 KV heads of 128,
128 experts of d_ff 8192, top 1, vocab 202048; its 48 layers, ~424 GB of
Q8_0, cut to 4, two patterns) on the dense fallback, as the reference's
engine serves it, on a bf16 and an int8 KV cache, its memory peaks
printed; phase 2 holds the seven kernels of that path at its shapes
(``check_llama4``: HQ 5, ``rmsnorm_quant`` at K 5120 on its 40-float4
plan).  Phase 27 (``train_paths``) trains: ``launch/train.py``'s ``run``
(through ``launch/steps.py``'s ``jit_train_step`` on ``make_host_mesh()``,
a world of one over NCCL) takes llama2-110m at full width and depth 30
steps of 8 x 256 (loss, AdamW, the synthetic TinyStories stream, async
checkpoints; every loss finite and falling), one step on the card against the same step on the
CPU, a resume that runs only the remaining steps on an uninterrupted
run's batches, then ``serve.py --ckpt-dir`` serves the trained Q8_0
weights on the kernels (held to ``plain_delta_bound``) and
``ggml_export`` writes them, the same bytes on the card as on the CPU;
last, llama3.2-3b at full width and depth takes 4 steps, its peak memory
printed against the reckoning.  Phase 29 (``train_paths``, after phase
27) trains llama2-110m at full width and depth 10 steps of 8 x 256 through
``jit_train_step`` on ``make_host_mesh()`` and through the plain
``make_train_step`` in turns from the same seed: every metric and the
state after the last step bitwise equal, both steps timed, the peak
memory printed, and the mesh run's checkpoint restored in the plain
trainer bitwise.  Phase 32 (``train_paths``, after phase 29) trains the
MoE family the same way: qwen3-moe-30b-a3b at full width, cut to
``MOE_TRAIN_LAYERS`` of its 48 layers, ``MOE_TRAIN_STEPS`` steps of
8 x 256 through the executor (whose MoE hands its expert products to
the expert-parallel ``_TrainTP.experts`` through ``moe_mlp(experts=)``,
each collective skipped on a world of one) and the plain step (the
default expert products) in turns,
bitwise, the step times and the peak memory beside the card's name and
power limit.  Training launches no kernel: the
reference's training reaches no Pallas kernel (its loss runs jnp alone)
and no kernel of ``src/repro/`` has a backward (no ``custom_vjp``), so
the port's loss is plain PyTorch under autograd; the kernels phase 27
exercises are those the served, trained weights reach.  Phase 28
(``mesh_paths``) serves on the port's tensor-parallel mesh: phase 2
first holds the six kernels phase 28 launches against their plain
versions at llama2-110m's shapes (as ``train_paths`` does), then
launches both paged attentions on every KV-head slice a rank of a mesh
of 2 and of 4 holds, at llama2-110m's heads (f32 and int8 pools) and
llama3.2-3b's (bf16 and int8), each slice bitwise equal to the same
heads of one launch over every head (``check_head_slices``); then
``Engine(mesh=make_serve_mesh(1))``, a world of one over NCCL, serves
llama2-110m at full width and depth (Q8_0, f32 and int8 pools, phase 3's
16 requests, greedy) against the unsharded engine on the same weights:
the streams bitwise, the launches equal; then ``serve.py --mesh 1``
against ``serve.py``.  Phase 30 (``mesh_paths``, after phase 28, in a
world of one over NCCL of its own) runs the serve-side executors of
``launch/steps.py`` on ``make_host_mesh()`` at llama2-110m's full width
and depth (Q8_0, f32 and int8 dense caches): ``jit_prefill_step`` on a
prefill cell of 8 x 512, then ``jit_serve_step`` for 32 greedy steps and
``jit_serve_sample_step`` for 32 steps from fixed threefry keys on a
decode cell of 8 x 1024 (its cache the one-shot prefill of phase 3's
first 8 prompts), each against ``make_prefill_step`` /
``make_serve_step`` / ``make_serve_sample_step`` on the same weights:
logits, caches and tokens bitwise at every step, the launches equal and
exact (``check_launches``); phase 2 holds ``decode_attention`` on every
KV-head slice as well.  Mesh sizes above one need more than one card; the
CPU tests run them over gloo.  Phase 31 (``analysis_paths``) holds the
analysis tools on the card: phase 30's two cells run on the kernels under
the operation counter (``launch/flops.py``), each count equal to the
same step's meta dry run (``launch/dryrun.py`` in a fake world of one)
exactly, the collective tally empty, the real shards' bytes the dry
run's ``argument_bytes``; the measured step printed beside the dry run's
estimates; and ``python -m repro_torch.launch.dryrun`` at full size in
two subprocesses (llama3.2-3b decode_32k on 16 x 16, qwen3-moe-30b-a3b
prefill_32k on 2 x 16 x 16), each writing the reference's record.  On
every llama3.2-3b, phi4, glm4, command-r, qwen3-moe, mamba2, zamba2 and
llama4 path the kernels' logits are held against the plain versions' on
the same inputs to a fixed bound derived from bf16 and Q8_0 rounding
(``plain_delta_bound``), with each kernel's share: the difference with
only that kernel on its plain version, and with only it launched
(``kernel_plain_delta``); planted wiring faults, the controls of that
bound (a GEMV's K loop one group short, GQA groups on the wrong KV head,
the one-shot prefill's causal diagonal one key short), must each move
the logits past it, and a decode length one short is measured beside
them. On the MoE path the routes are pinned to the plain run's for that
check (``moe_routes``), then one run with free routes counts the flipped
routing decisions, each first flip held to its layer's fixed gap bound
(``route_flips``), and the same planted faults with free routes must
each flip a decision past it. Every served path resets the launch
counters before it runs and asserts exactly the launches its shape
implies after.  Any failed phase exits
non-zero.  The last line of standard output is ``{"ok": true, "device":
{...}}``; the lines before it give the card's name and power limit and
list every kernel with its launches on the main paths, its error and its
times.

It imports nothing of JAX or of the JAX package.  With no CUDA device, or
without the rest of the repository beside it, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import contextlib
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
BF16_FLOPS_PER_S = 989e12


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


def _gemv_step(kernel, plain, name, operands, layer, head, layers, dev):
    """Check and time a decode step's GEMVs (``_quant_timed``): each of
    ``layer``'s (N, K) -- or (N, K, calls a step), where a shape's count is
    not ``layers`` -- and the ``head`` at M = 1 and 8 slots.  Returns the
    M = 8 step's sums, each layer GEMV times its count plus the head
    (``err`` over both M)."""
    step = dict.fromkeys(("err", "ms", "plain", "lib", "bound"), 0.0)
    for m in (1, 8):
        for shape in list(layer) + [head]:
            n, k = shape[:2]
            times = 1 if shape is head else (
                shape[2] if len(shape) > 2 else layers)
            err, ms, plain_ms, lib, b_ms, _ = _quant_timed(
                kernel, plain, name, operands, m, n, k, dev)
            step["err"] = max(step["err"], err)
            if m == 8:
                for key, v in (("ms", ms), ("plain", plain_ms), ("lib", lib),
                               ("bound", b_ms)):
                    step[key] += times * v
    return step


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
    step = _gemv_step(kernel, plain, "q8_matvec", operands, layer, head,
                         12, dev)
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


def q8_matmul_chunk(dev, m, operands, shapes=((4096, 768), (768, 2048)),
                    layers=12):
    """The chunk step's MLP products at m rows, ``layers`` x (w13, w2)
    (``shapes``: llama2-110m's by default; a shape (N, K, calls) takes its
    own count): each call checked (bitwise) and timed by
    ``_quant_timed``, with ``torch._int_mm`` on the raw codes beside it
    for information only (the tensor cores' integer product without the
    group scales).  Returns the per-step sums.  Runs on any tree's
    ``q8_matmul_kernel``, so parent and change can be timed in turns."""
    from repro_torch.kernels import ops, ref
    chunk = {"err": 0.0, "ms": 0.0, "plain": 0.0, "lib": 0.0, "bound": 0.0}
    for shape in shapes:
        n, k = shape[:2]
        times = shape[2] if len(shape) > 2 else layers
        err, ms, plain, lib, b_ms, b_by = _quant_timed(
            ops.q8_matmul_kernel, ref.ref_q8_matmul, "q8_matmul", operands,
            m, n, k, dev)
        chunk["err"] = max(chunk["err"], err)
        chunk.setdefault("by", b_by)      # w13's: the larger product
        for key, v in (("ms", ms), ("plain", plain), ("lib", lib),
                       ("bound", b_ms)):
            chunk[key] += times * v
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
    what = (f"{layers} x (w13, w2)" if all(len(x) == 2 for x in shapes)
            else f"{sum(x[2] for x in shapes)} products")
    log(f"  q8_matmul per chunk step ({what}, M={m}): kernel "
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


def q4_matmul_chunk(dev, m, operands, shapes=((4096, 768), (768, 2048)),
                    layers=12):
    """The Q4_0 chunk step's MLP products at m rows, ``layers`` x (w13, w2)
    (``shapes``: llama2-110m's by default): each call checked (bitwise)
    and timed by ``_quant_timed``, with ``q8_matmul`` on the unpacked codes
    of the same weights beside it (the same function at Q8_0's bytes;
    information only).  Returns the per-step sums.  Runs on any tree's
    ``q4_matvec_kernel``, so parent and change can be timed in turns."""
    from repro_torch.core.quantization import _unpack_nibbles
    from repro_torch.kernels import ops, ref
    chunk = {"err": 0.0, "ms": 0.0, "plain": 0.0, "lib": 0.0, "bound": 0.0,
             "q8": 0.0}
    for n, k in shapes:
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
            chunk[key] += layers * v
    log(f"  q4_matvec per chunk step ({layers} x (w13, w2), M={m}): kernel "
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
    step = _gemv_step(kernel, plain, "q4_matvec", operands, layer, head,
                         12, dev)
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


def dense_decode_case(gen, dev, lens_l, int8, *, s=1024, kvh=12, hq=1,
                      d=64, timed=False, yardsticks=True, bf16=False,
                      gqa=False):
    """One decode_attention call on a (B, S, KVH, D) cache (f32, bf16 with
    ``bf16``, or int8) against its plain version (tolerance 2e-5; a
    length-0 row exactly 0) and bitwise against paged_decode_attention on
    the identity page table over the same rows (pages of 64, a table
    ceil(S / 64) wide; where S is no multiple of 64 the pool's last page
    is padded with zeros no length reaches).  ``timed``: also its
    device time on L2-cold caches and its bound; ``yardsticks``: the plain
    version's and SDPA's (on the dequantized K/V, repeated over the query
    heads, or with ``gqa`` indexed by SDPA's ``enable_gqa``) times beside
    it.  Returns a dict with the inputs of the call and its output."""
    from repro_torch.core.quantization import quantize_rows
    from repro_torch.kernels import ops, ref
    b, h = len(lens_l), kvh * hq
    lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)

    def cache():
        k = torch.randn((b, s, kvh, d), generator=gen, device=dev)
        v = torch.randn((b, s, kvh, d), generator=gen, device=dev)
        if bf16:
            return k.bfloat16(), v.bfloat16(), None, None
        if not int8:
            return k, v, None, None
        (kq, ks), (vq, vs) = quantize_rows(k), quantize_rows(v)
        return kq, vq, ks, vs

    kind = "int8" if int8 else "bf16" if bf16 else "f32"
    k, v, ksc, vsc = cache()
    q = torch.randn((b, kvh, hq, d), generator=gen, device=dev) / math.sqrt(d)
    got = ops.decode_attention_kernel(q, k, v, lens, ksc, vsc)
    want = ref.ref_decode_attention(q, k, v, lens.reshape(b, 1), ksc, vsc)
    mb = -(-s // 64)
    pt = torch.arange(b * mb, dtype=torch.int32, device=dev).reshape(b, mb)
    pool = [None if t is None else torch.cat(
        [t, t.new_zeros((b, mb * 64 - s, *t.shape[2:]))], 1).reshape(
            b * mb, 64, *t.shape[2:]) for t in (k, v, ksc, vsc)]
    paged = ops.paged_decode_attention_kernel(q, pool[0], pool[1], pt,
                                              lens, pool[2], pool[3])
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    tol = 2e-5   # online vs one-pass softmax: f32 summation order only
    zero = all(got[i].abs().max().item() == 0.0
               for i, n in enumerate(lens_l) if n <= 0)
    if not (err <= tol and zero and torch.equal(got, paged)):
        raise AssertionError(
            f"decode_attention {kind} S {s} lens {lens_l}: err {err:.3g} "
            f"(tol {tol}), len=0 rows exactly 0: {zero}, bitwise equal to "
            f"the paged kernel: {torch.equal(got, paged)}")
    rec = {"err": err, "args": (q, k, v, lens, ksc, vsc), "out": got}
    if not timed:
        return rec
    elem = 1 if int8 else 2 if bf16 else 4
    nrows = sum(min(max(n, 0), s) for n in lens_l)
    nbytes = (2 * nrows * kvh * d * elem + (8 * nrows * kvh if int8 else 0)
              + 2 * b * h * d * 4 + 4 * b)
    rec["bound"], rec["by"] = bound(nbytes, 4.0 * nrows * h * d,
                                    F32_FLOPS_PER_S)
    nxt = rotating(lambda: (q, *cache()), 2 * b * s * kvh * d * elem,
                   budget=96 << 20)

    def run_kernel():
        qq, kk, vv, kks, vvs = nxt()
        ops.decode_attention_kernel(qq, kk, vv, lens, kks, vvs)

    def run_plain():
        qq, kk, vv, kks, vvs = nxt()
        ref.ref_decode_attention(qq, kk, vv, lens.reshape(b, 1), kks, vvs)

    rec["ms"] = time_ms(run_kernel)
    line = (f"  decode_attention {kind}: B {b} x S {s}, lens {lens_l}  err "
            f"{err:.2e} (tol {tol:.0e}), bitwise = paged kernel  kernel "
            f"{rec['ms']:.4f} ms  bound {rec['bound']:.4f} ms ({rec['by']})")
    if yardsticks:
        rec["plain"] = time_ms(run_plain, iters=5)
        kf, vf = k.float(), v.float()
        if int8:
            kf, vf = kf * ksc[..., None], vf * vsc[..., None]
        rep = 1 if gqa else hq
        kf = torch.repeat_interleave(kf, rep, dim=2).transpose(1, 2)
        vf = torch.repeat_interleave(vf, rep, dim=2).transpose(1, 2)
        mask = (torch.arange(s, device=dev)[None] < lens[:, None])
        mask = mask[:, None, None, :]
        qs = q.reshape(b, h, 1, d)
        rec["lib"] = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qs, kf, vf, attn_mask=mask, scale=1.0, enable_gqa=gqa))
        line += f"  plain {rec['plain']:.4f} ms  sdpa {rec['lib']:.4f} ms"
    log(line)
    return rec


def check_dense_attention(report, dev):
    """decode_attention at the dense decode's shapes (8 slots x 1024,
    f32 and int8) and at batch 1 (len 80 and 1024), timed; bitwise against
    the paged kernel on the same rows at S = 1024 and at S = 832 (a table
    13 pages wide, no multiple of the 8 splits)."""
    gen = torch.Generator(device=dev).manual_seed(3)
    rec = {}
    for int8 in (False, True):
        rec[int8] = dense_decode_case(gen, dev, DECODE_LENS, int8,
                                      timed=True)
        dense_decode_case(gen, dev, [0, 1, 64, 832, 700, 511, 513, 900],
                          int8, s=832)
    b1 = {n: dense_decode_case(gen, dev, [n], False, timed=True)
          for n in (80, 1024)}
    log("  decode_attention: bitwise equal to paged_decode_attention at S = "
        "1024 and S = 832 (13 pages), f32 and int8")
    f, i8 = rec[False], rec[True]
    report.add("decode_attention", route="cuda",
               source="src/repro_torch/kernels/csrc/decode_attention.cu",
               header="src/repro_torch/kernels/csrc/flash_decode.cuh",
               replaces="src/repro/kernels/decode_attention.py:206",
               max_abs_err=max(f["err"], i8["err"]), ms=f["ms"],
               plain_ms=f["plain"], library_ms=f["lib"], bound_ms=f["bound"],
               bound_by=f["by"], int8_ms=i8["ms"],
               int8_bound_ms=i8["bound"], b1_80_ms=b1[80]["ms"],
               b1_80_bound_ms=b1[80]["bound"], b1_1024_ms=b1[1024]["ms"],
               b1_1024_bound_ms=b1[1024]["bound"],
               b1_1024_library_ms=b1[1024]["lib"],
               per="one layer's call, f32 cache (int8_* for the int8 cache, "
                   "b1_* at batch 1)")


def check_verify_edges(report, dev):
    """The kernels at the speculative verify's shapes, untimed, at their
    checks' tolerances (a GEMV within 2e-5, a GEMM bitwise): q8_matvec at
    M = 32 = 8 slots x (3 + 1) and q8_matmul at M = 40 = 8 x (4 + 1), at
    the head's N = 32000 and the MLP's products; paged_prefill_attention
    with chunks of 4 and 5 rows at 8 slots over phase 2's prefix lengths,
    f32 and int8 pools; decode_attention at S = 613, no multiple of a page
    (the draft model's dense cache holds len(context) + k positions).  Each
    kernel's worst error joins its row of the kernels line."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(9)
    operands = _q8_operands(gen, dev)
    worst = {}

    def note(name, err):
        worst[name] = max(worst.get(name, 0.0), err)
    for name, kernel, m in (("q8_matvec", ops.q8_matvec_kernel, 32),
                            ("q8_matmul", ops.q8_matmul_kernel, 40)):
        for n, k in ((32000, 768), (4096, 768), (2048, 768), (768, 2048)):
            note(name, _quant_check(kernel, ref.ref_q8_matmul, name, m, n, k,
                                    64, *operands(m, n, k))[0])
    for c in (4, 5):
        for int8 in (False, True):
            note("paged_prefill_attention", paged_prefill_case(
                gen, dev, PREFILL_PFX, [c, c, 1, c - 1, c, 0, c, 2], int8,
                c=c)["err"])
    for int8 in (False, True):
        note("decode_attention", dense_decode_case(
            gen, dev, [613, 609, 1, 0, 300, 612, 64, 65], int8,
            s=613)["err"])
    for name, err in worst.items():
        row = report.rows.get(name)
        if row is not None:
            row["max_abs_err"] = max(row["max_abs_err"], err)
    log(f"  verify shapes: q8_matvec at M=32 and q8_matmul at M=40 (N 32000, "
        f"4096, 2048 at K 768; N 768 at K 2048), paged_prefill_attention at "
        f"C = 4 and 5 (8 slots, f32 and int8), decode_attention at S = 613 "
        f"(f32 and int8): within tolerance, worst "
        f"{json.dumps({k: float(f'{v:.3g}') for k, v in worst.items()})}")



# llama3.2-3b (phase 2's second part, phase 16): 28 layers, d_model 3072,
# 24 query heads over 8 KV heads of 128 (HQ = 3), d_ff 8192, vocab 128256,
# bf16 compute.  Its decode GEMVs (wqkv, wo_f, w13, w2) and head, and the
# chunk step's MLP GEMMs (w13, w2) at 8 slots x 256 rows.
L3 = "llama3.2-3b"
L3_LAYERS, L3_D, L3_KVH, L3_HQ, L3_HD = 28, 3072, 8, 3, 128
L3_GEMV = [(5120, 3072), (3072, 3072), (16384, 3072), (3072, 8192)]
L3_HEAD = (128256, 3072)
L3_GEMM = ((16384, 3072), (3072, 8192))
P4 = "phi4-mini-3.8b"
# rmsnorm_quant on bf16 input rounds the norm to bf16 before quantizing,
# as the plain rms_norm returns it: where the kernel's f32 norm parted from
# the plain one's by an ulp, that rounding could flip by one bf16 ulp (at
# most 2^-7 of the value), moving the group's scale by 2^-7 relative and a
# code by 127 * 2^-7 < 1 for the scale and < 1 for the value itself: at
# most 2 codes.  The f32 tolerances (1 code, 3e-7) hold where no rounding
# flips; the count of differing codes is printed.
BF16_NORM_CODES, BF16_NORM_SCALE = 2, 2.0 ** -7


def check_llama3(report, dev):
    """The seven kernels of the paged path at llama3.2-3b's shapes, each
    against its plain version at its check's tolerance and timed beside it
    and its library call: q8_matvec at the decode GEMVs and the head (M =
    1 and 8), summed per decode step; q8_matmul at the chunk step's MLP
    (M = 8 x 256), bitwise; paged_decode_attention and
    paged_prefill_attention at HQ 3, D 128 on bf16 and int8 pools (phase
    2's lens and prefixes, B = 1 too, -1 entries inside rows);
    rmsnorm_quant on bf16 rows at K = 3072 (M = 1, 8, 2048); quantize on
    bf16 rows at wo_f's and w2's K = 3072 and 8192, bitwise; rope on the q
    and k heads of a bf16 qkv row (32 heads of 128), bitwise.  Each adds a
    row ``<kernel>@llama3.2-3b`` to the kernels line."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(25)
    operands = _q8_operands(gen, dev)
    src = "src/repro_torch/kernels/csrc/"

    # ---- q8_matvec: a decode step's 4 x 28 layer GEMVs + the head
    step = _gemv_step(ops.q8_matvec_kernel, ref.ref_q8_matmul, "q8_matvec",
                      operands, L3_GEMV, L3_HEAD, L3_LAYERS, dev)
    log(f"  {L3} q8_matvec per decode step ({L3_LAYERS} layers x 4 + head, "
        f"M=8): kernel {step['ms']:.4f} ms, torch.matmul {step['lib']:.4f} "
        f"ms, bound {step['bound']:.4f} ms, "
        f"{100 * step['bound'] / step['ms']:.1f}% of it")
    report.add(f"q8_matvec@{L3}", route="cuda", source=src + "q8_matvec.cu",
               replaces="src/repro/kernels/q8_matvec.py:67",
               max_abs_err=step["err"], ms=step["ms"], plain_ms=step["plain"],
               bound_ms=step["bound"], bound_by="bytes",
               library_ms=step["lib"],
               per=f"decode step at 8 slots: {4 * L3_LAYERS} layer GEMVs "
                   "(N x K 5120 x 3072, 3072 x 3072, 16384 x 3072, 3072 x "
                   "8192) + head 128256 x 3072")

    # ---- q8_matmul: the chunk step's MLP, 28 x (w13, w2) at 2048 rows
    chunk = q8_matmul_chunk(dev, 2048, operands, shapes=L3_GEMM,
                            layers=L3_LAYERS)
    report.add(f"q8_matmul@{L3}", route="cuda", source=src + "q8_matmul.cu",
               replaces="src/repro/kernels/q8_matmul.py:92",
               max_abs_err=chunk["err"], ms=chunk["ms"],
               plain_ms=chunk["plain"], bound_ms=chunk["bound"],
               bound_by=chunk["by"], library_ms=chunk["lib"],
               per=f"chunk step at 8 x 256 rows: {L3_LAYERS} x (w13 16384 x "
                   "3072, w2 3072 x 8192); bitwise")

    # ---- the attentions at HQ 3, D 128 on bf16 and int8 pools
    geo = dict(kvh=L3_KVH, hq=L3_HQ, d=L3_HD)
    dec, pre = {}, {}
    for kind in ("bf16", "int8"):
        flags = dict(int8=kind == "int8", bf16=kind == "bf16")
        dec[kind] = paged_decode_case(gen, dev, DECODE_LENS, timed=True,
                                      **flags, **geo)
        pre[kind] = paged_prefill_case(gen, dev, PREFILL_PFX, PREFILL_QLENS,
                                       timed=True, **flags, **geo)
    dec_b1 = paged_decode_case(gen, dev, [1024], False, bf16=True,
                               timed=True, **geo)
    pre_b1 = paged_prefill_case(gen, dev, [768], [256], False, bf16=True,
                                timed=True, **geo)
    worst_dec = max(r["err"] for r in (*dec.values(), dec_b1))
    worst_pre = max(r["err"] for r in (*pre.values(), pre_b1))
    mb, bs = 16, 64
    for kind in ("bf16", "int8"):
        flags = dict(int8=kind == "int8", bf16=kind == "bf16")
        holes = _holes_table(gen, dev, mb, len(HOLE_LENS) * mb, bs,
                             HOLE_LENS)
        worst_dec = max(worst_dec, paged_decode_case(
            gen, dev, HOLE_LENS, pt=holes, **flags, **geo)["err"])
        worst_pre = max(worst_pre, paged_prefill_case(
            gen, dev, HOLE_LENS, [7, 20, 256, 100], pt=holes, **flags,
            **geo)["err"])
        for lens_l in ([127, 128, 129, 511, 512, 513, 1, 0],):
            worst_dec = max(worst_dec, paged_decode_case(
                gen, dev, lens_l, **flags, **geo)["err"])
        worst_dec = max(worst_dec, paged_decode_case(
            gen, dev, [17, 300, 0, 1000], bs=16, mb=64, **flags,
            **geo)["err"])
        worst_pre = max(worst_pre, paged_prefill_case(
            gen, dev, [0, 17, 300, 1000], [256, 100, 1, 256], bs=16, mb=64,
            **flags, **geo)["err"])
    log(f"  {L3} attentions: -1 entries inside rows ({HOLE_LENS}), lens at "
        f"split boundaries and pages of 16 (bf16 and int8 pools) within "
        f"2e-5, worst decode {worst_dec:.2e}, prefill {worst_pre:.2e}")
    d, i8 = dec["bf16"], dec["int8"]
    report.add(f"paged_decode_attention@{L3}", route="cuda",
               source=src + "paged_decode_attention.cu",
               header=src + "flash_decode.cuh",
               replaces="src/repro/kernels/paged_decode_attention.py:138",
               max_abs_err=worst_dec, ms=d["ms"], plain_ms=d["plain"],
               library_ms=d["lib"], bound_ms=d["bound"], bound_by=d["by"],
               int8_ms=i8["ms"], int8_plain_ms=i8["plain"],
               int8_library_ms=i8["lib"], int8_bound_ms=i8["bound"],
               b1_1024_ms=dec_b1["ms"], b1_1024_bound_ms=dec_b1["bound"],
               b1_1024_library_ms=dec_b1["lib"],
               per="one layer's call at 8 slots, 8 KV heads x HQ 3 x D 128, "
                   "bf16 pool (int8_* for the int8 pool, b1_* at batch 1)")
    p, i8 = pre["bf16"], pre["int8"]
    report.add(f"paged_prefill_attention@{L3}", route="cuda",
               source=src + "paged_prefill_attention.cu",
               header=src + "tf32x3.cuh",
               replaces="src/repro/kernels/paged_prefill_attention.py:215",
               max_abs_err=worst_pre, ms=p["ms"], plain_ms=p["plain"],
               library_ms=p["lib"], bound_ms=p["bound"], bound_by=p["by"],
               f32_bound_ms=p["f32_bound"],
               tf32x3_bound_ms=p["tf32x3_bound"], int8_ms=i8["ms"],
               int8_plain_ms=i8["plain"], int8_library_ms=i8["lib"],
               int8_bound_ms=i8["bound"], b1_ms=pre_b1["ms"],
               b1_bound_ms=pre_b1["bound"], b1_library_ms=pre_b1["lib"],
               per="one layer's call at 8 x 256 rows, 8 KV heads x HQ 3 x D "
                   "128, bf16 pool (int8_* for the int8 pool, b1_* for B = "
                   "1, 256 rows against prefix 768)")

    _bf16_norm_row(report, gen, dev, L3, L3_D, BF16_NORM_CODES)
    _bf16_quantize_row(report, gen, dev, L3, L3_D, 8192)
    _bf16_rope_row(report, gen, dev, L3, 24, L3_KVH, L3_HD, 5e5)


def _bf16_norm_row(report, gen, dev, arch, k, codes, ms=(1, 8, 2048),
                   scale_rel=BF16_NORM_SCALE):
    """rmsnorm_quant on bf16 rows at ``arch``'s d_model K (norm1 -> wqkv,
    norm2 -> w13, final norm -> head), M = ``ms``: codes within ``codes``
    of the plain version's, scales within ``scale_rel`` (one bf16 rounding
    by default); timed beside the plain version.  Adds the row
    ``rmsnorm_quant@<arch>``."""
    from repro_torch.kernels import ops, ref
    src = "src/repro_torch/kernels/csrc/"
    gs, eps = 64, 1e-5
    gamma = torch.randn((k,), generator=gen, device=dev)
    norm = {}
    for m in ms:
        def mk():
            return _norm_input(gen, dev, m, k, gs).bfloat16()
        n_diff, rel, err, _, _ = _norm_held(ops, ref, mk(), gamma, eps, gs,
                                            codes, scale_rel)
        nbytes = m * k * 2 + k * 4 + m * k + m * (k // gs) * 4
        b_ms, b_by = bound(nbytes, 6.0 * m * k, F32_FLOPS_PER_S)
        nxt = rotating(mk, m * k * 2)
        ms = time_ms(lambda: ops.rmsnorm_quant_kernel(nxt(), gamma, eps, gs),
                     iters=50)
        plain = time_ms(lambda: ref.ref_rmsnorm_quant(nxt(), gamma, eps, gs),
                        iters=20)
        norm[m] = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                       codes_differing=n_diff, scale_rel_err=rel, err=err)
        log(f"  {arch} rmsnorm_quant bf16 M={m:5d} K={k}: {n_diff} of "
            f"{m * k} codes differ, max scale diff {rel:.2e} relative (tol "
            f"{codes} codes, {scale_rel:.2e}), "
            f"dequantized max abs err {err:.2e}  kernel {ms:.5f} ms  plain "
            f"{plain:.4f} ms  bound {b_ms:.6f} ms ({b_by})")
    r8 = norm[8]
    report.add(f"rmsnorm_quant@{arch}", route="cuda",
               source=src + "rmsnorm_quant.cu", header=src + "pdl.cuh",
               replaces="src/repro/kernels/rmsnorm_quant.py:58",
               max_abs_err=max(r["err"] for r in norm.values()),
               ms=r8["ms"], plain_ms=r8["plain_ms"], library_ms=None,
               bound_ms=r8["bound_ms"], bound_by=r8["bound_by"],
               m2048_plain_ms=norm[2048]["plain_ms"],
               m2048_bound_ms=norm[2048]["bound_ms"],
               **{f"m{m}_ms": r["ms"] for m, r in norm.items() if m != 8},
               codes_differing={str(m): r["codes_differing"]
                                for m, r in norm.items()},
               scale_rel_err=max(r["scale_rel_err"] for r in norm.values()),
               per=f"one call at M=8 decode rows of bf16, K={k} (m2048_* "
                   f"for a chunk step's rows), codes within {codes}; "
                   "max_abs_err on the dequantized values code * scale")


def _bf16_quantize_row(report, gen, dev, arch, d_model, d_ff):
    """quantize on bf16 rows, bitwise against the plain ``quantize``:
    wo_f's input (8 x d_model) where it differs from d_ff, and w2's at a
    decode step (8 x d_ff) and a chunk step (2048 x d_ff); timed beside
    the plain version.  Adds the row ``quantize@<arch>``."""
    from repro_torch.core.quantization import quantize
    from repro_torch.kernels import ops
    src = "src/repro_torch/kernels/csrc/"
    gs = 64
    shapes = [(8, d_model)] * (d_model != d_ff) + [(8, d_ff), (2048, d_ff)]
    qrec = {}
    for m, kk in shapes:
        def mkq():
            return _norm_input(gen, dev, m, kk, gs).bfloat16()
        _quantize_held(ops, mkq(), gs)
        nxt = rotating(mkq, m * kk * 2)
        ms = time_ms(lambda: ops.quantize_kernel(nxt(), gs), iters=50)
        plain = time_ms(lambda: quantize(nxt(), gs, 8), iters=20)
        nbytes = m * kk * 2 + m * kk + m * (kk // gs) * 4
        b_ms, b_by = bound(nbytes, 4.0 * m * kk, F32_FLOPS_PER_S)
        qrec[f"{m}x{kk}"] = dict(ms=ms, plain_ms=plain, bound_ms=b_ms,
                                 bound_by=b_by)
        log(f"  {arch} quantize bf16 M={m:5d} K={kk:5d}: bitwise  kernel "
            f"{ms:.5f} ms  plain {plain:.4f} ms  bound {b_ms:.6f} ms "
            f"({b_by})")
    main = f"8x{d_ff}"
    report.add(f"quantize@{arch}", route="cuda",
               source=src + "rmsnorm_quant.cu", header=src + "pdl.cuh",
               replaces="src/repro/kernels/ops.py:60", max_abs_err=0.0,
               **qrec[main], library_ms=None, by_shape=qrec,
               per=f"one call at M=8 bf16 rows, K={d_ff} (w2's input); "
                   "by_shape: each shape (M x K), wo_f's input at a decode "
                   "step, w2's at a decode and a chunk step; bitwise")


def _bf16_rope_row(report, gen, dev, arch, nq, kvh, hd, theta,
                   angles=None):
    """rope on the nq + kvh q and k heads of a bf16 qkv row, read in
    place, B = 1 and 8, bitwise against its plain version; timed beside
    it.  ``angles(pos)`` makes the cos / sin tables (default
    ``rope_angles`` at ``theta``).  Adds the row ``rope@<arch>``."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models.layers import rope_angles
    if angles is None:
        def angles(pos):
            return rope_angles(pos, hd, theta)
    nh, heads = nq + kvh, nq + 2 * kvh
    rec = {}
    for b in (1, 8):
        qkv = torch.randn((b, heads, hd), generator=gen,
                          device=dev).bfloat16()
        pos = torch.randint(0, 1024, (b,), generator=gen, device=dev)
        cos, sin = angles(pos)
        x = qkv[:, :nh]
        got, want = ops.rope_kernel(x, cos, sin), ref.ref_rope(x, cos, sin)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{arch} rope B={b}: max abs err "
                                 f"{(got.float() - want.float()).abs().max()}"
                                 ", expected bitwise equality")
        nbytes = 2 * b * nh * hd * 2 + 2 * b * hd * 4
        b_ms, b_by = bound(nbytes, 4.0 * b * nh * hd, F32_FLOPS_PER_S)
        ms = time_ms(lambda: ops.rope_kernel(x, cos, sin), iters=50)
        plain = time_ms(lambda: ref.ref_rope(x, cos, sin), iters=50)
        rec[b] = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by)
        log(f"  {arch} rope bf16 B={b} heads {nh} D={hd}: bitwise  kernel "
            f"{ms:.5f} ms  plain {plain:.4f} ms  bound {b_ms:.6f} ms "
            f"({b_by})")
    report.add(f"rope@{arch}", route="cuda",
               source="src/repro_torch/kernels/csrc/rope.cu",
               header="src/repro_torch/kernels/csrc/pdl.cuh",
               replaces="src/repro/kernels/rope.py:48", max_abs_err=0.0,
               **rec[8], library_ms=None, b1_ms=rec[1]["ms"],
               per=f"one layer's call at 8 slots: {nh} q and k heads of "
                   f"{hd} of a bf16 qkv row; bitwise")


def _bf16_flash_row(report, gen, dev, arch, h, kvh, d,
                    prompts=(17, 256, 600, 1024)):
    """flash_prefill on one bf16 prompt of each length in ``prompts`` (h
    query heads over kvh KV heads of d, q pre-scaled in bf16 as the model
    does, scale 1), within 2e-5 of its plain version, timed beside it and
    SDPA (``is_causal``, ``enable_gqa``) on the same bf16 tensors; its
    bound the function's flops at the bf16 rate (the kernel's own 3xTF32
    floor beside it as ``tf32x3_bound_ms``).  Adds the row
    ``flash_prefill@<arch>`` (its times at 600 tokens)."""
    from repro_torch.kernels import ops, ref
    src = "src/repro_torch/kernels/csrc/"
    qscale = torch.tensor(d ** -0.5).bfloat16().item()
    timed, err_max = {}, 0.0
    for n in prompts:
        def mk():
            q = torch.randn((1, n, h, d), generator=gen, device=dev)
            return ((q.bfloat16() * qscale),
                    torch.randn((1, n, kvh, d), generator=gen,
                                device=dev).bfloat16(),
                    torch.randn((1, n, kvh, d), generator=gen,
                                device=dev).bfloat16())
        q, k, v = mk()
        got = ops.flash_prefill_kernel(q, k, v, causal=True, scale=1.0)
        want = ref.ref_flash_prefill(q, k, v, True, scale=1.0)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not err <= 2e-5:
            raise AssertionError(f"flash_prefill bf16 S={n}: err {err:.3g} "
                                 "> 2e-5")
        err_max = max(err_max, err)
        pairs = n * (n + 1) // 2
        nbytes = 2 * n * d * (h + 2 * kvh) + 4 * n * h * d
        flops = 4.0 * pairs * h * d
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
        tf32x3_ms, _ = bound(nbytes, 3 * flops, TF32_FLOPS_PER_S)
        nxt = rotating(mk, 2 * n * d * (h + 2 * kvh), budget=96 << 20)
        ms = time_ms(lambda: ops.flash_prefill_kernel(*nxt(), causal=True,
                                                      scale=1.0))
        plain = time_ms(lambda: ref.ref_flash_prefill(*nxt(), True,
                                                      scale=1.0), iters=5)

        def sdpa():
            qt, kt, vt = (t.transpose(1, 2) for t in nxt())
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, scale=1.0, enable_gqa=True)
        lib = time_ms(sdpa)
        log(f"  {arch} flash_prefill bf16 S={n} H={h} KVH={kvh} D={d}  err "
            f"{err:.2e} (tol 2e-05)  kernel {ms:.4f} ms  plain {plain:.4f} "
            f"ms  sdpa {lib:.4f} ms  bound {b_ms:.4f} ms ({b_by}, bf16 "
            f"tensor cores), {100 * b_ms / ms:.1f}% of it; 3xTF32 floor "
            f"{tf32x3_ms:.4f} ms, {100 * tf32x3_ms / ms:.1f}% of it")
        timed[str(n)] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                             bound_ms=b_ms, bound_by=b_by,
                             tf32x3_bound_ms=tf32x3_ms)
    report.add(f"flash_prefill@{arch}", route="cuda",
               source=src + "flash_prefill.cu", header=src + "tf32x3.cuh",
               replaces="src/repro/kernels/flash_prefill.py:173",
               max_abs_err=err_max, **timed["600"], by_prompt=timed,
               per=f"one layer's call, one 600-token bf16 prompt, {h} / "
                   f"{kvh} heads of {d} (by_prompt at "
                   f"{', '.join(map(str, prompts))})")


def check_llama3_dense_q4(report, dev):
    """The dense cache's two kernels and the Q4_0 kernel at llama3.2-3b's
    shapes (phase 17's paths), each against its plain version and timed
    beside it and its library call: flash_prefill on one bf16 prompt of
    17, 256, 600 and 1024 tokens (24 query heads over 8 KV heads of 128, q
    pre-scaled in bf16 as the model does, scale 1), within 2e-5, beside
    SDPA (``is_causal``, ``enable_gqa``) on the same bf16 tensors, its
    bound the function's flops at the bf16 rate (the kernel's own 3xTF32
    floor beside it as ``tf32x3_bound_ms``);
    decode_attention on a bf16 and an int8 cache of 8 slots x 1024 at phase
    2's lens and at batch 1, bitwise equal to paged_decode_attention on
    the same rows (and at S = 832), beside SDPA on the dequantized K/V;
    q4_matvec at the decode GEMVs and the head (M = 1 and 8, within 2e-5)
    and the chunk step's MLP (M = 8 x 256, bitwise), beside
    ``torch.matmul`` on dequantized weights, none of it on the dp4a
    kernel.  Each adds a row ``<kernel>@llama3.2-3b``."""
    from repro_torch.kernels import build, ops, ref
    gen = torch.Generator(device=dev).manual_seed(26)
    src = "src/repro_torch/kernels/csrc/"
    h, kvh, d = 24, L3_KVH, L3_HD
    _bf16_flash_row(report, gen, dev, L3, h, kvh, d)

    # ---- decode_attention: 8 slots x 1024, bf16 and int8 caches
    geo = dict(kvh=kvh, hq=L3_HQ, d=d)
    dec = {kind: dense_decode_case(gen, dev, DECODE_LENS, kind == "int8",
                                   bf16=kind == "bf16", timed=True, **geo)
           for kind in ("bf16", "int8")}
    b1 = dense_decode_case(gen, dev, [1024], False, bf16=True, timed=True,
                           **geo)
    worst = max(r["err"] for r in (*dec.values(), b1))
    for kind in ("bf16", "int8"):
        worst = max(worst, dense_decode_case(
            gen, dev, [0, 1, 64, 832, 700, 511, 513, 900], kind == "int8",
            s=832, bf16=kind == "bf16", **geo)["err"])
    log(f"  {L3} decode_attention: bitwise equal to paged_decode_attention "
        "at S = 1024 and S = 832, bf16 and int8 caches")
    r, i8 = dec["bf16"], dec["int8"]
    report.add(f"decode_attention@{L3}", route="cuda",
               source=src + "decode_attention.cu",
               header=src + "flash_decode.cuh",
               replaces="src/repro/kernels/decode_attention.py:206",
               max_abs_err=worst, ms=r["ms"], plain_ms=r["plain"],
               library_ms=r["lib"], bound_ms=r["bound"], bound_by=r["by"],
               int8_ms=i8["ms"], int8_plain_ms=i8["plain"],
               int8_library_ms=i8["lib"], int8_bound_ms=i8["bound"],
               b1_1024_ms=b1["ms"], b1_1024_bound_ms=b1["bound"],
               b1_1024_library_ms=b1["lib"],
               per="one layer's call at 8 slots x 1024, 8 KV heads x HQ 3 x "
                   "D 128, bf16 cache (int8_* for the int8 cache, b1_* at "
                   "batch 1)")

    # ---- q4_matvec: a decode step's GEMVs + head, the chunk step's MLP
    operands = _q4_operands(gen, dev)
    dp4a = build.LAUNCHES["q4_matvec_dp4a"]
    step = _gemv_step(ops.q4_matvec_kernel, ref.ref_q4_matvec,
                         "q4_matvec", operands, L3_GEMV, L3_HEAD, L3_LAYERS,
                         dev)
    log(f"  {L3} q4_matvec per decode step ({L3_LAYERS} layers x 4 + head, "
        f"M=8): kernel {step['ms']:.4f} ms, torch.matmul {step['lib']:.4f} "
        f"ms, bound {step['bound']:.4f} ms, "
        f"{100 * step['bound'] / step['ms']:.1f}% of it")
    chunk = q4_matmul_chunk(dev, 2048, operands, shapes=L3_GEMM,
                            layers=L3_LAYERS)
    if build.LAUNCHES["q4_matvec_dp4a"] != dp4a:
        raise AssertionError(f"q4_matvec at {L3}'s shapes ran on the dp4a "
                             "kernel")
    report.add(f"q4_matvec@{L3}", route="cuda", source=src + "q4_matvec.cu",
               replaces="src/repro/kernels/q4_matmul.py:69",
               max_abs_err=max(step["err"], chunk["err"]), ms=step["ms"],
               plain_ms=step["plain"], bound_ms=step["bound"],
               bound_by="bytes", library_ms=step["lib"],
               chunk_ms=chunk["ms"], chunk_plain_ms=chunk["plain"],
               chunk_library_ms=chunk["lib"],
               chunk_bound_ms=chunk["bound"],
               chunk_q8_matmul_ms=chunk["q8"],
               per=f"decode step at 8 slots: {4 * L3_LAYERS} layer GEMVs + "
                   f"head 128256 x 3072 (chunk_*: chunk step, {L3_LAYERS} x "
                   "(w13, w2) at M = 2048, bitwise)")


def check_phi4_head(report, dev):
    """q8_matvec at phi4-mini-3.8b's one new shape, the 200192-row (padded
    vocab 200064) head at K 3072, M = 1 and 8, within 2e-5 and timed
    beside its plain version and ``torch.matmul``.  Its other kernels run
    llama3.2-3b's shapes (the same d_model, heads and d_ff): their rows are
    the ``@llama3.2-3b`` ones, and phase 18's record lists their launches
    on phi4's path."""
    from repro_torch.kernels import ops, ref
    operands = _q8_operands(torch.Generator(device=dev).manual_seed(18), dev)
    n, k = 200192, L3_D
    head = {m: _quant_timed(ops.q8_matvec_kernel, ref.ref_q8_matmul,
                            "q8_matvec", operands, m, n, k, dev)
            for m in (1, 8)}
    err, ms, plain, lib, b_ms, b_by = head[8]
    report.add(f"q8_matvec@{P4}", route="cuda",
               source="src/repro_torch/kernels/csrc/q8_matvec.cu",
               replaces="src/repro/kernels/q8_matvec.py:67",
               max_abs_err=max(head[1][0], err), ms=ms, plain_ms=plain,
               bound_ms=b_ms, bound_by=b_by, library_ms=lib,
               m1_ms=head[1][1], m1_plain_ms=head[1][2],
               m1_library_ms=head[1][3], m1_bound_ms=head[1][4],
               per=f"the head alone, {n} x {k} at M = 8 (m1_*: M = 1)")


# glm4-9b (phase 2's last part, phase 19): 40 layers, d_model 4096, 32
# query heads over 2 KV heads of 128 (HQ 16: the decode attentions' first
# shape past HQ*D = 1024, two head groups), d_ff 13696, vocab 151552.  Its
# decode GEMVs (wqkv, wo_f, w13, w2) and head, the chunk step's MLP GEMMs.
G4 = "glm4-9b"
G4_LAYERS, G4_D, G4_KVH, G4_HQ, G4_HD, G4_FF = 40, 4096, 2, 16, 128, 13696
G4_GEMV = [(4608, 4096), (4096, 4096), (27392, 4096), (4096, 13696)]
G4_HEAD = (151552, 4096)
G4_GEMM = ((27392, 4096), (4096, 13696))


def _halves_bitwise(name, fn, args, out):
    """A call at HQ 16 against two calls on q's halves (HQ 8 each, one
    head group each): a head's arithmetic does not depend on the heads
    beside it, so both halves must be bitwise equal."""
    q, rest = args[0], args[1:]
    half = q.shape[2] // 2
    lo = fn(q[:, :, :half].contiguous(), *rest)
    hi = fn(q[:, :, half:].contiguous(), *rest)
    torch.cuda.synchronize()
    if not (torch.equal(out[:, :, :half], lo)
            and torch.equal(out[:, :, half:], hi)):
        raise AssertionError(f"{name} at HQ {q.shape[2]}: not bitwise equal "
                             f"to two calls on q's halves")


def _decode_attention_rows(report, gen, dev, arch, kvh, hq, d, groups):
    """Both decode attentions at one config's KVH x HQ x D, each against
    its plain version: 8 slots x 1024 at phase 2's lens on bf16 and int8
    pools and caches (timed, SDPA with ``enable_gqa`` beside them), -1
    entries inside rows and lens at the split boundaries (paged), S = 832
    (dense), batch 1 at 1024 (bf16, timed); within 2e-5, the dense kernel
    bitwise equal to the paged one.  ``groups``: the head groups
    ``ops.decode_head_groups`` must give; with two, every call is also
    bitwise equal to two calls on q's halves.  Adds the rows
    ``paged_decode_attention@<arch>`` and ``decode_attention@<arch>``."""
    from repro_torch.kernels import ops
    src = "src/repro_torch/kernels/csrc/"
    geo = dict(kvh=kvh, hq=hq, d=d)
    if ops.decode_head_groups(hq, d) != groups:
        raise AssertionError(f"{arch}: expected {groups} head groups")
    paged, dense = {}, {}
    for kind in ("bf16", "int8"):
        flags = dict(int8=kind == "int8", bf16=kind == "bf16")
        paged[kind] = paged_decode_case(gen, dev, DECODE_LENS, timed=True,
                                        gqa=True, **flags, **geo)
        dense[kind] = dense_decode_case(gen, dev, DECODE_LENS, timed=True,
                                        gqa=True, **flags, **geo)
        holes = _holes_table(gen, dev, 16, len(HOLE_LENS) * 16, 64,
                             HOLE_LENS)
        paged[f"holes {kind}"] = paged_decode_case(
            gen, dev, HOLE_LENS, pt=holes, **flags, **geo)
        paged[f"split {kind}"] = paged_decode_case(
            gen, dev, [127, 128, 129, 511, 512, 513, 1, 0], **flags, **geo)
        dense[f"s832 {kind}"] = dense_decode_case(
            gen, dev, [0, 1, 64, 832, 700, 511, 513, 900], s=832, **flags,
            **geo)
    paged["b1"] = paged_decode_case(gen, dev, [1024], False, bf16=True,
                                    timed=True, gqa=True, **geo)
    dense["b1"] = dense_decode_case(gen, dev, [1024], False, bf16=True,
                                    timed=True, gqa=True, **geo)
    fns = {"paged_decode_attention": ops.paged_decode_attention_kernel,
           "decode_attention": ops.decode_attention_kernel}
    if groups == 2:
        for name, recs in (("paged_decode_attention", paged),
                           ("decode_attention", dense)):
            for rec in recs.values():
                _halves_bitwise(name, fns[name], rec["args"], rec["out"])
    in_groups = f"{groups} head group{'s' if groups > 1 else ''}"
    log(f"  {arch} decode attentions (KVH {kvh}, HQ {hq}, D {d}: "
        f"{in_groups}): within 2e-5 on bf16 and int8 pools and caches, -1 "
        f"entries inside rows, lens at split boundaries; "
        + ("every call bitwise equal to two calls on q's halves, "
           if groups == 2 else "")
        + "dense bitwise equal to paged at S = 1024 and 832")
    for name, recs, file, at, kind in (
            ("paged_decode_attention", paged, "paged_decode_attention.cu",
             "paged_decode_attention.py:138", "pool"),
            ("decode_attention", dense, "decode_attention.cu",
             "decode_attention.py:206", "cache")):
        r, i8, b1 = recs["bf16"], recs["int8"], recs["b1"]
        report.add(f"{name}@{arch}", route="cuda", source=src + file,
                   header=src + "flash_decode.cuh",
                   replaces=f"src/repro/kernels/{at}",
                   max_abs_err=max(x["err"] for x in recs.values()),
                   ms=r["ms"], plain_ms=r["plain"], library_ms=r["lib"],
                   bound_ms=r["bound"], bound_by=r["by"], int8_ms=i8["ms"],
                   int8_plain_ms=i8["plain"], int8_library_ms=i8["lib"],
                   int8_bound_ms=i8["bound"], b1_1024_ms=b1["ms"],
                   b1_1024_bound_ms=b1["bound"], b1_1024_library_ms=b1["lib"],
                   head_groups=groups,
                   per=f"one layer's call at 8 slots x 1024 (lens "
                       f"{DECODE_LENS}), {kvh} KV heads x HQ {hq} x D {d} "
                       f"in {in_groups}, bf16 {kind} (int8_* for int8, b1_* "
                       f"at batch 1, len 1024); library: SDPA, enable_gqa")


def _q8_matvec_row(report, dev, arch, operands, gemv, head, layers):
    """q8_matvec at a decode step of one config: each layer GEMV of
    ``gemv`` (N, K) and the ``head`` at M = 1 and 8 (``_gemv_step``),
    timed at 8 slots.  Adds the row ``q8_matvec@<arch>``."""
    from repro_torch.kernels import ops, ref
    src = "src/repro_torch/kernels/csrc/"
    step = _gemv_step(ops.q8_matvec_kernel, ref.ref_q8_matmul, "q8_matvec",
                      operands, gemv, head, layers, dev)
    n_gemv = sum(g[2] if len(g) > 2 else layers for g in gemv)
    log(f"  {arch} q8_matvec per decode step ({n_gemv} layer GEMVs + head, "
        f"M=8): kernel {step['ms']:.4f} ms, torch.matmul "
        f"{step['lib']:.4f} ms, bound {step['bound']:.4f} ms, "
        f"{100 * step['bound'] / step['ms']:.1f}% of it")
    report.add(f"q8_matvec@{arch}", route="cuda", source=src + "q8_matvec.cu",
               replaces="src/repro/kernels/q8_matvec.py:67",
               max_abs_err=step["err"], ms=step["ms"], plain_ms=step["plain"],
               bound_ms=step["bound"], bound_by="bytes",
               library_ms=step["lib"],
               per=f"decode step at 8 slots: {n_gemv} layer GEMVs (N x K"
                   + (" x calls " if len(gemv[0]) > 2 else " ")
                   + ", ".join(" x ".join(map(str, g)) for g in gemv)
                   + f") + head {head[0]} x {head[1]}")


def _paged_prefill_row(report, gen, dev, arch, kvh, hq, d):
    """paged_prefill_attention at one config's KVH x HQ x D against its
    plain version: 8 x 256 rows over phase 2's prefixes on a bf16 and an
    int8 pool and 256 rows over a 768-token prefix at B 1 (all timed, SDPA
    beside them), and over tables with -1 entries inside rows.  Adds the
    row ``paged_prefill_attention@<arch>``."""
    src = "src/repro_torch/kernels/csrc/"
    geo = dict(kvh=kvh, hq=hq, d=d)
    pre = paged_prefill_case(gen, dev, PREFILL_PFX, PREFILL_QLENS, False,
                             bf16=True, timed=True, **geo)
    pre_i8 = paged_prefill_case(gen, dev, PREFILL_PFX, PREFILL_QLENS, True,
                                timed=True, **geo)
    pre_b1 = paged_prefill_case(gen, dev, [768], [256], False, bf16=True,
                                timed=True, **geo)
    worst_pre = max(pre["err"], pre_i8["err"], pre_b1["err"])
    for kind in ("bf16", "int8"):
        holes = _holes_table(gen, dev, 16, len(HOLE_LENS) * 16, 64,
                             HOLE_LENS)
        worst_pre = max(worst_pre, paged_prefill_case(
            gen, dev, HOLE_LENS, [7, 20, 256, 100], kind == "int8",
            pt=holes, bf16=kind == "bf16", **geo)["err"])
    report.add(f"paged_prefill_attention@{arch}", route="cuda",
               source=src + "paged_prefill_attention.cu",
               header=src + "tf32x3.cuh",
               replaces="src/repro/kernels/paged_prefill_attention.py:215",
               max_abs_err=worst_pre, ms=pre["ms"], plain_ms=pre["plain"],
               library_ms=pre["lib"], bound_ms=pre["bound"],
               bound_by=pre["by"], f32_bound_ms=pre["f32_bound"],
               tf32x3_bound_ms=pre["tf32x3_bound"], int8_ms=pre_i8["ms"],
               int8_plain_ms=pre_i8["plain"],
               int8_library_ms=pre_i8["lib"],
               int8_bound_ms=pre_i8["bound"], b1_ms=pre_b1["ms"],
               b1_bound_ms=pre_b1["bound"], b1_library_ms=pre_b1["lib"],
               per=f"one layer's call at 8 x 256 rows, {kvh} KV heads x HQ "
                   f"{hq} x D {d}, bf16 pool (int8_* for the int8 pool, b1_* "
                   "for B = 1, 256 rows against prefix 768)")


def check_glm4(report, dev):
    """The kernels at glm4-9b's new shapes, each against its plain version
    and timed beside it and its library call, never copied from another
    config's row.  Both decode attentions at KVH 2, HQ 16, D 128 (two head
    groups), each call bitwise equal to two calls on q's halves
    (``_decode_attention_rows``).  q8_matvec at a decode step's 160 layer
    GEMVs (w2 at K 13696, 13 whole 1024-code slabs and 384 codes) and the
    151552-row head, M = 1 and 8; q8_matmul at the chunk step's w13 (N
    27392) and w2 (K 13696) at M = 2048, bitwise; quantize on bf16 rows at
    K 13696 (M 8 and 2048), bitwise; rmsnorm_quant on bf16 rows at K 4096
    (M 1, 8, 2048), 0 codes apart; paged_prefill_attention at HQ 16
    (``_paged_prefill_row``); rope on 34 heads of 128.  Each adds a row
    ``<kernel>@glm4-9b``."""
    gen = torch.Generator(device=dev).manual_seed(27)
    src = "src/repro_torch/kernels/csrc/"
    _decode_attention_rows(report, gen, dev, G4, G4_KVH, G4_HQ, G4_HD, 2)
    operands = _q8_operands(gen, dev)
    _q8_matvec_row(report, dev, G4, operands, G4_GEMV, G4_HEAD, G4_LAYERS)

    # ---- q8_matmul: the chunk step's MLP, 40 x (w13, w2) at 2048 rows
    chunk = q8_matmul_chunk(dev, 2048, operands, shapes=G4_GEMM,
                            layers=G4_LAYERS)
    report.add(f"q8_matmul@{G4}", route="cuda", source=src + "q8_matmul.cu",
               replaces="src/repro/kernels/q8_matmul.py:92",
               max_abs_err=chunk["err"], ms=chunk["ms"],
               plain_ms=chunk["plain"], bound_ms=chunk["bound"],
               bound_by=chunk["by"], library_ms=chunk["lib"],
               per=f"chunk step at 8 x 256 rows: {G4_LAYERS} x (w13 27392 x "
                   "4096, w2 4096 x 13696); bitwise")

    _paged_prefill_row(report, gen, dev, G4, G4_KVH, G4_HQ, G4_HD)
    _bf16_norm_row(report, gen, dev, G4, G4_D, 0)
    _bf16_quantize_row(report, gen, dev, G4, G4_D, G4_FF)
    _bf16_rope_row(report, gen, dev, G4, 32, G4_KVH, G4_HD, 1e4)


# command-r-35b (phase 2's last part, phase 20): 40 layers, d_model 8192,
# 64 query heads over 8 KV heads of 128 (HQ 8: HQ*D = 1024, one head
# group), d_ff 22528, vocab 256000 (the head's 2.1e9 codes, 2.3% under
# 2^31).  Its decode GEMVs (wqkv, wo_f, w13, w2) and head, the chunk step's
# MLP GEMMs.
CR = "command-r-35b"
CR_LAYERS, CR_D, CR_KVH, CR_HQ, CR_HD, CR_FF = 40, 8192, 8, 8, 128, 22528
CR_GEMV = [(10240, 8192), (8192, 8192), (45056, 8192), (8192, 22528)]
CR_HEAD = (256000, 8192)
CR_GEMM = ((45056, 8192), (8192, 22528))
# rmsnorm_quant's rows at command-r-35b: decode steps (1, 8), a verify step
# (16 at k = 1, 40 at k = 4) and a chunk step (2048)
CR_NORM_M = (1, 8, 16, 40, 2048)


def _norm_order_control(gen, dev, m, k):
    """rmsnorm_quant at (M, K) summed in another order than PyTorch's: the
    same 512 threads a row holding the same float4s, folded as one
    512-thread tree (the unsplit order, M = 1's) where PyTorch splits the
    row over warp-rows.  Returns (codes, scales) differing from the plain
    version's: what the 0-codes check would see if the kernel took the
    wrong order.  Raises if no scale differs: the check could then not
    tell the two orders apart."""
    from repro_torch.kernels import build, ops, ref
    gs, eps = 64, 1e-5
    x = _norm_input(gen, dev, m, k, gs)
    gamma = torch.randn((k,), generator=gen, device=dev)
    wq, ws = ref.ref_rmsnorm_quant(x, gamma, eps, gs)
    _, factor = ops._torch_row_mean_order(m, k)
    threads = 512
    aq, asc = torch.empty_like(wq), torch.empty_like(ws)
    build.launch("rmsnorm_quant", x.data_ptr(), gamma.data_ptr(),
                 aq.data_ptr(), asc.data_ptr(), m, k, gs, eps, factor,
                 *ops.rmsnorm_quant_plan(m, k, threads), threads, 0,
                 torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    codes, scales = int((aq != wq).sum().item()), int((asc != ws).sum().item())
    if scales == 0:
        raise AssertionError(f"rmsnorm_quant at M={m} K={k}: the unsplit "
                             "order gives the plain version's scales, so "
                             "the 0-codes check cannot tell the orders apart")
    return codes, scales


def check_command_r(report, dev):
    """The kernels at command-r-35b's shapes, each against its plain
    version and timed beside it and its library call.  Both decode
    attentions at KVH 8, HQ 8, D 128 (one head group;
    ``_decode_attention_rows``); q8_matvec at a decode step's 160 layer GEMVs (w2 at K 22528) and the
    256000-row head, M = 1 and 8; q8_matmul at the chunk step's w13 (N
    45056) and w2 (K 22528) at M = 2048, and at the verify step's head (M
    40, its offsets up to 2.1e9), bitwise; paged_prefill_attention at HQ 8
    (``_paged_prefill_row``); rmsnorm_quant on bf16 rows at K 8192, M
    1, 8, 16, 40 and 2048 (PyTorch's row mean splits a row over its
    warp-rows from M = 2 on): 0 codes apart and every scale equal, f32
    rows too, with the unsplit order as a control; quantize on bf16 rows
    at K 8192 and 22528, bitwise; rope on 72 heads of 128 at theta 8e6.
    Each adds a row ``<kernel>@command-r-35b``."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(28)
    src = "src/repro_torch/kernels/csrc/"
    _decode_attention_rows(report, gen, dev, CR, CR_KVH, CR_HQ, CR_HD, 1)
    operands = _q8_operands(gen, dev)
    _q8_matvec_row(report, dev, CR, operands, CR_GEMV, CR_HEAD, CR_LAYERS)

    # ---- q8_matmul: the chunk step's MLP, 40 x (w13, w2) at 2048 rows,
    # and the verify step's head at 40 rows (offsets past 2^31 / 1.02)
    chunk = q8_matmul_chunk(dev, 2048, operands, shapes=CR_GEMM,
                            layers=CR_LAYERS)
    n, k = CR_HEAD
    err, _ = _quant_check(ops.q8_matmul_kernel, ref.ref_q8_matmul,
                          "q8_matmul", 40, n, k, 64, *operands(40, n, k))
    log(f"  {CR} q8_matmul at the verify step's head (M=40, N x K {n} x "
        f"{k}): bitwise, err {err:.2e}")
    report.add(f"q8_matmul@{CR}", route="cuda", source=src + "q8_matmul.cu",
               replaces="src/repro/kernels/q8_matmul.py:92",
               max_abs_err=chunk["err"], ms=chunk["ms"],
               plain_ms=chunk["plain"], bound_ms=chunk["bound"],
               bound_by=chunk["by"], library_ms=chunk["lib"],
               per=f"chunk step at 8 x 256 rows: {CR_LAYERS} x (w13 45056 x "
                   "8192, w2 8192 x 22528); bitwise; the verify head "
                   "(M 40, 256000 x 8192) bitwise, untimed")

    _paged_prefill_row(report, gen, dev, CR, CR_KVH, CR_HQ, CR_HD)

    # ---- rmsnorm_quant at K 8192: 0 codes apart, scales equal; f32 rows
    # (no bf16 rounding to hide an ulp of the mean) and the order control
    _bf16_norm_row(report, gen, dev, CR, CR_D, 0, ms=CR_NORM_M,
                   scale_rel=0.0)
    for m in CR_NORM_M:
        _norm_held(ops, ref, _norm_input(gen, dev, m, CR_D, 64),
                   torch.randn((CR_D,), generator=gen, device=dev), 1e-5, 64,
                   0, 0.0)
    codes, scales = _norm_order_control(gen, dev, 2048, CR_D)
    log(f"  {CR} rmsnorm_quant f32 rows K={CR_D} M={CR_NORM_M}: 0 codes "
        f"apart, every scale equal; control, M=2048 summed as one "
        f"512-thread tree (not PyTorch's split over warp-rows): {codes} "
        f"codes and {scales} of {2048 * CR_D // 64} scales differ")
    report.rows[f"rmsnorm_quant@{CR}"].update(
        order_control={"codes_differing": codes, "scales_differing": scales})

    _bf16_quantize_row(report, gen, dev, CR, CR_D, CR_FF)
    _bf16_rope_row(report, gen, dev, CR, 64, CR_KVH, CR_HD, 8e6)


# qwen3-moe-30b-a3b (phase 2's last part, phase 21): 48 layers, d_model
# 2048, 32 query heads over 4 KV heads of 64 (HQ 8: HQ*D = 512, one head
# group; the first bf16 config at D 64), 128 experts of d_ff 768, top 8,
# vocab 151936 (head 152064 rows).  Its decode GEMVs are wqkv and wo_f
# alone: the experts are the reference's f32 einsums on dequantized
# weights, plain PyTorch, and the MoE leaves no w13 / w2 GEMV.
Q3 = "qwen3-moe-30b-a3b"
Q3_LAYERS, Q3_D, Q3_KVH, Q3_HQ, Q3_HD = 48, 2048, 4, 8, 64
Q3_GEMV = [(2560, 2048), (2048, 2048)]
Q3_HEAD = (152064, 2048)


def check_qwen3_moe(report, dev):
    """The kernels at qwen3-moe-30b-a3b's shapes, each against its plain
    version and timed beside it and its library call.  Both decode
    attentions (``_decode_attention_rows``) and paged_prefill_attention
    (``_paged_prefill_row``) at KVH 4, HQ 8, D 64 (one head group);
    flash_prefill on one bf16 prompt of 17..1024
    tokens at 32 / 4 heads of 64; q8_matvec at a decode step's 96 layer
    GEMVs (wqkv 2560 x 2048, wo_f 2048 x 2048) and the 152064-row head, M =
    1 and 8; q8_matmul at the verify step's head (M 40), bitwise;
    rmsnorm_quant on bf16 rows at K 2048 (M 1, 8 and 2048), 0 codes apart;
    quantize on bf16 rows at K 2048 (wo_f's input), bitwise; rope on 36
    heads of 64 at theta 1e6.  Each adds a row
    ``<kernel>@qwen3-moe-30b-a3b``."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(29)
    src = "src/repro_torch/kernels/csrc/"
    _decode_attention_rows(report, gen, dev, Q3, Q3_KVH, Q3_HQ, Q3_HD, 1)
    _paged_prefill_row(report, gen, dev, Q3, Q3_KVH, Q3_HQ, Q3_HD)
    _bf16_flash_row(report, gen, dev, Q3, Q3_KVH * Q3_HQ, Q3_KVH, Q3_HD)
    operands = _q8_operands(gen, dev)
    _q8_matvec_row(report, dev, Q3, operands, Q3_GEMV, Q3_HEAD, Q3_LAYERS)

    # ---- q8_matmul: the verify step's head at 40 rows (k = 4), bitwise
    n, k = Q3_HEAD
    err, ms, plain, lib, b_ms, b_by = _quant_timed(
        ops.q8_matmul_kernel, ref.ref_q8_matmul, "q8_matmul", operands, 40,
        n, k, dev)
    report.add(f"q8_matmul@{Q3}", route="cuda", source=src + "q8_matmul.cu",
               replaces="src/repro/kernels/q8_matmul.py:92",
               max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
               bound_by=b_by, library_ms=lib,
               per=f"the verify step's head at M 40 (8 slots x (4 + 1)), "
                   f"{n} x {k}; bitwise")

    _bf16_norm_row(report, gen, dev, Q3, Q3_D, 0)
    _bf16_quantize_row(report, gen, dev, Q3, Q3_D, Q3_D)
    report.rows[f"quantize@{Q3}"]["per"] = (
        f"one call at M=8 bf16 rows, K={Q3_D} (wo_f's input, the one "
        "quantize a layer); by_shape: at a decode step and at 2048 rows; "
        "bitwise")
    _bf16_rope_row(report, gen, dev, Q3, Q3_KVH * Q3_HQ, Q3_KVH, Q3_HD, 1e6)


# The SSM families (phase 2's last part, phases 22-23).  mamba2-370m: 48
# Mamba2 layers, d_model 1024 (d_inner 2048), state 128, vocab 50280 (head
# 50432 rows); a decode step's GEMVs: wz and wx (2048 x 1024), wB and wC
# (128 x 1024: the narrowest outputs either Q8_0 kernel has met), out_proj
# (1024 x 2048), each a layer.  zamba2-1.2b: 38 Mamba2 layers, d_model 2048
# (d_inner 4096), state 64 (wB and wC 64 x 2048), out_proj at K 4096, and
# the shared block's wqkv (6144 x 2048: 32 + 2 x 32 heads of 64), wo_f,
# w13 (16384 x 2048) and w2 (2048 x 8192) at each of its 6 applications;
# head 32000 x 2048.  (N, K, calls a decode step or prefill.)
M2, Z2 = "mamba2-370m", "zamba2-1.2b"
M2_LAYERS, M2_D, M2_DI = 48, 1024, 2048
M2_GEMV = [(2048, 1024, 96), (128, 1024, 96), (1024, 2048, 48)]
M2_HEAD = (50432, 1024)
Z2_LAYERS, Z2_APPS, Z2_D, Z2_DI, Z2_FF = 38, 6, 2048, 4096, 8192
Z2_GEMV = [(4096, 2048, 76), (64, 2048, 76), (2048, 4096, 38),
           (6144, 2048, 6), (2048, 2048, 6), (16384, 2048, 6),
           (2048, 8192, 6)]
Z2_HEAD = (32000, 2048)
# a prefill's products: the Mamba2 layers' five and the shared MLP's two
# (its Q/K/V/O run on the dequant qeinsum, as in the reference)
Z2_GEMM = [g for g in Z2_GEMV if g[:2] not in ((6144, 2048), (2048, 2048))]
# a prefill's prompt: phases 22-23's longest prompts are near 600 tokens
# (577 is prime: the scan's chunk of 1 there)
SSM_PREFILL_M = 577


def _gated_norm_rows(report, gen, dev, arch, k):
    """rmsnorm_quant on the f32 rows of a Mamba2 layer's gated norm (y *
    silu(z), K = d_inner), M 1, 8 and a prefill's: 0 codes apart and every
    scale equal to the plain version's (f32 rows: PyTorch's row-mean
    order), timed at M = 8 and at a prefill's rows beside the plain
    version.  Adds ``gated_*`` keys to the row ``rmsnorm_quant@<arch>``."""
    from repro_torch.kernels import ops, ref
    gs, eps = 64, 1e-5
    gamma = torch.randn((k,), generator=gen, device=dev)
    rec = {}
    ms = (1, 8, SSM_PREFILL_M)
    for m in ms:
        _norm_held(ops, ref, _norm_input(gen, dev, m, k, gs), gamma, eps, gs,
                   0, 0.0)
        if m == 1:
            continue
        nxt = rotating(lambda: _norm_input(gen, dev, m, k, gs), 4 * m * k)
        ms_k = time_ms(lambda: ops.rmsnorm_quant_kernel(nxt(), gamma, eps,
                                                        gs), iters=50)
        plain = time_ms(lambda: ref.ref_rmsnorm_quant(nxt(), gamma, eps, gs),
                        iters=20)
        b_ms, b_by = bound(m * k * 4 + k * 4 + m * k + m * (k // gs) * 4,
                           6.0 * m * k, F32_FLOPS_PER_S)
        rec[m] = dict(ms=ms_k, plain_ms=plain, bound_ms=b_ms, bound_by=b_by)
        log(f"  {arch} rmsnorm_quant f32 M={m:5d} K={k} (the gated norm): 0 "
            f"codes apart, every scale equal  kernel {ms_k:.5f} ms  plain "
            f"{plain:.4f} ms  bound {b_ms:.6f} ms ({b_by})")
    row = report.rows[f"rmsnorm_quant@{arch}"]
    row.update(gated_k=k, gated_codes_differing=0,
               **{f"gated_m{m}_{key}": v for m, r in rec.items()
                  for key, v in r.items()})
    row["per"] += (f"; gated_*: the gated norm's f32 rows at K={k} (M 1, 8, "
                   f"{ms[-1]}), 0 codes apart, every scale equal")


def _ssm_quantize_rows(report, gen, dev, arch, d_model, d_inner):
    """quantize, bitwise, on the f32 rows a Mamba2 layer would requantize
    unfused (the gated norm's output, K = d_inner; the served path fuses it
    into rmsnorm_quant), untimed; and the row's ``per`` for the served
    input, the normed bf16 hidden at K = d_model shared by the four
    in-projections."""
    from repro_torch.kernels import ops
    for m in (1, 8, SSM_PREFILL_M):
        _quantize_held(ops, _norm_input(gen, dev, m, d_inner, 64), 64)
    report.rows[f"quantize@{arch}"]["per"] = (
        f"one call at M=8 bf16 rows, K={d_model}: the normed input of a "
        "Mamba2 layer, quantized once for its four in-projections "
        "(by_shape also at 2048 rows); bitwise; f32 rows at K="
        f"{d_inner} (M 1, 8, {SSM_PREFILL_M}) bitwise, untimed")


def _ssm_gemm_row(report, dev, arch, operands, shapes, n_calls):
    """q8_matmul at one whole-prompt prefill of ``SSM_PREFILL_M`` tokens:
    every product of the prompt's layers (``shapes``, (N, K, calls)),
    bitwise, timed.  Adds the row ``q8_matmul@<arch>``."""
    from repro_torch.kernels import ops, ref
    src = "src/repro_torch/kernels/csrc/"
    chunk = q8_matmul_chunk(dev, SSM_PREFILL_M, operands, shapes=shapes)
    ref_err, _ = _quant_check(ops.q8_matmul_kernel, ref.ref_q8_matmul,
                              "q8_matmul", 33, shapes[1][0], shapes[1][1],
                              64, *operands(33, *shapes[1][:2]))
    report.add(f"q8_matmul@{arch}", route="cuda", source=src + "q8_matmul.cu",
               replaces="src/repro/kernels/q8_matmul.py:92",
               max_abs_err=max(chunk["err"], ref_err), ms=chunk["ms"],
               plain_ms=chunk["plain"], bound_ms=chunk["bound"],
               bound_by=chunk["by"], library_ms=chunk["lib"],
               per=f"one whole-prompt prefill of {SSM_PREFILL_M} tokens: "
                   f"{n_calls} products (N x K x calls "
                   + ", ".join(f"{n} x {k} x {c}" for n, k, c in shapes)
                   + f"); bitwise; the narrow N {shapes[1][0]} also at M 33")


def check_mamba2(report, dev):
    """The kernels at mamba2-370m's shapes (the SSM family's path: no
    attention, no rope), each against its plain version and timed beside
    it and its library call.  q8_matvec at a decode step's 240 layer GEMVs
    (``M2_GEMV``; wB / wC at N 128) and the 50432-row head, M = 1 and 8;
    q8_matmul at one 577-token prefill's 240 products, bitwise;
    rmsnorm_quant on bf16 rows at K 1024 (the head; M 1, 8, 2048) and on
    f32 rows at K 2048 (the gated norm; M 1, 8, 577), 0 codes apart;
    quantize on bf16 rows at K 1024 (the in-projections' input) and f32
    rows at K 2048, bitwise.  Each adds a row ``<kernel>@mamba2-370m``."""
    gen = torch.Generator(device=dev).manual_seed(30)
    operands = _q8_operands(gen, dev)
    _q8_matvec_row(report, dev, M2, operands, M2_GEMV, M2_HEAD, M2_LAYERS)
    _ssm_gemm_row(report, dev, M2, operands, M2_GEMV,
                  sum(c for *_, c in M2_GEMV))
    _bf16_norm_row(report, gen, dev, M2, M2_D, 0)
    _gated_norm_rows(report, gen, dev, M2, M2_DI)
    _bf16_quantize_row(report, gen, dev, M2, M2_D, M2_D)
    _ssm_quantize_rows(report, gen, dev, M2, M2_D, M2_DI)


def check_zamba2(report, dev):
    """The kernels at zamba2-1.2b's shapes, each against its plain version
    and timed beside it and its library call.  decode_attention (and the
    paged kernel beside it, not on this path) at 32 KV heads x HQ 1 x D
    64, bf16 and int8, 8 slots and batch 1 (``_decode_attention_rows``);
    flash_prefill on one bf16 prompt of 17..1024 tokens at 32 / 32 heads
    of 64; q8_matvec at a decode step's 214 layer GEMVs (``Z2_GEMV``: wB /
    wC at N 64, out_proj at K 4096, w2 at K 8192) and the 32000-row head, M
    = 1 and 8; q8_matmul at one 577-token prefill's 202 products, bitwise;
    rmsnorm_quant on bf16 rows at K 2048 (norm1, norm2, the head) and f32
    rows at K 4096 (the gated norm), 0 codes apart; quantize on bf16 rows at
    K 2048 and 8192 and f32 rows at K 4096, bitwise; rope on 64 heads of 64
    at theta 1e4.  Each adds a row ``<kernel>@zamba2-1.2b``."""
    gen = torch.Generator(device=dev).manual_seed(31)
    _decode_attention_rows(report, gen, dev, Z2, 32, 1, 64, 1)
    _bf16_flash_row(report, gen, dev, Z2, 32, 32, 64)
    operands = _q8_operands(gen, dev)
    _q8_matvec_row(report, dev, Z2, operands, Z2_GEMV, Z2_HEAD, Z2_LAYERS)
    _ssm_gemm_row(report, dev, Z2, operands, Z2_GEMM,
                  sum(c for *_, c in Z2_GEMM))
    _bf16_norm_row(report, gen, dev, Z2, Z2_D, 0)
    _gated_norm_rows(report, gen, dev, Z2, Z2_DI)
    _bf16_quantize_row(report, gen, dev, Z2, Z2_D, Z2_FF)
    _ssm_quantize_rows(report, gen, dev, Z2, Z2_D, Z2_DI)
    report.rows[f"quantize@{Z2}"]["per"] += (
        f"; the shared block's w2 input at K={Z2_FF}")
    _bf16_rope_row(report, gen, dev, Z2, 32, 32, 64, 1e4)


# qwen2-vl-7b (phase 2's vlm part, phase 24): 28 layers, d_model 3584, 28
# query heads over 4 KV heads of 128 (HQ 7, the second odd grouping after
# llama3.2-3b's HQ 3; HQ*D = 896, one head group), d_ff 18944, vocab
# 152064, M-RoPE at theta 1e6 (sections 16 / 24 / 24).  Its decode GEMVs
# (wqkv 4608, wo_f, w13 37888, w2 at K 18944) and head, the chunk step's
# MLP GEMMs.
Q2 = "qwen2-vl-7b"
Q2_LAYERS, Q2_D, Q2_KVH, Q2_HQ, Q2_HD, Q2_FF = 28, 3584, 4, 7, 128, 18944
Q2_GEMV = [(4608, 3584), (3584, 3584), (37888, 3584), (3584, 18944)]
Q2_HEAD = (152064, 3584)
Q2_GEMM = ((37888, 3584), (3584, 18944))
Q2_SECTIONS = (16, 24, 24)
Q2_NORM_M = (1, 8, 2048)


def _mrope_tables(hd, theta, sections):
    """``pos`` (B,) -> M-RoPE cos / sin (B, hd) at three distinct streams
    (temporal ``pos``, height and width derived from it), the case text
    tokens (three equal streams) never reach."""
    from repro_torch.models.layers import mrope_angles

    def angles(pos):
        streams = torch.stack([pos, pos // 2 + 3, (pos * 7) % 997])
        return mrope_angles(streams, hd, theta, sections)
    return angles


def check_qwen2_vl(report, dev):
    """The kernels at qwen2-vl-7b's shapes, each against its plain version
    and timed beside it and its library call, never copied from another
    config's row.  Both decode attentions (``_decode_attention_rows``) and
    paged_prefill_attention (``_paged_prefill_row``) at KVH 4, HQ 7, D 128
    (one head group); flash_prefill on one bf16 prompt of 17..1024 tokens
    at 28 / 4 heads of 128 (phase 24's model-level prefill); q8_matvec at
    a decode step's 112 layer GEMVs (w13 37888 x 3584, w2 at K 18944) and
    the 152064-row head, M = 1 and 8; q8_matmul at the chunk step's w13
    and w2 at M = 2048, bitwise; rmsnorm_quant at K 3584 (7 x 512: a
    ragged last sweep at every width), bf16 and f32 rows at M 1, 8 and
    2048, 0 codes apart and every scale equal in PyTorch's row-mean order;
    quantize on bf16 rows at K 3584 and 18944, bitwise; rope on 32 heads
    of 128 from M-RoPE tables at three distinct streams, bitwise.  Each
    adds a row ``<kernel>@qwen2-vl-7b``."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(24)
    src = "src/repro_torch/kernels/csrc/"
    _decode_attention_rows(report, gen, dev, Q2, Q2_KVH, Q2_HQ, Q2_HD, 1)
    _paged_prefill_row(report, gen, dev, Q2, Q2_KVH, Q2_HQ, Q2_HD)
    _bf16_flash_row(report, gen, dev, Q2, Q2_KVH * Q2_HQ, Q2_KVH, Q2_HD)
    operands = _q8_operands(gen, dev)
    _q8_matvec_row(report, dev, Q2, operands, Q2_GEMV, Q2_HEAD, Q2_LAYERS)

    chunk = q8_matmul_chunk(dev, 2048, operands, shapes=Q2_GEMM,
                            layers=Q2_LAYERS)
    report.add(f"q8_matmul@{Q2}", route="cuda", source=src + "q8_matmul.cu",
               replaces="src/repro/kernels/q8_matmul.py:92",
               max_abs_err=chunk["err"], ms=chunk["ms"],
               plain_ms=chunk["plain"], bound_ms=chunk["bound"],
               bound_by=chunk["by"], library_ms=chunk["lib"],
               per=f"chunk step at 8 x 256 rows: {Q2_LAYERS} x (w13 37888 x "
                   "3584, w2 3584 x 18944); bitwise")

    _bf16_norm_row(report, gen, dev, Q2, Q2_D, 0, ms=Q2_NORM_M,
                   scale_rel=0.0)
    for m in Q2_NORM_M:
        _norm_held(ops, ref, _norm_input(gen, dev, m, Q2_D, 64),
                   torch.randn((Q2_D,), generator=gen, device=dev), 1e-5, 64,
                   0, 0.0)
    plans = {m: ops._torch_row_mean_order(m, Q2_D)[0] for m in Q2_NORM_M}
    log(f"  {Q2} rmsnorm_quant f32 rows K={Q2_D} M={Q2_NORM_M}: 0 codes "
        f"apart, every scale equal (threads a row by M: {plans})")
    report.rows[f"rmsnorm_quant@{Q2}"].update(threads_a_row=plans)
    _bf16_quantize_row(report, gen, dev, Q2, Q2_D, Q2_FF)
    _bf16_rope_row(report, gen, dev, Q2, Q2_KVH * Q2_HQ, Q2_KVH, Q2_HD, 1e6,
                   angles=_mrope_tables(Q2_HD, 1e6, Q2_SECTIONS))
    report.rows[f"rope@{Q2}"]["per"] += (
        "; M-RoPE tables at three distinct streams (sections 16 / 24 / 24)")


# whisper-small (phase 2's audio part, phase 25): 12 encoder + 12 decoder
# layers, d_model 768, 12 heads of 64 (MHA: KVH 12 x HQ 1), d_ff 3072,
# vocab 51865 (head 51968 rows), 1504 encoder frames; 8 rows of a 16-token
# prompt, the self cache at Whisper's 448-token text context.  A decode
# step: w1 and w2 a decoder layer and the head on the GEMV (the Q/K/V/O
# on the dequant qeinsum, as the reference), the self and the cross
# attention on decode_attention; a prefill: the encoder's MLP at M = 8 x
# 1504, the decoder's at 8 x 16, the 36 flash_prefill calls.
WS = "whisper-small"
WS_LAYERS, WS_ENC, WS_D, WS_H, WS_HD, WS_FF = 12, 12, 768, 12, 64, 3072
WS_SEQ, WS_PROMPT, WS_MAX_SEQ, WS_B, WS_STEPS = 1504, 16, 448, 8, 32
WS_GEMV = [(3072, 768), (768, 3072)]
WS_HEAD = (51968, 768)
WS_GEMM = ((3072, 768), (768, 3072))
# the self cache's lens at a decode step (17..48) and edges; the cross
# cache's edges (all 1504 on the served path)
WS_SELF_LENS = [17, 24, 33, 48, 1, 0, 448, 300]
WS_CROSS_EDGES = [1504, 1503, 1, 0, 64, 1000, 1471, 1447]
WS_FLASH = {"encoder": (WS_SEQ, WS_SEQ, False),
            "cross": (WS_PROMPT, WS_SEQ, False),
            "self": (WS_PROMPT, WS_PROMPT, True)}
WS_QLENS = [16, 9, 0, 1, 16, 5, 16, 12]


def _whisper_decode_row(report, gen, dev):
    """decode_attention at whisper-small's decode step, 12 KV heads x HQ 1
    x D 64, 8 slots, bf16 and int8: the cross cache over its 1504 fixed
    keys (no multiple of 64: the split-K's ragged tail) and the self cache
    at 48 of its 448 positions, timed beside the plain version and SDPA;
    edges of both (lens 0, 1, one short, at the split boundaries, the
    whole cache), untimed.  Each call within 2e-5 of the plain version and
    bitwise equal to paged_decode_attention on the same rows.  Adds the row
    ``decode_attention@whisper-small``."""
    src = "src/repro_torch/kernels/csrc/"
    geo = dict(kvh=WS_H, hq=1, d=WS_HD, gqa=True)
    rec = {}
    for kind in ("bf16", "int8"):
        flags = dict(bf16=kind == "bf16")
        i8 = kind == "int8"
        rec[f"cross {kind}"] = dense_decode_case(
            gen, dev, [WS_SEQ] * WS_B, i8, s=WS_SEQ, timed=True, **flags,
            **geo)
        rec[f"self {kind}"] = dense_decode_case(
            gen, dev, [WS_PROMPT + WS_STEPS] * WS_B, i8, s=WS_MAX_SEQ,
            timed=True, **flags, **geo)
        rec[f"cross edges {kind}"] = dense_decode_case(
            gen, dev, WS_CROSS_EDGES, i8, s=WS_SEQ, **flags, **geo)
        rec[f"self edges {kind}"] = dense_decode_case(
            gen, dev, WS_SELF_LENS, i8, s=WS_MAX_SEQ, **flags, **geo)
    log(f"  {WS} decode_attention (KVH {WS_H}, HQ 1, D {WS_HD}): the cross "
        f"cache over {WS_SEQ} keys and the self cache over "
        f"{WS_PROMPT + WS_STEPS} of {WS_MAX_SEQ}, bf16 and int8, within "
        "2e-5 and bitwise equal to the paged kernel; edges too")
    c, sf, c8, s8 = (rec[k] for k in ("cross bf16", "self bf16",
                                      "cross int8", "self int8"))
    report.add(f"decode_attention@{WS}", route="cuda",
               source=src + "decode_attention.cu",
               header=src + "flash_decode.cuh",
               replaces="src/repro/kernels/decode_attention.py:206",
               max_abs_err=max(r["err"] for r in rec.values()),
               ms=c["ms"], plain_ms=c["plain"], library_ms=c["lib"],
               bound_ms=c["bound"], bound_by=c["by"],
               self_ms=sf["ms"], self_plain_ms=sf["plain"],
               self_library_ms=sf["lib"], self_bound_ms=sf["bound"],
               int8_ms=c8["ms"], int8_plain_ms=c8["plain"],
               int8_library_ms=c8["lib"], int8_bound_ms=c8["bound"],
               int8_self_ms=s8["ms"], int8_self_bound_ms=s8["bound"],
               per=f"one layer's cross-attention call at 8 slots over the "
                   f"{WS_SEQ}-key bf16 cross cache, {WS_H} heads of {WS_HD} "
                   f"(self_*: the self cache at {WS_PROMPT + WS_STEPS} of "
                   f"{WS_MAX_SEQ} positions; int8_* for int8 caches); "
                   "library: SDPA")


def _whisper_flash_row(report, gen, dev):
    """flash_prefill at whisper-small's prefill, 8 rows, 12 / 12 heads of
    64, q pre-scaled in bf16 as the model does (scale 1): the encoder's
    non-causal 1504 x 1504, the cross-attention's non-causal rectangular
    16 x 1504 and the decoder's causal 16 x 16, each within 2e-5 of its
    plain version, timed beside it and SDPA (``is_causal`` as the call) on
    the same L2-cold bf16 tensors; then 16 x 1504 with ``q_lens`` cutting
    rows, the dead rows exactly 0.  The bound: the function's flops at the
    bf16 rate (the kernel's 3xTF32 floor beside it).  Adds the row
    ``flash_prefill@whisper-small`` (its times the encoder's call)."""
    from repro_torch.kernels import ops, ref
    src = "src/repro_torch/kernels/csrc/"
    qscale = torch.tensor(WS_HD ** -0.5).bfloat16().item()
    b, h, d = WS_B, WS_H, WS_HD
    timed, err_max = {}, 0.0

    def mk(sq, sk):
        def make():
            q = torch.randn((b, sq, h, d), generator=gen, device=dev)
            return (q.bfloat16() * qscale,
                    torch.randn((b, sk, h, d), generator=gen,
                                device=dev).bfloat16(),
                    torch.randn((b, sk, h, d), generator=gen,
                                device=dev).bfloat16())
        return make

    for name, (sq, sk, causal) in WS_FLASH.items():
        make = mk(sq, sk)
        q, k, v = make()
        got = ops.flash_prefill_kernel(q, k, v, causal=causal, scale=1.0)
        want = ref.ref_flash_prefill(q, k, v, causal, scale=1.0)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not err <= 2e-5:
            raise AssertionError(f"{WS} flash_prefill {name} bf16 {sq} x "
                                 f"{sk}: err {err:.3g} > 2e-5")
        err_max = max(err_max, err)
        pairs = b * (sq * (sq + 1) // 2 if causal else sq * sk)
        nbytes = 2 * b * d * h * (sq + 2 * sk) + 4 * b * sq * h * d
        flops = 4.0 * pairs * h * d
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
        tf32x3_ms, _ = bound(nbytes, 3 * flops, TF32_FLOPS_PER_S)
        nxt = rotating(make, 2 * b * d * h * (sq + 2 * sk), budget=96 << 20)
        ms = time_ms(lambda: ops.flash_prefill_kernel(
            *nxt(), causal=causal, scale=1.0))
        plain = time_ms(lambda: ref.ref_flash_prefill(*nxt(), causal,
                                                      scale=1.0), iters=5)

        def sdpa():
            qt, kt, vt = (t.transpose(1, 2) for t in nxt())
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, scale=1.0)
        lib = time_ms(sdpa)
        log(f"  {WS} flash_prefill {name} bf16 B={b} Sq={sq} Sk={sk} H={h} "
            f"D={d}{'' if causal else ' non-causal'}  err {err:.2e} (tol "
            f"2e-05)  kernel {ms:.4f} ms  plain {plain:.4f} ms  sdpa "
            f"{lib:.4f} ms  bound {b_ms:.4f} ms ({b_by}, bf16 tensor cores),"
            f" {100 * b_ms / ms:.1f}% of it; 3xTF32 floor {tf32x3_ms:.4f} "
            f"ms, {100 * tf32x3_ms / ms:.1f}% of it")
        timed[name] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                           bound_ms=b_ms, bound_by=b_by,
                           tf32x3_bound_ms=tf32x3_ms)
    q, k, v = mk(WS_PROMPT, WS_SEQ)()
    ql = torch.tensor(WS_QLENS, dtype=torch.int32, device=dev)
    got = ops.flash_prefill_kernel(q, k, v, q_lens=ql, causal=False,
                                   scale=1.0)
    want = ref.ref_flash_prefill(q, k, v, False, q_lens=ql, scale=1.0)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    dead = torch.arange(WS_PROMPT, device=dev)[None] >= ql[:, None]
    if not (err <= 2e-5 and bool((got[dead] == 0).all())):
        raise AssertionError(f"{WS} flash_prefill cross with q_lens "
                             f"{WS_QLENS}: err {err:.3g} or a dead row not "
                             "exactly 0")
    err_max = max(err_max, err)
    log(f"  {WS} flash_prefill cross bf16 16 x {WS_SEQ}, q_lens "
        f"{WS_QLENS}: err {err:.2e}, {int(dead.sum())} dead rows exactly 0")
    report.add(f"flash_prefill@{WS}", route="cuda",
               source=src + "flash_prefill.cu", header=src + "tf32x3.cuh",
               replaces="src/repro/kernels/flash_prefill.py:173",
               max_abs_err=err_max, **timed["encoder"], by_call=timed,
               per=f"one encoder layer's call: 8 rows, bf16, non-causal "
                   f"{WS_SEQ} x {WS_SEQ}, {h} / {h} heads of {d} (by_call: "
                   f"the cross-attention's non-causal {WS_PROMPT} x "
                   f"{WS_SEQ} and the decoder's causal {WS_PROMPT} x "
                   f"{WS_PROMPT}); library: SDPA")


def check_whisper(report, dev):
    """The kernels at whisper-small's shapes, each against its plain
    version and timed beside it and its library call: decode_attention
    over the 1504-key cross cache and the 448-position self cache, bf16
    and int8 (``_whisper_decode_row``); flash_prefill non-causal at 1504 x
    1504 and 16 x 1504 and causal at 16 x 16, bf16, q_lens cutting rows
    (``_whisper_flash_row``); q8_matvec at a decode step's 24 layer GEMVs
    (w1 3072 x 768, w2 768 x 3072) and the 51968-row head, M = 1 and 8;
    q8_matmul at the encoder's MLP (M = 8 x 1504 = 12032, the largest M
    any phase runs) and the decoder's (M = 128), bitwise; quantize on
    bf16 rows at K 768 and 3072, bitwise, and untimed at M 12032 (the
    encoder's MLP inputs).  No rmsnorm_quant or rope: the layer norm has
    no fused kernel and whisper has no rope.  Each adds a row
    ``<kernel>@whisper-small``."""
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev).manual_seed(25)
    src = "src/repro_torch/kernels/csrc/"
    _whisper_decode_row(report, gen, dev)
    _whisper_flash_row(report, gen, dev)
    operands = _q8_operands(gen, dev)
    _q8_matvec_row(report, dev, WS, operands, WS_GEMV, WS_HEAD, WS_LAYERS)
    enc = q8_matmul_chunk(dev, WS_B * WS_SEQ, operands, shapes=WS_GEMM,
                          layers=WS_ENC)
    dec = q8_matmul_chunk(dev, WS_B * WS_PROMPT, operands, shapes=WS_GEMM,
                          layers=WS_LAYERS)
    report.add(f"q8_matmul@{WS}", route="cuda", source=src + "q8_matmul.cu",
               replaces="src/repro/kernels/q8_matmul.py:92",
               max_abs_err=max(enc["err"], dec["err"]), ms=enc["ms"],
               plain_ms=enc["plain"], bound_ms=enc["bound"],
               bound_by=enc["by"], library_ms=enc["lib"],
               m128_ms=dec["ms"], m128_plain_ms=dec["plain"],
               m128_bound_ms=dec["bound"], m128_library_ms=dec["lib"],
               per=f"the encoder's MLP at M {WS_B * WS_SEQ}: {WS_ENC} x (w1 "
                   f"3072 x 768, w2 768 x 3072) (m128_*: the decoder's at M "
                   f"{WS_B * WS_PROMPT}); bitwise")
    _bf16_quantize_row(report, gen, dev, WS, WS_D, WS_FF)
    for kk in (WS_D, WS_FF):
        _quantize_held(ops, _norm_input(gen, dev, WS_B * WS_SEQ, kk,
                                        64).bfloat16(), 64)
    report.rows[f"quantize@{WS}"]["per"] += (
        f"; bf16 rows at M {WS_B * WS_SEQ} (K {WS_D} and {WS_FF}) bitwise, "
        "untimed")


# llama4-maverick-400b-a17b (phase 2's interleave part, phase 26): 48
# layers in 24 patterns of a dense layer and an MoE layer, d_model 5120, 40
# query heads over 8 KV heads of 128 (HQ 5, the third odd grouping after
# HQ 3 and 7; HQ*D 640, one head group), d_ff 8192 (the dense MLP and each
# of 128 experts, top 1), vocab 202048 (head 202240 rows), rope theta 5e5.
# A decode step's GEMVs: wqkv (7168 = (40 + 2 x 8) x 128) and wo_f in every
# layer, w13 (16384) and w2 (K 8192) in the 24 dense ones; the experts are
# the reference's f32 einsums on dequantized banks, plain PyTorch.  A
# one-shot prefill's products: the dense layers' w13 and w2 at the
# prompt's M.  (N, K, calls a step.)
L4 = "llama4-maverick-400b-a17b"
L4_LAYERS, L4_D, L4_KVH, L4_HQ, L4_HD, L4_FF = 48, 5120, 8, 5, 128, 8192
L4_GEMV = [(7168, 5120, 48), (5120, 5120, 48), (16384, 5120, 24),
           (5120, 8192, 24)]
L4_HEAD = (202240, 5120)
L4_GEMM = [(16384, 5120, 24), (5120, 8192, 24)]
# phase 26's prompt lengths: one of 512 (groups of 512 in the grouped
# dispatch), one prime of 101 (groups of one token); the others with a
# large divisor under 512
L4_PROMPT_LENS = (512, 101, 160, 384, 256, 200, 96, 320)
# rmsnorm_quant's rows: decode steps (1, 8), one-shot prefills (101, 512)
# and the check's 8 x 256; 16 is the first M of the 40-float4 plan
L4_NORM_M = (1, 8, 16, 101, 512, 2048)


def check_llama4(report, dev):
    """The kernels at llama4-maverick-400b-a17b's shapes, each against its
    plain version and timed beside it and its library call.  Both decode
    attentions at KVH 8, HQ 5, D 128 (one head group;
    ``_decode_attention_rows``: the dense cache's kernel is this path's,
    the paged one runs beside it); flash_prefill on one bf16 prompt of 17,
    101, 512, 600 and 1024 tokens at 40 / 8 heads of 128; q8_matvec at a
    decode step's 144 layer GEMVs (``L4_GEMV``) and the 202240-row head, M
    = 1 and 8; q8_matmul at one 512-token prefill's 48 dense-MLP products,
    bitwise; rmsnorm_quant on bf16 and f32 rows at K 5120, M 1 to 2048
    (``L4_NORM_M``; from M 16 on PyTorch's mean takes 32 threads a row, 40
    float4s each): 0 codes apart and every scale equal; quantize on bf16
    rows at K 5120 and 8192, bitwise; rope on 48 heads of 128 at theta
    5e5.  Each adds a row ``<kernel>@llama4-maverick-400b-a17b``."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(32)
    src = "src/repro_torch/kernels/csrc/"
    _decode_attention_rows(report, gen, dev, L4, L4_KVH, L4_HQ, L4_HD, 1)
    _bf16_flash_row(report, gen, dev, L4, L4_KVH * L4_HQ, L4_KVH, L4_HD,
                    prompts=(17, 101, 512, 600, 1024))
    operands = _q8_operands(gen, dev)
    _q8_matvec_row(report, dev, L4, operands, L4_GEMV, L4_HEAD, L4_LAYERS)
    chunk = q8_matmul_chunk(dev, 512, operands, shapes=L4_GEMM)
    report.add(f"q8_matmul@{L4}", route="cuda", source=src + "q8_matmul.cu",
               replaces="src/repro/kernels/q8_matmul.py:92",
               max_abs_err=chunk["err"], ms=chunk["ms"],
               plain_ms=chunk["plain"], bound_ms=chunk["bound"],
               bound_by=chunk["by"], library_ms=chunk["lib"],
               per="one 512-token one-shot prefill: 24 dense layers x (w13 "
                   "16384 x 5120, w2 5120 x 8192); bitwise")
    _bf16_norm_row(report, gen, dev, L4, L4_D, 0, ms=L4_NORM_M,
                   scale_rel=0.0)
    for m in L4_NORM_M:
        _norm_held(ops, ref, _norm_input(gen, dev, m, L4_D, 64),
                   torch.randn((L4_D,), generator=gen, device=dev), 1e-5, 64,
                   0, 0.0)
    log(f"  {L4} rmsnorm_quant f32 rows K={L4_D} M={L4_NORM_M}: 0 codes "
        f"apart, every scale equal (plans "
        + ", ".join(f"M {m}: {ops.rmsnorm_quant_plan(m, L4_D, w)}"
                    for m in (1, 8, 16)
                    for w in [ops._torch_row_mean_order(m, L4_D)[0]])
        + ")")
    _bf16_quantize_row(report, gen, dev, L4, L4_D, L4_FF)
    _bf16_rope_row(report, gen, dev, L4, L4_KVH * L4_HQ, L4_KVH, L4_HD, 5e5)


def norm_bits(dev, path):
    """rmsnorm_quant's and quantize's outputs on seeded inputs at every
    shape served before command-r-35b (K 768 f32, K 3072 and 4096 bf16 and
    f32, at M 1, 8, 16, 40 and 2048, the edges NORM_EDGES; quantize at
    QUANT_TIMED, QUANT_EDGES and K 13696), saved to ``path`` when it does
    not exist, else held bitwise against what it holds.  Run it from the
    tree before a change to rmsnorm_quant.cu (with this script copied over
    its own), then from the change."""
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev).manual_seed(11)
    outs = []
    shapes = [(m, k) for k in (768, 3072, 4096) for m in CR_NORM_M]
    for m, k in shapes + NORM_EDGES:
        gamma = torch.randn((k,), generator=gen, device=dev)
        for bf16 in (False, True):
            x = _norm_input(gen, dev, m, k, 64)
            outs += ops.rmsnorm_quant_kernel(x.bfloat16() if bf16 else x,
                                             gamma, 1e-5, 64)
    for m, k, gs in QUANT_TIMED + QUANT_EDGES + [(8, 13696, 64),
                                                 (2048, 13696, 64)]:
        outs += ops.quantize_kernel(_norm_input(gen, dev, m, k, gs), gs)
    return _bits_held("rmsnorm_quant and quantize", outs, path)


def decode_bits(dev, path):
    """Both decode attentions' outputs on seeded inputs at every shape
    served before glm4-9b (one head group): llama2-110m's (12 KV heads x
    HQ 1 x D 64, f32 and int8, 8 slots at phase 2's lens and batch 1) and
    llama3.2-3b's (8 x HQ 3 x D 128, bf16 and int8), with the edges' HQ
    2..8 x D 32/128 and D 512; saved to ``path`` when it does not exist,
    else held bitwise against what it holds.  Run it from the tree before
    a change to flash_decode.cuh (with this script copied over its own),
    then from the change."""
    gen = torch.Generator(device=dev).manual_seed(5)
    cases = [dict(int8=i8, bf16=bf) for i8, bf in ((False, False),
                                                    (True, False))]
    l3 = [dict(int8=i8, bf16=not i8, kvh=L3_KVH, hq=L3_HQ, d=L3_HD)
          for i8 in (False, True)]
    edges = [dict(int8=False, bf16=False, kvh=2, hq=hq, d=d)
             for hq in (2, 4, 8) for d in (32, 128)]
    edges.append(dict(int8=False, bf16=False, kvh=2, hq=1, d=512))
    outs = []
    for kw in cases + l3 + edges:
        for lens_l in (DECODE_LENS, [1024], [80]):
            outs.append(paged_decode_case(gen, dev, lens_l, **kw)["out"])
            outs.append(dense_decode_case(gen, dev, lens_l, **kw)["out"])
    return _bits_held("decode attentions", outs, path)


def sass_count(name: str, *words: str) -> int:
    """Lines of kernel ``name``'s built library, disassembled by
    ``cuobjdump -sass``, that hold every one of ``words``.  Builds the
    library first if it is missing."""
    from repro_torch.kernels import build
    build.build([name])
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
               header="src/repro_torch/kernels/csrc/tf32x3.cuh",
               replaces="src/repro/kernels/flash_prefill.py:173",
               max_abs_err=err_max, **last, hmma_tf32=hmma,
               sdpa_kernels=sdpa_kernels,
               by_prompt={str(n): timed[n] for n in timed},
               per="one layer's call, one 600-token prompt")


def prefill_bits(dev, path, bf16=True):
    """The prefill attentions' outputs on seeded inputs, saved to ``path``
    when it does not exist, else held bitwise against what it holds: the
    f32 ``flash_prefill`` at check_flash_prefill's shapes (llama2-110m's
    one-shot prefill, B = 1, H = 12, D = 64, S 17, 256, 600, 1024; GQA with
    per-row extents; D = 32 and 128; non-causal) and, with ``bf16``, the
    bf16 ``flash_prefill`` at llama3.2-3b's (24 / 8 heads of 128, S 17,
    256, 600, 1024, scale 1) and ``paged_prefill_attention`` on a bf16
    pool at phase 2's prefixes (8 KV heads x HQ 3 x D 128).  Run it from a
    tree before a change (with this script copied over its own), then
    from the change: a change that must keep the bits passes only if every
    output is equal.  ``bf16`` needs a tree whose ``flash_prefill`` takes
    bf16 (README: how to run it on the card)."""
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev).manual_seed(4)

    def rand(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    cases = [(1, n, n, 12, 12, 64, True) for n in (17, 256, 600, 1024)]
    cases += [(4, 200, 456, 12, 6, 64, True), (2, 150, 150, 4, 2, 32, True),
              (2, 150, 150, 4, 2, 128, True), (2, 100, 300, 4, 4, 64, False)]
    outs = []
    for b, sq, sk, h, kvh, d, causal in cases:
        outs.append(ops.flash_prefill_kernel(
            rand(b, sq, h, d), rand(b, sk, kvh, d), rand(b, sk, kvh, d),
            causal=causal))
    if bf16:
        for n in (17, 256, 600, 1024):
            q, k, v = (rand(1, n, hh, L3_HD, dtype=torch.bfloat16)
                       for hh in (24, L3_KVH, L3_KVH))
            outs.append(ops.flash_prefill_kernel(q, k, v, causal=True,
                                                 scale=1.0))
        b, mb, bs = len(PREFILL_PFX), 16, 64
        kp, vp, _, _ = _pools(gen, dev, b * mb, bs, L3_KVH, L3_HD, False,
                              bf16=True)
        pt = _page_table(gen, dev, b, mb, b * mb,
                         [-(-p // bs) for p in PREFILL_PFX])
        q = rand(b, 256, L3_KVH, L3_HQ, L3_HD)
        outs += ops.paged_prefill_attention_kernel(
            q, kp, vp, pt,
            torch.tensor(PREFILL_PFX, dtype=torch.int32, device=dev),
            torch.tensor(PREFILL_QLENS, dtype=torch.int32, device=dev))
    return _bits_held("prefill attentions", outs, path)


def _bits_held(what, outs, path):
    """Save ``outs`` to ``path`` when it does not exist (True), else
    whether every output is bitwise equal to the saved one."""
    outs = [o.cpu() for o in outs]
    path = Path(path)
    if not path.exists():
        torch.save(outs, path)
        log(f"  {what}: {len(outs)} outputs saved to {path}")
        return True
    saved = torch.load(path)
    same = [torch.equal(a, b) for a, b in zip(outs, saved)]
    log(f"  {what}: {sum(same)} of {len(saved)} outputs bitwise equal to "
        f"{path}'s")
    return len(outs) == len(saved) and all(same)


# the SASS instruction that `griddepcontrol.wait` (csrc/pdl.cuh) becomes
PDL_WAIT_SASS = "ACQBULK"


def pdl_waits(name: str) -> int:
    """Count the PDL waits in kernel ``name``'s built library; fail at 0:
    the kernel would not overlap its predecessor's tail."""
    n = sass_count(name, PDL_WAIT_SASS)
    log(f"  {name}: {n} {PDL_WAIT_SASS} (griddepcontrol.wait) in its SASS "
        "(cuobjdump -sass)")
    if n == 0:
        raise AssertionError(f"{name}: no {PDL_WAIT_SASS} in its SASS: the "
                             "kernel does not wait on its predecessor")
    return n


def chain_ms(pred, fn):
    """(pair ms, predecessor ms): ``fn`` on the output of its predecessor
    on the decode path, back to back on the full queue, and the
    predecessor alone.  PDL's gain lies at that boundary."""
    return (time_ms(lambda: fn(pred()), iters=50),
            time_ms(pred, iters=50))


def _gemv_pred(gen, dev, n, k):
    """A q8_matvec at M = 8 against an (n, k) Q8_0 weight, cold in L2, and
    its output: the predecessor of a chain."""
    from repro_torch.kernels import ops
    operands = _q8_operands(gen, dev)
    nxt = rotating(lambda: operands(8, n, k)[2:], n * k + 4 * n * k // 64)
    xq, xs = operands(8, n, k)[:2]
    return lambda: ops.q8_matvec_kernel(xq, xs, *nxt(), 64)


ROPE_EDGES = [(3, 5, 36, 0), (8, 8, 32, 0), (4, 6, 64, 1), (2, 3, 4, 0)]


def check_rope(report, dev, parent=False):
    """rope on the q and k heads of a fused qkv row (read in place) at
    B = 1 and 8 slots; bitwise against the plain version; at B = 8 also
    after its predecessor on the decode path, the wqkv GEMV (``q8_matvec``,
    M = 8), beside that GEMV alone.  The library must hold a PDL wait.
    Then untimed edges, bitwise: D = 36 and 4 (not a multiple of 8: the
    scalar path), the reduced config's D = 32 and a view 4 bytes off.
    ``parent`` skips what a tree before PDL lacks (the turns)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models.layers import rope_angles
    waits = None if parent else pdl_waits("rope")
    gen = torch.Generator(device=dev).manual_seed(5)
    nh, kvh, d = 12, 12, 64

    def operands(b, h, d, heads, off=0):
        qkv = torch.randn((b * heads * d + off,), generator=gen, device=dev)
        pos = torch.randint(0, 1024, (b,), generator=gen, device=dev)
        return (qkv[off:].view(b, heads, d)[:, :h], *rope_angles(pos, d, 1e4))

    def held(x, cos, sin, tag):
        got = ops.rope_kernel(x, cos, sin)
        want = ref.ref_rope(x, cos, sin)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not torch.equal(got, want):
            raise AssertionError(f"rope {tag}: max abs err {err:.3g}, "
                                 "expected bitwise equality")
        return err

    rec = {}
    for b in (1, 8):
        x, cos, sin = operands(b, nh + kvh, d, nh + 2 * kvh)
        err = held(x, cos, sin, f"B={b}")
        nbytes = 2 * b * (nh + kvh) * d * 4 + 2 * b * d * 4
        b_ms, b_by = bound(nbytes, 4.0 * b * (nh + kvh) * d, F32_FLOPS_PER_S)
        ms = time_ms(lambda: ops.rope_kernel(x, cos, sin), iters=50)
        plain = time_ms(lambda: ref.ref_rope(x, cos, sin), iters=50)
        rec[b] = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by)
        log(f"  rope B={b} heads {nh + kvh} D={d}: err {err:.1e} (bitwise)  "
            f"kernel {ms:.5f} ms  plain {plain:.4f} ms  bound {b_ms:.6f} ms "
            f"({b_by})")
    gemv = _gemv_pred(gen, dev, (nh + 2 * kvh) * d, nh * d)
    cos, sin = rope_angles(torch.arange(8, device=dev) * 97, d, 1e4)
    pair, pred = chain_ms(gemv, lambda out: ops.rope_kernel(
        out.reshape(8, nh + 2 * kvh, d)[:, :nh + kvh], cos, sin))
    log(f"  rope B=8 after the wqkv q8_matvec: pair {pair:.5f} ms, the GEMV "
        f"alone {pred:.5f} ms: rope adds {pair - pred:.5f} ms in the chain")
    if parent:
        return {"rope": rec, "rope_chain": (pair, pred)}
    for b, h, dd, off in ROPE_EDGES:
        held(*operands(b, h, dd, h + 2, off), f"edge B={b} H={h} D={dd} "
             f"offset {off}")
    log(f"  rope: {len(ROPE_EDGES)} untimed edges (B, H, D, offset) "
        f"{ROPE_EDGES} bitwise")
    report.add("rope", route="cuda",
               source="src/repro_torch/kernels/csrc/rope.cu",
               header="src/repro_torch/kernels/csrc/pdl.cuh",
               replaces="src/repro/kernels/rope.py:48", max_abs_err=0.0,
               **rec[8], library_ms=None, b1_ms=rec[1]["ms"],
               chain_ms=pair, chain_pred_ms=pred, pdl_waits=waits,
               per="one layer's call at 8 slots: q and k heads of qkv "
                   "(chain_* after the wqkv q8_matvec at M = 8)")


# quantize's shapes: (M, K, group) of the decode step's wo_f and w2 GEMVs
# (M = 8), the chunk step's w2 GEMM (M = 2048) and the reduced config's
# wo_f (K = 128), timed; then untimed edges (groups 4..128, ragged M)
QUANT_TIMED = [(8, 768, 64), (8, 2048, 64), (2048, 2048, 64), (1, 128, 64)]
QUANT_EDGES = [(8, 768, 32), (33, 256, 16), (5, 512, 128), (3, 64, 4),
               (1000, 4096, 64), (2, 96, 32), (1, 2048, 64)]
# rmsnorm_quant's untimed edges: the reduced config's K = 128, and rows of
# 256 and 512 threads (K 2048 and 4096 at M = 1, 2)
NORM_EDGES = [(1, 128), (8, 128), (33, 128), (1, 2048), (2, 2048), (1, 4096),
              (2, 4096), (16, 4096)]


def _norm_input(gen, dev, m, k, gs):
    """Seeded rows with one all-zero group and one row x 1e4."""
    x = torch.randn((m, k), generator=gen, device=dev)
    x[0, gs:2 * gs] = 0.0
    x[-1] *= 1e4
    return x


def _norm_held(ops, ref, x, gamma, eps, gs, codes=1, scale_rel=3e-7):
    """rmsnorm_quant against its plain version: codes within ``codes``,
    scales within ``scale_rel`` relative, the zero group exact.  Returns
    (codes differing, scale rel, dequantized max abs err, plain codes,
    plain scales)."""
    m, k = x.shape
    q, sc = ops.rmsnorm_quant_kernel(x, gamma, eps, gs)
    wq, ws = ref.ref_rmsnorm_quant(x, gamma, eps, gs)
    torch.cuda.synchronize()
    dq = (q.int() - wq.int()).abs()
    n_diff = int((dq > 0).sum().item())
    rel = ((sc - ws).abs() / ws.abs().clamp(min=1e-30)).max().item()
    zero_ok = bool((q[0, gs:2 * gs] == 0).all()) and sc[0, 1].item() == 0.0
    deq = (q.float().reshape(m, -1, gs) * sc[..., None]
           - wq.float().reshape(m, -1, gs) * ws[..., None])
    if not (dq.max().item() <= codes and rel <= scale_rel and zero_ok):
        raise AssertionError(
            f"rmsnorm_quant M={m} K={k}: codes differ by up to "
            f"{dq.max().item()} ({n_diff} of {m * k}), scales by "
            f"{rel:.3g} relative, zero group exact {zero_ok}; the kernel "
            f"sums in torch {ops.TORCH_ROW_MEAN_ORDER_OF}'s row-mean "
            f"order, this is torch {torch.__version__}")
    return n_diff, rel, deq.abs().max().item(), wq, ws


def _quantize_held(ops, x, gs):
    """quantize_kernel bitwise against the plain ``quantize``."""
    from repro_torch.core.quantization import quantize
    q, sc = ops.quantize_kernel(x, gs)
    t = quantize(x, gs, 8)
    torch.cuda.synchronize()
    if not (torch.equal(q, t.q) and torch.equal(sc, t.scale)):
        raise AssertionError(
            f"quantize M={x.shape[0]} K={x.shape[1]} gs={gs}: "
            f"{int((q != t.q).sum())} codes and {int((sc != t.scale).sum())} "
            "scales differ from the plain quantize")


def check_rmsnorm_quant(report, dev, parent=False):
    """rmsnorm_quant at the decode step's rows (M = 1, 8 slots) and a chunk
    step's (M = 8 x 256), K = 768, random gamma, one all-zero group and one
    row at large magnitude.  Codes are held within 1 (the count printed),
    scales within a relative 3e-7.  The kernel sums mean(x^2) in the order
    of torch.mean on the card; the same kernel is also run with another
    number of threads a row (another order), and how far its scales part
    from the plain version's is printed, not held.  At M = 8 it is also
    timed after a q8_matvec (M = 8, w13's shape) beside that GEMV alone;
    then untimed edges (``NORM_EDGES``).  The quantize-only entry
    (``quantize``) is held bitwise to the plain ``quantize`` and timed at
    ``QUANT_TIMED``, then at ``QUANT_EDGES``.  The library must hold a PDL
    wait.  ``parent`` skips what a tree before this design lacks (the
    turns): the alternative order, the edges and the quantize entry."""
    from repro_torch.core.quantization import quantize
    from repro_torch.kernels import build, ops, ref
    waits = None if parent else pdl_waits("rmsnorm_quant")
    divs = None if parent else check_div127(dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    k, gs, eps = 768, 64, 1e-5
    gamma = torch.randn((k,), generator=gen, device=dev)
    rec = {}
    for m in (1, 8, 2048):
        def mk():
            return _norm_input(gen, dev, m, k, gs)
        x = mk()
        n_diff, rel, err, wq, ws = _norm_held(ops, ref, x, gamma, eps, gs)
        nbytes = m * k * 4 + k * 4 + m * k + m * (k // gs) * 4
        b_ms, b_by = bound(nbytes, 6.0 * m * k, F32_FLOPS_PER_S)
        nxt = rotating(mk, m * k * 4)
        ms = time_ms(lambda: ops.rmsnorm_quant_kernel(nxt(), gamma, eps, gs),
                     iters=50)
        plain = time_ms(lambda: ref.ref_rmsnorm_quant(nxt(), gamma, eps, gs),
                        iters=20)
        rec[m] = (ms, plain, b_ms, b_by, n_diff, rel, err)
        alt_line = ""
        if not parent:
            width, factor = ops._torch_row_mean_order(m, k)
            alt = 32 if width != 32 else 128
            aq = torch.empty_like(wq)
            asc = torch.empty_like(ws)
            build.launch("rmsnorm_quant", x.data_ptr(), gamma.data_ptr(),
                         aq.data_ptr(), asc.data_ptr(), m, k, gs, eps, factor,
                         *ops.rmsnorm_quant_plan(m, k, alt), alt, 0,
                         torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            alt_rel = ((asc - ws).abs()
                       / ws.abs().clamp(min=1e-30)).max().item()
            alt_line = (f"; summed by {alt} threads a row instead of "
                        f"torch's {width}: {int((aq != wq).sum().item())} "
                        f"codes and {int((asc != ws).sum().item())} of "
                        f"{ws.numel()} scales differ, max {alt_rel:.2e} "
                        "relative")
        log(f"  rmsnorm_quant M={m:5d} K={k}: {n_diff} of {m * k} codes differ"
            f" by 1, max scale diff {rel:.2e} relative (tol 3e-7), "
            f"dequantized max abs err {err:.2e}  kernel "
            f"{ms:.5f} ms  plain {plain:.4f} ms  library - (no single call)"
            f"  bound {b_ms:.6f} ms ({b_by}){alt_line}")
    gemv = _gemv_pred(gen, dev, 2 * 2048, k)
    x8 = _norm_input(gen, dev, 8, k, gs)
    pair, pred = chain_ms(gemv, lambda _: ops.rmsnorm_quant_kernel(
        x8, gamma, eps, gs))
    log(f"  rmsnorm_quant M=8 after a q8_matvec (M = 8, w13's 4096 x 768): "
        f"pair {pair:.5f} ms, the GEMV alone {pred:.5f} ms: rmsnorm_quant "
        f"adds {pair - pred:.5f} ms in the chain")
    turn = {"rmsnorm_quant": {m: r[:2] for m, r in rec.items()},
            "rmsnorm_quant_chain": (pair, pred)}
    # the quantization in front of every product no norm feeds: the new
    # entry where the tree has it, the plain quantize (what q8_matmul ran
    # before) where it does not
    qfn = getattr(ops, "quantize_kernel", None)
    qrec = {}
    for m, kk, g in QUANT_TIMED:
        def mkq():
            return _norm_input(gen, dev, m, kk, g)
        x = mkq()
        if qfn is not None:
            _quantize_held(ops, x, g)
        nxt = rotating(mkq, m * kk * 4)
        ms = (None if qfn is None else
              time_ms(lambda: qfn(nxt(), g), iters=50))
        plain = time_ms(lambda: quantize(nxt(), g, 8), iters=20)
        nbytes = m * kk * 4 + m * kk + m * (kk // g) * 4
        b_ms, b_by = bound(nbytes, 4.0 * m * kk, F32_FLOPS_PER_S)
        qrec[(m, kk)] = dict(ms=ms, plain_ms=plain, bound_ms=b_ms,
                             bound_by=b_by)
        log(f"  quantize M={m:5d} K={kk:5d} group {g}: "
            + ("" if qfn is None else f"bitwise  kernel {ms:.5f} ms  ")
            + f"plain {plain:.4f} ms  bound {b_ms:.6f} ms ({b_by})")
    turn["quantize"] = {f"{m}x{kk}": (r["ms"], r["plain_ms"])
                        for (m, kk), r in qrec.items()}
    if parent:
        return turn
    h13 = torch.randn((8, 2 * 2048), generator=gen, device=dev)

    def silu_mul():
        return torch.nn.functional.silu(h13[:, :2048]) * h13[:, 2048:]
    qpair, qpred = chain_ms(silu_mul, lambda h: qfn(h, gs))
    log(f"  quantize M=8 K=2048 after silu(h1) * h3 (PyTorch): pair "
        f"{qpair:.5f} ms, silu * mul alone {qpred:.5f} ms: quantize adds "
        f"{qpair - qpred:.5f} ms in the chain")
    for m, kk in NORM_EDGES:
        g = torch.randn((kk,), generator=gen, device=dev)
        _norm_held(ops, ref, _norm_input(gen, dev, m, kk, gs), g, eps, gs)
    for m, kk, g in QUANT_EDGES:
        _quantize_held(ops, _norm_input(gen, dev, m, kk, g), g)
    log(f"  rmsnorm_quant: {len(NORM_EDGES)} untimed edges (M, K) "
        f"{NORM_EDGES} within 1 code and 3e-7; quantize: "
        f"{len(QUANT_EDGES)} (M, K, group) {QUANT_EDGES} bitwise")
    ms, plain, b_ms, b_by = rec[8][:4]
    report.add("rmsnorm_quant", route="cuda",
               source="src/repro_torch/kernels/csrc/rmsnorm_quant.cu",
               header="src/repro_torch/kernels/csrc/pdl.cuh",
               replaces="src/repro/kernels/rmsnorm_quant.py:58",
               max_abs_err=max(r[6] for r in rec.values()), ms=ms,
               plain_ms=plain, library_ms=None, bound_ms=b_ms, bound_by=b_by,
               m1_ms=rec[1][0], m2048_ms=rec[2048][0],
               m2048_plain_ms=rec[2048][1], m2048_bound_ms=rec[2048][2],
               chain_ms=pair, chain_pred_ms=pred, pdl_waits=waits,
               div127_checked=divs, codes_differing={str(m): r[4] for m, r in rec.items()},
               scale_rel_err=max(r[5] for r in rec.values()),
               per="one call at M=8 decode rows, K=768 (m2048_* for a chunk "
                   "step's 2048 rows; chain_* after a q8_matvec); "
                   "max_abs_err on the dequantized values code * scale")
    q8 = qrec[(8, 768)]
    report.add("quantize", route="cuda",
               source="src/repro_torch/kernels/csrc/rmsnorm_quant.cu",
               header="src/repro_torch/kernels/csrc/pdl.cuh",
               replaces="src/repro/kernels/ops.py:60",
               replaces_note="no Pallas kernel: the reference's jnp "
                             "quantize in front of each product, fused by "
                             "XLA; the CUDA entry is rmsnorm_quant's "
                             "kernel without the norm",
               max_abs_err=0.0, **q8, library_ms=None,
               by_shape={f"{m}x{kk}": r for (m, kk), r in qrec.items()},
               chain_ms=qpair, chain_pred_ms=qpred,
               per="one call at M=8, K=768 (wo_f's input; by_shape at "
                   "w2's 8 x 2048, the chunk step's 2048 x 2048 and the "
                   "reduced config's 1 x 128); bitwise")
    return turn


DIV_CHECK_CU = r"""
#include "%s"
__global__ void div127_check(unsigned lo, int* bad) {
  const unsigned bits = lo + blockIdx.x * blockDim.x + threadIdx.x;
  const float a = __uint_as_float(bits);
  if (__float_as_uint(div127_tame(a)) !=
      __float_as_uint(__fdiv_rn(127.0f, a)))
    atomicAdd(bad, 1);
}
extern "C" int div127_check_range(unsigned lo, unsigned n, int* bad) {
  div127_check<<<n / 256, 256>>>(lo, bad);
  return (int)cudaGetLastError();
}
"""


def check_div127(dev):
    """``rmsnorm_quant.cu``'s branch-free 127 / a (``div127_tame``) against
    ``__fdiv_rn`` on every f32 a in [2^-64, 2^64), the range where the
    kernels take it: 2^30 values, built from the kernel's own source."""
    import ctypes
    from repro_torch.kernels import build
    src = build.BUILD_DIR / "div127_check.cu"
    lib = build.BUILD_DIR / "div127_check.so"
    src.write_text(DIV_CHECK_CU % (build.CSRC / "rmsnorm_quant.cu"))
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS[:-2], "-o", str(lib),
                    str(src)], check=True, capture_output=True, timeout=300)
    fn = ctypes.CDLL(str(lib)).div127_check_range
    fn.argtypes = [ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p]
    bad = torch.zeros(1, dtype=torch.int32, device=dev)
    lo, hi = (127 - 64) << 23, (127 + 64) << 23      # 2^-64 .. 2^64
    for start in range(lo, hi, 1 << 28):
        if fn(start, min(1 << 28, hi - start), bad.data_ptr()):
            raise AssertionError("div127_check failed to launch")
    torch.cuda.synchronize()
    n_bad = int(bad.item())
    log(f"  div127_tame: {n_bad} of {hi - lo} f32 values in [2^-64, 2^64) "
        "differ from __fdiv_rn(127, a)")
    if n_bad:
        raise AssertionError(f"div127_tame differs from __fdiv_rn on {n_bad} "
                             "values")
    return hi - lo


def pdl_turn(dev):
    """The chains of ``check_rope`` and ``check_rmsnorm_quant`` (and
    quantize after silu * mul) with the kernels as built, and with the same
    sources built with the PDL attribute set to 0, in turns (PDL, none,
    none, PDL): what PDL buys at the predecessor boundary.  A measurement
    only, from a patched copy in the build directory: the port has no such
    switch.  Prints and returns {kernel: [(pair ms, predecessor ms)]}."""
    import ctypes
    import shutil
    from repro_torch.kernels import build, ops
    build.build(["rope", "rmsnorm_quant", "q8_matvec"])
    off = build.BUILD_DIR / "nopdl"
    off.mkdir(parents=True, exist_ok=True)
    for name in ("pdl.cuh", "rope.cu", "rmsnorm_quant.cu"):
        shutil.copy(build.CSRC / name, off / name)
    hdr = off / "pdl.cuh"
    text = hdr.read_text()
    assert "programmaticStreamSerializationAllowed = 1" in text
    hdr.write_text(text.replace("programmaticStreamSerializationAllowed = 1",
                                "programmaticStreamSerializationAllowed = 0"))
    variants = {"pdl": {}, "none": {}}
    for name, entries in (("rope", ("rope",)),
                          ("rmsnorm_quant", ("rmsnorm_quant", "quantize"))):
        lib = off / f"{name}.so"
        subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS[:-2], "-o",
                        str(lib), str(off / f"{name}.cu")], check=True,
                       capture_output=True, timeout=300)
        for e in entries:
            variants["pdl"][e] = build._entry(e)
            fn = getattr(ctypes.CDLL(str(lib)), e)
            fn.argtypes, fn.restype = build.SIGNATURES[e], ctypes.c_int
            variants["none"][e] = fn
    gen = torch.Generator(device=dev).manual_seed(9)
    gemv13 = _gemv_pred(gen, dev, 4096, 768)
    gemv_qkv = _gemv_pred(gen, dev, 2304, 768)
    gamma = torch.randn((768,), generator=gen, device=dev)
    x8 = _norm_input(gen, dev, 8, 768, 64)
    cos, sin = torch.randn((2, 8, 64), generator=gen, device=dev)
    h13 = torch.randn((8, 4096), generator=gen, device=dev)

    def silu_mul():
        return torch.nn.functional.silu(h13[:, :2048]) * h13[:, 2048:]
    chains = {
        "rope": (gemv_qkv, lambda out: ops.rope_kernel(
            out.reshape(8, 36, 64)[:, :24], cos, sin)),
        "rmsnorm_quant": (gemv13, lambda _: ops.rmsnorm_quant_kernel(
            x8, gamma, 1e-5, 64)),
        "quantize": (silu_mul, lambda h: ops.quantize_kernel(h, 64)),
    }
    out = {k: {"pdl": [], "none": []} for k in chains}
    try:
        for turn in ("pdl", "none", "none", "pdl"):
            build._fns.update(variants[turn])
            for k, (pred, fn) in chains.items():
                out[k][turn].append(chain_ms(pred, fn))
    finally:
        build._fns.update(variants["pdl"])
    for k, r in out.items():
        log(f"  {k} chain (pair, predecessor alone) ms: with PDL "
            f"{r['pdl']}, without {r['none']}")
    return out


def norm_rope_turn(dev):
    """One turn of parent against change: ``check_rope`` and
    ``check_rmsnorm_quant`` with ``parent=True`` (every call held as the
    checks hold it, the times, the chains, and the activation quantization
    -- the plain ``quantize`` on a tree without the kernel); works on
    either tree.  Prints and returns the times."""
    from repro_torch.kernels import build
    build.build(["rope", "rmsnorm_quant", "q8_matvec"])
    out = {**check_rope(Report(), dev, parent=True),
           **check_rmsnorm_quant(Report(), dev, parent=True)}
    log(f"  norm/rope turn (ms): {json.dumps(out)}")
    return out


def _pools(gen, dev, nb, bs, kvh, d, int8, bf16=False):
    """Random K/V pools: f32, bf16 (``bf16``) or int8 codes with their
    f32 scales (``int8``)."""
    from repro_torch.core.quantization import quantize_rows
    k = torch.randn((nb, bs, kvh, d), generator=gen, device=dev)
    v = torch.randn((nb, bs, kvh, d), generator=gen, device=dev)
    if bf16:
        return k.bfloat16(), v.bfloat16(), None, None
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


# the check's decode lengths: 0, 1, one page -1/+0/+1, the full table
DECODE_LENS = [0, 1, 63, 64, 65, 1024, 300, 777]
# -1 entries inside a row's length: released slots (all -1) at lens 1 and
# 20, and a hole at block 2 of a live row.  The reference reads pool block
# 0 for them and masks by length only.
HOLE_LENS = [1, 20, 300, 700]


def _holes_table(gen, dev, mb, nb, bs, lens_l):
    pt = _page_table(gen, dev, len(lens_l), mb, nb,
                     [-(-n // bs) for n in lens_l])
    pt[:2] = -1
    pt[2, 2] = -1
    return pt


def paged_decode_case(gen, dev, lens_l, int8, *, kvh=12, hq=1, d=64, bs=64,
                      mb=16, pt=None, timed=False, yardsticks=True,
                      bf16=False, gqa=False):
    """One paged_decode_attention call against its plain version (tolerance
    2e-5; a length-0 row exactly 0) on random pools of B * MB pages (f32,
    bf16 with ``bf16``: widened exactly by both, so the same tolerance, or
    int8) and a table of distinct random pages (or ``pt``).  ``timed``:
    also its device time on L2-cold pools and its bound; ``yardsticks``:
    the plain version's and SDPA's (on gathered K/V, repeated over the
    query heads, or with ``gqa`` indexed by SDPA's ``enable_gqa``) times
    beside it.  Returns a dict with the inputs of the call and its
    output."""
    from repro_torch.kernels import ops, ref
    b, h, nb = len(lens_l), kvh * hq, len(lens_l) * mb
    lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
    pools = _pools(gen, dev, nb, bs, kvh, d, int8, bf16)
    if pt is None:
        pt = _page_table(gen, dev, b, mb, nb, [-(-n // bs) for n in lens_l])
    q = torch.randn((b, kvh, hq, d), generator=gen, device=dev) / math.sqrt(d)
    got = ops.paged_decode_attention_kernel(q, pools[0], pools[1], pt, lens,
                                            pools[2], pools[3])
    want = ref.ref_paged_decode_attention(q, pools[0], pools[1], pt, lens,
                                          pools[2], pools[3])
    torch.cuda.synchronize()
    kind = "int8" if int8 else "bf16" if bf16 else "f32"
    err = (got - want).abs().max().item()
    tol = 2e-5   # online vs one-pass softmax: f32 summation order only
    zero = all(got[i].abs().max().item() == 0.0
               for i, n in enumerate(lens_l) if n <= 0)
    if not (err <= tol and zero):
        raise AssertionError(
            f"paged_decode_attention {kind} HQ {hq} D {d} page {bs} MB {mb} "
            f"lens {lens_l}: err {err:.3g} (tol {tol}), len=0 rows exactly "
            f"0: {zero}")
    rec = {"err": err, "args": (q, *pools[:2], pt, lens, *pools[2:]),
           "out": got}
    if not timed:
        return rec
    elem = 1 if int8 else 2 if bf16 else 4
    nrows = sum(min(max(n, 0), mb * bs) for n in lens_l)
    nbytes = (2 * nrows * kvh * d * elem + (8 * nrows * kvh if int8 else 0)
              + 2 * b * h * d * 4 + 4 * b * mb + 4 * b)
    rec["bound"], rec["by"] = bound(nbytes, 4.0 * nrows * h * d,
                                    F32_FLOPS_PER_S)
    nxt = rotating(lambda: (q, *_pools(gen, dev, nb, bs, kvh, d, int8,
                                       bf16)),
                   2 * nb * bs * kvh * d * elem, budget=96 << 20)

    def run_kernel():
        qq, kp, vp, ksp, vsp = nxt()
        ops.paged_decode_attention_kernel(qq, kp, vp, pt, lens, ksp, vsp)

    def run_plain():
        qq, kp, vp, ksp, vsp = nxt()
        ref.ref_paged_decode_attention(qq, kp, vp, pt, lens, ksp, vsp)

    rec["ms"] = time_ms(run_kernel)
    line = (f"  paged_decode_attention {kind}: lens {lens_l}  err {err:.2e} "
            f"(tol {tol:.0e})  kernel {rec['ms']:.4f} ms  bound "
            f"{rec['bound']:.4f} ms ({rec['by']}), "
            f"{100 * rec['bound'] / rec['ms']:.1f}% of it")
    if yardsticks:
        rec["plain"] = time_ms(run_plain, iters=5)
        kg = ref.gather_rows(pools[0], pt).float()
        vg = ref.gather_rows(pools[1], pt).float()
        if int8:
            kg = kg * ref.gather_rows(pools[2], pt)[..., None]
            vg = vg * ref.gather_rows(pools[3], pt)[..., None]
        rep = 1 if gqa else hq
        kg = torch.repeat_interleave(kg, rep, dim=2).transpose(1, 2)
        vg = torch.repeat_interleave(vg, rep, dim=2).transpose(1, 2)
        mask = (torch.arange(mb * bs, device=dev)[None] < lens[:, None])
        mask = mask[:, None, None, :]
        qs = q.reshape(b, h, 1, d)
        rec["lib"] = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qs, kg, vg, attn_mask=mask, scale=1.0, enable_gqa=gqa))
        line += (f"  plain {rec['plain']:.4f} ms  sdpa {rec['lib']:.4f} ms")
    log(line)
    return rec


def paged_decode_edges(gen, dev):
    """Untimed edges of paged_decode_attention against its plain version:
    lens at split boundaries (127..513 and the full table), HQ 2..8 at D =
    32 and 128, pages of 16 and 128 (tiles that span pages), a table 13
    pages wide, int8 rows copied 16, 8 and 4 bytes at a time (D = 64, 40,
    36), D = 512 (f32: 2 warps a block, to fit shared memory), -1 entries
    inside rows' lengths; f32 and int8.  Then a repeated call, which must
    be bitwise equal.  Returns (cases, worst error)."""
    from repro_torch.kernels import ops
    split = [0, 1, 127, 128, 129, 511, 512, 513]
    cases = [dict(), dict(bs=16, mb=64), dict(bs=128, mb=8), dict(mb=13),
             dict(d=40), dict(d=36), dict(d=512, kvh=2)]
    cases += [dict(hq=hq, d=d) for hq in (2, 4, 8) for d in (32, 128)]
    worst, n = 0.0, 0
    for kw in cases:
        bs, mb = kw.get("bs", 64), kw.get("mb", 16)
        for int8 in (False, True):
            worst = max(worst, paged_decode_case(
                gen, dev, split + [mb * bs], int8, **kw)["err"])
            n += 1
    nb = len(HOLE_LENS) * 16
    for int8 in (False, True):
        pt = _holes_table(gen, dev, 16, nb, 64, HOLE_LENS)
        worst = max(worst, paged_decode_case(gen, dev, HOLE_LENS, int8,
                                             pt=pt)["err"])
        n += 1
    rec = paged_decode_case(gen, dev, DECODE_LENS, False)
    again = ops.paged_decode_attention_kernel(*rec["args"])
    torch.cuda.synchronize()
    if not torch.equal(rec["out"], again):
        raise AssertionError("paged_decode_attention: a repeated call is not "
                             "bitwise equal to the first")
    log(f"  paged_decode_attention edges: {n} cases (lens at split "
        f"boundaries, HQ 2..8 x D 32/128, pages 16 and 128, MB = 13, D = "
        f"40, 36 and 512, -1 inside rows' lengths; f32 and int8) within "
        f"2e-5, worst err {worst:.2e}; a repeated call bitwise equal")
    return n, worst


def decode_attention_turn(dev):
    """Device ms of both decode attentions at the check's shapes (f32 and
    int8) and at batch 1 (len 80 and 1024, f32), on L2-cold operands, each
    call first held to its plain version (and the dense one bitwise to the
    paged one).  Runs on any tree's wrappers, so parent and change can be
    timed in turns."""
    gen = torch.Generator(device=dev).manual_seed(4)
    out = {}
    for int8 in (False, True):
        kind = "int8" if int8 else "f32"
        out[f"paged {kind}"] = paged_decode_case(
            gen, dev, DECODE_LENS, int8, timed=True, yardsticks=False)["ms"]
        out[f"dense {kind}"] = dense_decode_case(
            gen, dev, DECODE_LENS, int8, timed=True, yardsticks=False)["ms"]
    for n in (80, 1024):
        out[f"paged b1 {n}"] = paged_decode_case(
            gen, dev, [n], False, timed=True, yardsticks=False)["ms"]
        out[f"dense b1 {n}"] = dense_decode_case(
            gen, dev, [n], False, timed=True, yardsticks=False)["ms"]
    log(f"  decode attention turn (ms): {json.dumps(out)}")
    return out


# the check's prefix lengths and q_lens: an empty prefix, partial pages,
# padded q rows, a skipped row (q_len 0) and the full 12-tile prefix last
PREFILL_PFX = [0, 64, 128, 300, 511, 700, 1, 768]
PREFILL_QLENS = [256, 256, 100, 256, 17, 0, 256, 255]


def paged_prefill_case(gen, dev, pfx_l, qlen_l, int8, *, pt=None, c=256,
                       kvh=12, hq=1, d=64, bs=64, mb=16, timed=False,
                       yardsticks=True, bf16=False):
    """One paged_prefill_attention call against its plain version on the
    rows below q_lens (out, m and l relative to max(1, l), tolerance 2e-5);
    an empty prefix and every skipped row exactly (0, -1e30, 0).  Pools of
    B * MB pages (f32, bf16 with ``bf16``: widened exactly by both, so the
    same tolerance, or int8), a table of distinct random pages (or
    ``pt``).  ``timed``:
    also its device time on L2-cold pools and its bound: on f32 and int8
    pools the lesser of the 3xTF32 tensor-core floor (three TF32 products
    a product) and the f32 CUDA-core one; on a bf16 pool, whose values
    are exact in TF32, the function's products once at the TF32 rate,
    with the 3xTF32 floor beside it (``tf32x3_bound``); ``yardsticks``:
    the plain version's and SDPA's (on gathered K/V) times beside it.  Returns a dict with the call's
    operands, its outputs, its error and, when timed, its times."""
    from repro_torch.kernels import ops, ref
    b, h, nb = len(pfx_l), kvh * hq, len(pfx_l) * mb
    pfx = torch.tensor(pfx_l, dtype=torch.int32, device=dev)
    qlens = torch.tensor(qlen_l, dtype=torch.int32, device=dev)
    pools = _pools(gen, dev, nb, bs, kvh, d, int8, bf16)
    if pt is None:
        pt = _page_table(gen, dev, b, mb, nb, [-(-p // bs) for p in pfx_l])
    q = torch.randn((b, c, kvh, hq, d), generator=gen,
                    device=dev) / math.sqrt(d)
    args = (q, pools[0], pools[1], pt, pfx, qlens, pools[2], pools[3])
    out, m, l = ops.paged_prefill_attention_kernel(*args)
    wo, wm, wl = ref.ref_paged_prefill_attention(
        q.reshape(b, c, h, d), pools[0], pools[1], pt, pfx, pools[2],
        pools[3])
    torch.cuda.synchronize()
    wm = wm[..., 0].transpose(1, 2).reshape(b, c, kvh, hq)
    wl = wl[..., 0].transpose(1, 2).reshape(b, c, kvh, hq)
    wo = wo.reshape(b, c, kvh, hq, d)
    rows = torch.arange(c, device=dev)[None] < qlens[:, None]   # (B, C)
    err = 0.0
    if bool(rows.any()):
        err = max((out - wo).abs()[rows].max().item(),
                  (m - wm).abs()[rows].max().item(),
                  ((l - wl).abs() / wl.clamp(min=1.0))[rows].max().item())
    tol = 2e-5
    kind = "int8" if int8 else "bf16" if bf16 else "f32"
    empty = [i for i, p in enumerate(pfx_l) if p == 0]
    empty_exact = (bool((out[empty] == 0).all())
                   and bool((l[empty] == 0).all())
                   and bool((m[empty] == -1e30).all()))
    skipped = ~rows
    skipped_exact = (bool((out[skipped] == 0).all())
                     and bool((m[skipped] == -1e30).all())
                     and bool((l[skipped] == 0).all()))
    if not (err <= tol and empty_exact and skipped_exact):
        raise AssertionError(
            f"paged_prefill_attention {kind} HQ {hq} D {d} C {c} page {bs} "
            f"MB {mb} pfx {pfx_l} q_lens {qlen_l}: err {err:.3g} (tol "
            f"{tol}), empty prefix exact {empty_exact}, skipped rows exact "
            f"{skipped_exact}")
    rec = {"err": err, "args": args, "out": (out, m, l)}
    if not timed:
        return rec
    elem = 1 if int8 else 2 if bf16 else 4
    kv_rows = sum(min(max(p, 0), mb * bs) for p in pfx_l)
    nbytes = (2 * kv_rows * kvh * d * elem + (8 * kv_rows * kvh if int8
                                              else 0)
              + sum(qlen_l) * h * d * 4 + b * c * h * (d + 2) * 4
              + 4 * b * mb + 8 * b)
    flops = 4.0 * sum(min(max(p, 0), mb * bs) * n
                      for p, n in zip(pfx_l, qlen_l)) * h * d
    rec["tf32x3_bound"] = bound(nbytes, 3 * flops, TF32_FLOPS_PER_S)[0]
    rec["bound"], rec["by"] = bound(nbytes, (1 if bf16 else 3) * flops,
                                    TF32_FLOPS_PER_S)
    rec["f32_bound"], rec["f32_by"] = bound(nbytes, flops, F32_FLOPS_PER_S)
    nxt = rotating(lambda: (q, *_pools(gen, dev, nb, bs, kvh, d, int8,
                                       bf16)),
                   2 * nb * bs * kvh * d * elem, budget=96 << 20)

    def run_kernel():
        qq, kp, vp, ksp, vsp = nxt()
        ops.paged_prefill_attention_kernel(qq, kp, vp, pt, pfx, qlens, ksp,
                                           vsp)

    def run_plain():
        qq, kp, vp, ksp, vsp = nxt()
        ref.ref_paged_prefill_attention(qq.reshape(b, c, h, d), kp, vp, pt,
                                        pfx, ksp, vsp)

    rec["ms"] = time_ms(run_kernel)
    line = (f"  paged_prefill_attention {kind}: B {b} pfx {pfx_l} q_lens "
            f"{qlen_l}  err {err:.2e} (tol {tol:.0e})  kernel "
            f"{rec['ms']:.4f} ms  bound {rec['bound']:.4f} ms ({rec['by']}, "
            f"{'TF32' if bf16 else '3xTF32'} tensor cores; 3xTF32 "
            f"{rec['tf32x3_bound']:.4f} ms; f32 CUDA cores "
            f"{rec['f32_bound']:.4f} ms, {rec['f32_by']}), "
            f"{100 * rec['bound'] / rec['ms']:.1f}% of it")
    if yardsticks:
        rec["plain"] = time_ms(run_plain, iters=5)
        kg = ref.gather_rows(pools[0], pt).float()
        vg = ref.gather_rows(pools[1], pt).float()
        if int8:
            kg = kg * ref.gather_rows(pools[2], pt)[..., None]
            vg = vg * ref.gather_rows(pools[3], pt)[..., None]
        kg = torch.repeat_interleave(kg, hq, dim=2).transpose(1, 2)
        vg = torch.repeat_interleave(vg, hq, dim=2).transpose(1, 2)
        mask = (torch.arange(mb * bs, device=dev)[None] < pfx[:, None])
        mask = mask[:, None, None, :]
        qs = q.reshape(b, c, h, d).transpose(1, 2)
        rec["lib"] = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qs, kg, vg, attn_mask=mask, scale=1.0))
        line += f"  plain {rec['plain']:.4f} ms  sdpa {rec['lib']:.4f} ms"
    log(line)
    return rec


def paged_prefill_edges(gen, dev):
    """Untimed edges of paged_prefill_attention against its plain version
    (2e-5; empty and skipped rows exact), f32 and int8 pools: HQ 2, 4 and 8
    at D 32 and 128 (rows that mix chunk positions and heads), pages of 16
    and 128 (tiles that span pages) and of 48 (not a power of two), a
    table 13 pages wide, C = 100 (not a multiple of 64); every case has
    q_lens 0 and 1 and prefixes of 1 and of MB * BS.  Then a repeated
    call, which must be bitwise equal.
    Returns (cases, worst error)."""
    from repro_torch.kernels import ops
    cases = [dict(), dict(bs=16, mb=64), dict(bs=128, mb=8), dict(mb=13),
             dict(bs=48, mb=22), dict(c=100)]
    cases += [dict(hq=hq, d=d, kvh=2) for hq in (2, 4, 8) for d in (32, 128)]
    worst, n, at = 0.0, 0, None
    for kw in cases:
        c, bs, mb = kw.get("c", 256), kw.get("bs", 64), kw.get("mb", 16)
        pfx_l = [0, 1, 63, 64, 65, 511, mb * bs, 200]
        qlen_l = [c, c, 1, 0, c - 1, 17, c, c // 2]
        for int8 in (False, True):
            err = paged_prefill_case(gen, dev, pfx_l, qlen_l, int8,
                                     **kw)["err"]
            if err > worst:
                worst, at = err, dict(kw, int8=int8)
            n += 1
    rec = paged_prefill_case(gen, dev, PREFILL_PFX, PREFILL_QLENS, False)
    again = ops.paged_prefill_attention_kernel(*rec["args"])
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(rec["out"], again)):
        raise AssertionError("paged_prefill_attention: a repeated call is "
                             "not bitwise equal to the first")
    log(f"  paged_prefill_attention edges: {n} cases (HQ 2/4/8 x D 32/128, "
        f"pages 16, 48 and 128, MB = 13, C = 100, q_lens 0 and 1, prefixes "
        f"1 and MB * BS; f32 and int8) within 2e-5, worst err {worst:.2e} "
        f"({at}); a repeated call bitwise equal")
    return n, worst


def paged_prefill_turn(dev):
    """Device ms of paged_prefill_attention at the check's shapes (f32 and
    int8) and at B = 1 (one 256-row chunk of a long prompt, prefix 768),
    and of flash_prefill at the one-shot prefill's shapes (B = 1, H = 12,
    S 17, 256, 600 and 1024), on L2-cold operands, each kernel call first
    held to its plain version within 2e-5.  Runs on any tree's wrappers,
    so parent and change can be timed in turns."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(5)
    out = {}
    for int8 in (False, True):
        out["paged " + ("int8" if int8 else "f32")] = paged_prefill_case(
            gen, dev, PREFILL_PFX, PREFILL_QLENS, int8, timed=True,
            yardsticks=False)["ms"]
    out["paged b1 768"] = paged_prefill_case(
        gen, dev, [768], [256], False, timed=True, yardsticks=False)["ms"]
    for n in (17, 256, 600, 1024):
        def mk():
            return tuple(torch.randn((1, n, 12, 64), generator=gen,
                                     device=dev) for _ in range(3))
        q, k, v = mk()
        err = (ops.flash_prefill_kernel(q, k, v)
               - ref.ref_flash_prefill(q, k, v, True)).abs().max().item()
        if not err <= 2e-5:
            raise AssertionError(f"flash_prefill S={n}: err {err:.3g}")
        nxt = rotating(mk, 4 * 64 * 3 * n * 12, budget=96 << 20)
        out[f"flash {n}"] = time_ms(
            lambda: ops.flash_prefill_kernel(*nxt()))
    log(f"  prefill attention turn (ms): {json.dumps(out)}")
    return out


# the meshes whose head slices phase 2 holds: a rank of a mesh of n holds
# KVH / n KV heads and their query heads of the paged pool and of the
# dense cache (``transformer._ServeMesh``, ``_dense_attention``)
SLICE_MESHES = (2, 4)
# (arch, KV heads, query heads a KV head, head dim, pool and cache kinds)
SLICE_SHAPES = (("llama2-110m", 12, 1, 64, ("f32", "int8")),
                ("llama3.2-3b", 8, 3, 128, ("bf16", "int8")))


def _slices(kvh):
    """(mesh size, rank, KV-head slice) of every rank of ``SLICE_MESHES``."""
    for n in SLICE_MESHES:
        per = kvh // n
        for r in range(n):
            yield n, r, slice(r * per, (r + 1) * per)


def _head_slice(t, sl, dim):
    """A rank's own copy of heads ``sl`` along ``dim``, as its pool and
    its q are held: contiguous, nothing of the other heads."""
    return None if t is None else t.narrow(dim, sl.start,
                                           sl.stop - sl.start).contiguous()


def check_head_slices(report, dev):
    """Both paged attentions and the dense ``decode_attention`` on every
    KV-head slice a rank of a mesh of 2 and of 4 holds (``SLICE_SHAPES``:
    llama2-110m's 12 KV heads of 64 on f32 and int8 pools and caches,
    llama3.2-3b's 8 x 3 query heads of 128 on bf16 and int8 ones), each
    slice's own pool (or dense cache of 8 rows x 1024 positions) and q,
    against the same heads of one launch over every head on the same
    pool: bitwise, the paged prefix kernel's out, m and l, the decode
    kernels' out (their split partials' m and l are merged inside the
    kernel and not returned).  A head's result must not depend on how many
    heads its launch holds (the decode kernels split each (row, KV head)
    over blocks and group query heads by HQ * D, the prefix kernel orders
    its blocks heaviest first), or a mesh's streams would part from one
    card's: ``jit_serve_step`` on a mesh whose model axis splits the dense
    cache's KV heads launches ``decode_attention`` on each rank's own."""
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev).manual_seed(28)
    n_slices = 0
    for arch, kvh, hq, d, kinds in SLICE_SHAPES:
        for kind in kinds:
            bs, mb = 64, 16
            b = len(DECODE_LENS)
            k, v, ks, vs = _pools(gen, dev, b * mb, bs, kvh, d,
                                  kind == "int8", kind == "bf16")
            dk, dv, dks, dvs = _pools(gen, dev, b, bs * mb, kvh, d,
                                      kind == "int8", kind == "bf16")
            lens = torch.tensor(DECODE_LENS, dtype=torch.int32, device=dev)
            pt = _page_table(gen, dev, b, mb, b * mb,
                             [-(-n // bs) for n in DECODE_LENS])
            q = torch.randn((b, kvh, hq, d), generator=gen, device=dev)
            full = ops.paged_decode_attention_kernel(q, k, v, pt, lens, ks,
                                                     vs)
            pfx = torch.tensor(PREFILL_PFX, dtype=torch.int32, device=dev)
            qlens = torch.tensor(PREFILL_QLENS, dtype=torch.int32,
                                 device=dev)
            ptp = _page_table(gen, dev, b, mb, b * mb,
                              [-(-p // bs) for p in PREFILL_PFX])
            qp = torch.randn((b, 256, kvh, hq, d), generator=gen,
                             device=dev) / math.sqrt(d)
            fullp = ops.paged_prefill_attention_kernel(qp, k, v, ptp, pfx,
                                                       qlens, ks, vs)
            fulld = ops.decode_attention_kernel(q, dk, dv, lens, dks, dvs)
            for n, r, sl in _slices(kvh):
                got = ops.paged_decode_attention_kernel(
                    _head_slice(q, sl, 1), _head_slice(k, sl, 2),
                    _head_slice(v, sl, 2), pt, lens, _head_slice(ks, sl, 2),
                    _head_slice(vs, sl, 2))
                gotp = ops.paged_prefill_attention_kernel(
                    _head_slice(qp, sl, 2), _head_slice(k, sl, 2),
                    _head_slice(v, sl, 2), ptp, pfx, qlens,
                    _head_slice(ks, sl, 2), _head_slice(vs, sl, 2))
                gotd = ops.decode_attention_kernel(
                    _head_slice(q, sl, 1), _head_slice(dk, sl, 2),
                    _head_slice(dv, sl, 2), lens, _head_slice(dks, sl, 2),
                    _head_slice(dvs, sl, 2))
                torch.cuda.synchronize()
                what = f"{arch} {kind} pool, mesh {n} rank {r}"
                for name, a, w in (("paged_decode_attention", got, full),
                                   ("decode_attention", gotd, fulld)):
                    if not torch.equal(a, w[:, sl]):
                        raise AssertionError(
                            f"{name} on KV heads {sl.start}..{sl.stop - 1} "
                            f"({what}) differs from the full launch's")
                for name, a, w in zip(("out", "m", "l"), gotp, fullp):
                    if not torch.equal(a, w[:, :, sl]):
                        raise AssertionError(
                            f"paged_prefill_attention's {name} on KV heads "
                            f"{sl.start}..{sl.stop - 1} ({what}) differs "
                            "from the full launch's")
                n_slices += 1
            log(f"  head slices: {arch} ({kvh} KV heads x {hq} x D {d}) "
                f"{kind} pool and dense cache: both paged attentions and "
                f"decode_attention on each of the {sum(SLICE_MESHES)} "
                f"slices of meshes {SLICE_MESHES} bitwise equal to one "
                "launch over every head")
    phase(f"phase 2: head slices, {n_slices} slices x 3 kernels bitwise")


def decode_step_ops(dev):
    """Device operations of one dense decode step of llama2-110m at 8 slots
    (``decode_step_launches``) on seeded random weights.  Runs on any
    tree, so parent and change can be counted in turns."""
    from repro_torch.configs import get_config
    from repro_torch.core import qlinear
    from repro_torch.models.model import build_model
    qlinear.set_default_strategy("kernel")
    model = build_model(get_config("llama2-110m"))
    params = model.quantize(model.init(seed=0, device=dev))
    return decode_step_launches(model, params, dev)


def check_attention(report, dev):
    """paged_decode_attention at the paged decode's shapes (8 slots, f32 and
    int8 pools) and at batch 1 (len 80 and 1024), timed, then its edges
    (``paged_decode_edges``); paged_prefill_attention at the chunk step's
    shapes (f32 and int8 pools) and at B = 1 (a 256-row chunk against a
    768 prefix), timed beside its plain version, SDPA on gathered K/V and
    both floors (3xTF32 tensor cores, f32 CUDA cores), then its edges
    (``paged_prefill_edges``) and a table with -1 entries inside rows'
    prefixes.  The prefill kernel must hold TF32 HMMA instructions: it
    runs on the tensor cores."""
    b, bs, mb = 8, 64, 16
    nb = b * mb
    gen = torch.Generator(device=dev).manual_seed(1)
    rec = {}
    for int8 in (False, True):
        r = paged_decode_case(gen, dev, DECODE_LENS, int8, timed=True)
        rec[("dec", "int8" if int8 else "f32")] = (
            r["err"], r["ms"], r["plain"], r["lib"], r["bound"], r["by"])
    b1 = {n: paged_decode_case(gen, dev, [n], False, timed=True)
          for n in (80, 1024)}
    n_edges, worst = paged_decode_edges(gen, dev)

    # ---- paged prefill prefix: empty prefix, partial pages, padded q rows
    hmma = sass_count("paged_prefill_attention", "HMMA", "TF32")
    log(f"  paged_prefill_attention: {hmma} TF32 HMMA instructions in its "
        "SASS (cuobjdump -sass)")
    if hmma == 0:
        raise AssertionError("paged_prefill_attention: no TF32 HMMA in its "
                             "SASS: the kernel does not run on the tensor "
                             "cores")
    live = [-(-p // bs) + (1 if i % 2 else 0)
            for i, p in enumerate(PREFILL_PFX)]
    for int8 in (False, True):
        rec[("pre", "int8" if int8 else "f32")] = paged_prefill_case(
            gen, dev, PREFILL_PFX, PREFILL_QLENS, int8, timed=True,
            pt=_page_table(gen, dev, b, mb, nb, live))
    # one long prompt in chunks: its 256-row chunk against a 768 prefix
    pre_b1 = paged_prefill_case(gen, dev, [768], [256], False, timed=True)
    n_pre_edges, pre_worst = paged_prefill_edges(gen, dev)

    # ---- paged prefill on a table with -1 entries inside rows' prefixes
    hole_q = [7, 20, 256, 100]
    for int8 in (False, True):
        pre_worst = max(pre_worst, paged_prefill_case(
            gen, dev, HOLE_LENS, hole_q, int8,
            pt=_holes_table(gen, dev, mb, len(HOLE_LENS) * mb, bs,
                            HOLE_LENS))["err"])
    log(f"  paged_prefill_attention: -1 entries inside prefixes {HOLE_LENS} "
        f"(q_lens {hole_q}) within 2e-5, f32 and int8")

    f, i8 = rec[("dec", "f32")], rec[("dec", "int8")]
    report.add("paged_decode_attention", route="cuda",
               source="src/repro_torch/kernels/csrc/"
                      "paged_decode_attention.cu",
               header="src/repro_torch/kernels/csrc/flash_decode.cuh",
               replaces="src/repro/kernels/paged_decode_attention.py:138",
               max_abs_err=max(f[0], i8[0], worst), ms=f[1], plain_ms=f[2],
               library_ms=f[3], bound_ms=f[4], bound_by=f[5],
               int8_ms=i8[1], int8_bound_ms=i8[4], b1_80_ms=b1[80]["ms"],
               b1_80_bound_ms=b1[80]["bound"], b1_1024_ms=b1[1024]["ms"],
               b1_1024_bound_ms=b1[1024]["bound"],
               b1_1024_library_ms=b1[1024]["lib"], edges=n_edges,
               per="one layer's call, f32 pool (int8_* for the int8 pool, "
                   "b1_* at batch 1)")
    f, i8 = rec[("pre", "f32")], rec[("pre", "int8")]
    report.add("paged_prefill_attention", route="cuda",
               source="src/repro_torch/kernels/csrc/"
                      "paged_prefill_attention.cu",
               header="src/repro_torch/kernels/csrc/tf32x3.cuh",
               replaces="src/repro/kernels/paged_prefill_attention.py:215",
               max_abs_err=max(f["err"], i8["err"], pre_b1["err"],
                               pre_worst),
               ms=f["ms"], plain_ms=f["plain"], library_ms=f["lib"],
               bound_ms=f["bound"], bound_by=f["by"],
               f32_bound_ms=f["f32_bound"], int8_ms=i8["ms"],
               int8_bound_ms=i8["bound"], int8_library_ms=i8["lib"],
               b1_ms=pre_b1["ms"], b1_bound_ms=pre_b1["bound"],
               b1_library_ms=pre_b1["lib"], hmma_tf32=hmma,
               edges=n_pre_edges,
               per="one layer's call, f32 pool (int8_* for the int8 pool, "
                   "b1_* for B = 1, a 256-row chunk against prefix 768)")


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


def serve(model, params, prompts, dev, max_new, sampling=None, setup=None,
          **engine_kw):
    """Serve ``prompts`` greedily, or with the per-request ``sampling``
    keyword dicts; returns the engine, each request's streams (its output,
    or its list of sibling outputs when it has several) and the wall
    time.  ``setup(engine)`` runs before the first submit."""
    from repro_torch.serving.engine import Engine
    eng = Engine(model, params, device=dev, **engine_kw)
    if setup is not None:
        setup(eng)
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
    out = {"tok_s": toks / wall, "decode_step_ms": dec,
           ("chunk_step_ms" if eng.paged else "prefill_ms"): pre}
    energy = ""
    if "energy_joules" in m:        # a parent tree's engine may lack it
        out["energy_joules"] = joules = m["energy_joules"]
        out["tok_per_joule"] = m["tokens_out"] / joules if joules else 0.0
        energy = (f"; roofline energy {joules:.4g} J = "
                  f"{out['tok_per_joule']:.1f} tok/J (model, not measured)")
    log(f"  {tag}: {len(streams)} requests, {toks} tokens in {wall:.3f} s "
        f"= {toks / wall:.1f} tok/s; {m['decode_steps']} decode steps "
        f"{dec:.3f} ms each; {n_pre} "
        f"{'chunk steps' if eng.paged else 'whole-prompt prefills'} "
        f"{pre:.3f} ms each; prefix hits {m['prefix_hits']} "
        f"({m['prefix_cached_tokens']} tokens); preemptions "
        f"{m['preemptions']}{energy}")
    return out


def device_launches(prof):
    """(device operations, PyTorch elementwise kernels among them) that a
    profile recorded."""
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.count for e in events),
            sum(e.count for e in events if "elementwise" in e.key))


def decode_step_launches(model, params, dev):
    """Device operations of one dense decode step at 8 slots with the fused
    norm-and-quantize and the quantize kernel; with the unfused pair (the
    norm, then the product's own quantization) put back in the fused
    norm's place; and with the plain ``quantize`` put back in the quantize
    kernel's place (``ops.q8_matmul``), for the count."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import qlinear
    from repro_torch.core.quantization import quantize
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.ref import rms_norm
    from repro_torch.models import layers, transformer
    cache = model.init_cache(8, 64, device=dev)
    tokens = torch.arange(8, device=dev)
    kernel_q = ops.quantize_kernel

    def plain_q(x, gs):
        t = quantize(x, gs, 8)
        return t.q, t.scale
    unfused = (lambda x, g, eps, w: qlinear.qdot(rms_norm(x, g, eps), w))
    out = {}
    try:
        for name, norm_fn, q_fn in (
                ("fused", qlinear.norm_qdot, kernel_q),
                ("unfused", unfused, kernel_q),
                ("plain_quantize", qlinear.norm_qdot, plain_q)):
            transformer.norm_qdot = layers.norm_qdot = norm_fn
            ops.quantize_kernel = q_fn
            before = dict(build.LAUNCHES)
            model.decode_step(params, cache, tokens)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                model.decode_step(params, cache, tokens)
                torch.cuda.synchronize()
            out[name] = device_launches(prof)
            fused, quant = (build.LAUNCHES[k] - before[k]
                            for k in ("rmsnorm_quant", "quantize"))
            if ((fused > 0) != (name != "unfused")
                    or (quant > 0) != (name != "plain_quantize")):
                raise AssertionError(
                    f"the {name} decode step launched rmsnorm_quant {fused} "
                    f"and quantize {quant} times: the swap no longer "
                    f"reaches the step")
    finally:
        transformer.norm_qdot = layers.norm_qdot = qlinear.norm_qdot
        ops.quantize_kernel = kernel_q
    log(f"  one dense decode step at 8 slots: {out['fused'][0]} device "
        f"operations ({out['fused'][1]} elementwise) with rmsnorm_quant and "
        f"quantize, {out['unfused'][0]} ({out['unfused'][1]}) with the "
        f"unfused norm pair, {out['plain_quantize'][0]} "
        f"({out['plain_quantize'][1]}) with the plain quantize: the kernel "
        f"takes {out['plain_quantize'][0] - out['fused'][0]} operations off "
        "the step")
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
    for e in events:
        if "paged_prefill_kernel" in e.key:
            ms = e.self_device_time_total / 1e3
            log(f"  paged_prefill_attention at the served shapes: {ms:.3f} "
                f"ms over {e.count} calls, {ms / e.count:.4f} ms a call "
                f"({e.key[:60]})")
    return out, busy / wall


def check_launches(eng, launches, cfg, counted, bits=8, extra=None,
                   float_weights=False):
    """Every kernel of the run's path ran, and exactly as often as the
    path's shape says.  Each decode step: 4 GEMVs per layer + the head, one
    rope and one attention call per layer, and one rmsnorm_quant per
    norm-then-product pair (norm1 -> wqkv, norm2 -> w13 per layer, the
    final norm -> head: 2 per layer + 1), and one quantize in front of each
    product no norm feeds (wo_f and w2: 2 per layer).  An MoE layer has no
    MLP product on a kernel: its experts are the reference's f32 einsums,
    plain PyTorch, after the plain norm2; so 2 GEMVs, 1 rmsnorm_quant and 1
    quantize a layer in a decode step, and none in a chunk, verify or
    prefill step but the head's.  Every layer of the MoE family is MoE but
    in the llama4 interleave, whose ``n_layers // moe_every`` patterns run
    ``moe_every - 1`` dense layers and one MoE layer each (``_layer_kinds``;
    a layer past the last pattern does not run).  Paged,
    each chunk step: the MLP's two products per layer, the head's GEMV, one
    prefix-attention call per layer, rmsnorm_quant for norm2 -> w13 and
    the final norm (1 per layer + 1) and quantize for w2 (1 per layer).
    Dense, each whole-prompt prefill of S tokens: one flash_prefill per
    layer, the MLP's two products per layer at M = S, the head's GEMV,
    rmsnorm_quant and quantize as the chunk step.  Q4_0 weights put every
    product on q4_matvec.  No q8_matmul or tiled q4_matvec call of a served
    path may take its dp4a kernel (``q8_matmul_dp4a`` and
    ``q4_matvec_dp4a`` stay 0, as every counter the path does not set):
    llama2-110m's group 64 with 16-byte aligned codes runs on the tensor
    cores.  Each speculative verify call (the chunk step at ``max_slots x
    (spec_tokens + 1)`` rows with the head over all of them): one
    prefix-attention call per layer, the MLP's two products per layer and
    the head's, all at M = max_slots * (spec_tokens + 1) (the GEMM above 32
    rows, the GEMV at or below), rmsnorm_quant 1 per layer + 1 and
    quantize 1 per layer.  ``extra`` adds launches made beside the engine
    on the same run (a draft model's).  ``float_weights`` (unquantized
    parameters): the products run on torch.matmul and no norm quantizes,
    so only the attention kernels and rope launch.  The SSM families
    (dense cache only): ``_ssm_launches``.  The counts are added to
    ``counted`` for the kernels line."""
    from repro_torch.kernels import build
    if cfg.family in ("ssm", "hybrid"):
        return _ssm_launches(eng, launches, cfg, counted, bits)
    # nl attention layers, nm of them with a dense MLP (w13, w2: one fed
    # by norm2's rmsnorm_quant, one by a quantize); the others MoE
    nl, nm = _layer_kinds(cfg)
    d = eng.metrics["decode_steps"]
    gemv = "q8_matvec" if bits == 8 else "q4_matvec"
    gemm = "q8_matmul" if bits == 8 else "q4_matvec"
    want = dict.fromkeys(build.LAUNCHES, 0)
    want[gemv] += (2 * nl + 2 * nm + 1) * d
    want["rope"] += nl * d
    want["rmsnorm_quant"] += (nl + nm + 1) * d
    want["quantize"] += (nl + nm) * d
    if eng.paged:
        attn = ("paged_decode_attention", "paged_prefill_attention")
        c = eng.metrics["chunk_batch_calls"]
        rows = eng.max_slots * eng.prefill_chunk_tokens
        want[gemm if rows > 32 else gemv] += 2 * nm * c
        want[gemv] += c
        want["rmsnorm_quant"] += (nm + 1) * c
        want["quantize"] += nm * c
        want[attn[0]] += nl * d
        want[attn[1]] += nl * c
        v = eng.metrics.get("verify_steps", 0)   # a parent tree may lack it
        rows = eng.max_slots * (getattr(eng, "spec_tokens", 0) + 1)
        want[gemm if rows > 32 else gemv] += (2 * nm + 1) * v
        want["rmsnorm_quant"] += (nm + 1) * v
        want["quantize"] += nm * v
        want[attn[1]] += nl * v
    else:
        attn = ("decode_attention", "flash_prefill")
        pre = [e - s for plan in eng.plan_log for _, s, e in plan["prefills"]]
        for n in pre:
            want[gemm if n > 32 else gemv] += 2 * nm
            want[gemv] += 1
            want["rmsnorm_quant"] += nm + 1
            want["quantize"] += nm
        want[attn[0]] += nl * d
        want[attn[1]] += nl * len(pre)
    # every kernel of the path must launch: a path of MoE layers alone
    # makes no M > 32 product but its verify step's head
    path = {gemv, "rope", "rmsnorm_quant", "quantize", *attn}
    if nm or want[gemm]:
        path.add(gemm)
    if float_weights:
        for k in (gemv, gemm, "rmsnorm_quant", "quantize"):
            want[k] = 0
        path = {"rope", *attn}
    for k, n in (extra or {}).items():
        want[k] += n
    if launches != want or min(launches[k] for k in path) <= 0:
        raise AssertionError(f"launches {launches} != expected {want}")
    for k, v in launches.items():
        counted[k] = counted.get(k, 0) + v
    step = (f"{nl} rope and {nl} {attn[0]}" if float_weights else
            f"{2 * nl + 2 * nm + 1} {gemv}, {nl + nm + 1} rmsnorm_quant, "
            f"{nl + nm} quantize, {nl} rope and {nl} {attn[0]}"
            + (f" ({nm} dense layers: 4 GEMVs, 2 rmsnorm_quant, 2 quantize "
               f"each; {nl - nm} MoE layers: 2, 1, 1)"
               if 0 < nm < nl else ""))
    verifies = eng.metrics.get("verify_steps", 0)
    log(f"  launches {dict((k, v) for k, v in launches.items() if v)}: "
        f"{step} per decode step over {d} steps"
        + (f", {verifies} verify calls" if verifies else ""))


def _layer_kinds(cfg):
    """(attention layers that run, those of them with a dense MLP): every
    layer dense, every layer MoE (``moe_every`` 1), or the interleave's
    ``n_layers // moe_every`` patterns of ``moe_every - 1`` dense layers
    and one MoE layer."""
    if cfg.family != "moe":
        return cfg.n_layers, cfg.n_layers
    n_pat = cfg.n_layers // cfg.moe_every
    return n_pat * cfg.moe_every, n_pat * (cfg.moe_every - 1)


def _ssm_launches(eng, launches, cfg, counted, bits=8):
    """``check_launches`` for the SSM and hybrid families on the dense
    cache.  A Mamba2 layer at a decode step: its input quantized once for
    the four in-projections (``quantize``), 4 GEMVs (wz, wx, wB, wC), the
    gated norm fused with out_proj's quantization (``rmsnorm_quant``) and
    out_proj's GEMV: 5 GEMVs, 1 ``quantize``, 1 ``rmsnorm_quant``; the
    scan, the convolutions and the recurrence are plain PyTorch, as in the
    reference.  A whole-prompt prefill of S tokens: the same 5 products at
    M = S (the GEMM above 32 rows), 1 ``quantize``, 1 ``rmsnorm_quant`` a
    layer.  The hybrid's shared block, at each of its n_layers //
    attn_every applications, is the dense layer: at a decode step 4 GEMVs,
    2 ``rmsnorm_quant``, 2 ``quantize``, 1 rope, 1 ``decode_attention``; at
    a prefill 1 ``flash_prefill`` (Q/K/V/O on the dequant ``qeinsum``, rope
    plain), the MLP's 2 products at M = S, 1 ``rmsnorm_quant``, 1
    ``quantize``.  The head: 1 GEMV and 1 ``rmsnorm_quant`` a decode step
    or prefill (its last row).  Every kernel of the path must launch."""
    from repro_torch.kernels import build
    n_ssm = cfg.n_layers
    n_attn = cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" else 0
    d = eng.metrics["decode_steps"]
    gemv = "q8_matvec" if bits == 8 else "q4_matvec"
    gemm = "q8_matmul" if bits == 8 else "q4_matvec"
    want = dict.fromkeys(build.LAUNCHES, 0)
    want[gemv] += (5 * n_ssm + 4 * n_attn + 1) * d
    want["quantize"] += (n_ssm + 2 * n_attn) * d
    want["rmsnorm_quant"] += (n_ssm + 2 * n_attn + 1) * d
    want["rope"] += n_attn * d
    want["decode_attention"] += n_attn * d
    pre = [e - s for plan in eng.plan_log for _, s, e in plan["prefills"]]
    for n in pre:
        want[gemm if n > 32 else gemv] += 5 * n_ssm + 2 * n_attn
        want[gemv] += 1
        want["quantize"] += n_ssm + n_attn
        want["rmsnorm_quant"] += n_ssm + n_attn + 1
        want["flash_prefill"] += n_attn
    path = {gemv, "quantize", "rmsnorm_quant"}
    if n_attn:
        path |= {"rope", "decode_attention", "flash_prefill"}
    if any(n > 32 for n in pre):
        path.add(gemm)
    if (eng.paged or launches != want
            or min(launches[k] for k in path) <= 0):
        raise AssertionError(f"{cfg.arch_id}: launches {launches} != "
                             f"expected {want} (paged {eng.paged})")
    for k, v in launches.items():
        counted[k] = counted.get(k, 0) + v
    log(f"  launches {dict((k, v) for k, v in launches.items() if v)}: "
        f"{5 * n_ssm + 4 * n_attn + 1} {gemv}, {n_ssm + 2 * n_attn + 1} "
        f"rmsnorm_quant, {n_ssm + 2 * n_attn} quantize"
        + (f", {n_attn} rope and {n_attn} decode_attention" if n_attn
           else "")
        + f" per decode step over {d} steps; {len(pre)} whole-prompt "
        f"prefills")


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


def reduced_cpu_vs_card(dev, arch="llama2-110m"):
    """The reduced config with the same weights: plain versions on the CPU
    against the kernels on the card, on the paged and the dense Engine.
    Logits may differ by the ~3e-2 an int8 activation code flipped by a
    last-place difference moves them (the CPU tests measure this); streams
    may part only at a step whose top-2 gap is below that.  A bf16 config
    (llama3.2-3b) runs greedy only: the sampled check is llama2-110m's."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.model import build_model, params_to
    cfg = reduced(get_config(arch))
    f32 = cfg.compute_dtype == "float32"
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
    ddiff = (prefill_logits(p_cpu) - prefill_logits(p_dev)).abs().max() \
        .item()
    phase(f"phase 5: reduced {arch} ({cfg.compute_dtype}), CPU plain vs card "
          f"kernels: first chunk step logits max |diff| {diff:.3g}, "
          f"whole-prompt prefill logits {ddiff:.3g} (tol {FLIP_TOL})")
    if not (diff <= FLIP_TOL and ddiff <= FLIP_TOL):
        raise AssertionError(f"first-step logits differ by {diff}, {ddiff}")
    for extra in ({}, {"cache_kind": "dense"}):
        _, cpu_streams, _ = serve(model, p_cpu, prompts, cpu, 8, **kw,
                                  **extra)
        _, dev_streams, _ = serve(model, p_dev, prompts, dev, 8, **kw,
                                  **extra)
        compare_streams(f"{arch} {extra.get('cache_kind', 'paged')} CPU vs "
                        "card",
                        dev_streams, cpu_streams, prompts,
                        lambda seq, *_: _top2_gap(model, p_cpu, seq, cpu),
                        FLIP_TOL)
    if f32:
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


def _overlap_timer(eng):
    """Wrap ``eng``'s step_async / finish_step to record the host seconds
    between a step's dispatch and its completion (the overlap window)."""
    windows, stamp = [], [0.0]
    step_async, finish_step = eng.step_async, eng.finish_step

    def timed_async():
        out = step_async()
        stamp[0] = time.perf_counter()
        return out

    def timed_finish(pending=None):
        if pending is not None:
            windows.append(time.perf_counter() - stamp[0])
        return finish_step(pending)
    eng.step_async, eng.finish_step = timed_async, timed_finish
    return windows


def _chunks_of(plan_log):
    """Each request's prompt chunks, (start, end) in order."""
    out = {}
    for plan in plan_log:
        for uid, start, end in plan["prefills"]:
            out.setdefault(uid, []).append((start, end))
    return out


def open_loop(dev, cfg, params, counted, closed_energy):
    """Phase 13: 16 of phase 3's requests, half greedy and half at
    temperature 0.8, top_p 0.95, each with its own seed, served closed,
    then open loop (seeded Poisson arrivals at 0.85 of the closed run's
    request rate, ``async_serving.run_open_loop``), then replayed closed
    with ``Engine.step`` and each request submitted before the step the
    open loop released it to.  The replay must give the open loop's plans
    and streams bitwise: stepping asynchronously and arriving mid-flight
    change nothing.  Against the all-at-once closed run a request whose
    prompt was cut into other chunks may part, under the integer
    arithmetic, only at a near-tie (as phase 7's dense-vs-paged streams).
    No block may stay leased and the chunk step may take no new shape.
    Then a decode-only ``step_async`` under
    ``torch.cuda.set_sync_debug_mode("error")``, a request past its
    deadline, a burst shed by the queue bound, and ``serve.py
    --open-loop`` as a subprocess."""
    from repro_torch.kernels import build
    from repro_torch.models.model import build_model
    from repro_torch.serving import async_serving as tas
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.faults import ERR_DEADLINE, ERR_SHED
    model = build_model(cfg)
    prompts = _requests(16, 16, 600, cfg.vocab_size, seed=0, shared_len=128,
                        shared_at=(0, 9, 12, 15))
    sampling = [dict(temperature=TEMP, top_p=TOP_P, seed=300 + i)
                if i % 2 else dict(temperature=0.0, seed=300 + i)
                for i in range(len(prompts))]
    phase("phase 13: llama2-110m full width, paged f32 pool, 16 requests "
          f"(half greedy, half t {TEMP} top_p {TOP_P}) closed")
    build.reset_launches()
    eng, closed, wall = serve(model, params, prompts, dev, 32, sampling,
                              **PAGED_KW)
    check_launches(eng, dict(build.LAUNCHES), cfg, counted)
    engine_line("closed", eng, closed, wall)
    shapes = eng.prefill_compile_count()
    rate = 0.85 * len(prompts) / wall
    offsets = tas.poisson_arrivals(13, len(prompts), rate)
    workload = [(float(t), p, dict(max_new_tokens=32, **kw))
                for t, p, kw in zip(offsets, prompts, sampling)]
    phase(f"phase 13: the same requests open loop, Poisson arrivals at "
          f"{rate:.2f} req/s (0.85 of the closed run's)")
    closed_chunks = _chunks_of(eng.plan_log)
    build.reset_launches()
    eng = Engine(model, params, device=dev, **PAGED_KW)
    windows = _overlap_timer(eng)
    marks, submit_request = [], eng.submit_request

    def marked(prompt, **kw):
        marks.append(len(eng.plan_log))
        return submit_request(prompt, **kw)
    eng.submit_request = marked
    t0 = time.perf_counter()
    handles, report = tas.run_open_loop(eng, workload)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    check_launches(eng, dict(build.LAUNCHES), cfg, counted)
    bad = [(h.uid, h.error) for h in handles if h.error is not None]
    streams = [list(h.req.output) for h in handles]
    if bad or any(eng.pager.refcount) \
            or eng.prefill_compile_count() != shapes:
        raise AssertionError(f"open loop: failed {bad}, or leaked blocks, "
                             "or took a new chunk shape")
    m = eng.metrics
    open_log = eng.plan_log

    build.reset_launches()
    eng = Engine(model, params, device=dev, **PAGED_KW)
    order = iter(zip(marks, prompts, sampling))
    nxt, done = next(order, None), []
    while nxt is not None or eng.scheduler.has_work():
        while nxt is not None and nxt[0] == len(eng.plan_log):
            eng.submit(nxt[1], max_new_tokens=32, **nxt[2])
            nxt = next(order, None)
        out = eng.step()
        if out is None and nxt is not None:
            raise AssertionError("the replay idled before its next arrival")
        done.extend(out or [])
    check_launches(eng, dict(build.LAUNCHES), cfg, counted)
    replay = [list(r.output) for r in sorted(done, key=lambda r: r.uid)]
    if eng.plan_log != open_log or replay != streams:
        raise AssertionError("the closed replay of the open loop's arrivals "
                             "gave other plans or streams")
    open_chunks = _chunks_of(open_log)
    recut = [u - 1 for u in sorted(open_chunks)
             if open_chunks[u] != closed_chunks[u]]
    log(f"  closed replay (Engine.step, each request submitted before the "
        f"step the open loop released it to): the open loop's {len(marks)} "
        f"arrivals, {len(open_log)} plans and 16 streams, bitwise; requests "
        f"{recut} were cut into other chunks than in the all-at-once closed "
        "run")
    greedy_gap = (lambda seq, *_: _top2_gap(model, params, seq, dev))
    sampled_gap = _sampled_gap(model, params, dev,
                               [(300 + i, 0) for i in range(len(prompts))],
                               TEMP, TOP_P)
    compare_streams("open loop vs all-at-once closed", streams, closed,
                    prompts, lambda seq, n, i: (sampled_gap if i % 2 else
                                                greedy_gap)(seq, n, i),
                    FULL_FLIP_TOL)
    win_ms = 1e3 * sum(windows) / max(1, len(windows))
    out = {"goodput_tok_s": report.goodput_tok_s,
           "ttft_ms": {k: report.ttft_ms[k] for k in ("p50", "p99")},
           "tpot_ms": {k: report.tpot_ms[k] for k in ("p50", "p99")},
           "midflight_submits": report.midflight_submits,
           "peak_queue_depth": report.peak_queue_depth,
           "overlap_window_host_ms": win_ms,
           "energy_joules": m["energy_joules"],
           "tok_per_joule": m["tokens_out"] / m["energy_joules"],
           "closed_energy_joules": closed_energy["energy_joules"],
           "closed_tok_per_joule": closed_energy["tok_per_joule"]}
    ttft, tpot = report.ttft_ms, report.tpot_ms
    log(f"  open loop: 16/16 requests served, no block leased, {shapes} "
        f"chunk shapes; goodput "
        f"{report.goodput_tok_s:.1f} tok/s over {report.wall_s:.3f} s "
        f"({wall:.3f} s with the last sync); TTFT p50 {ttft['p50']:.1f} ms, "
        f"p99 {ttft['p99']:.1f} ms; TPOT p50 {tpot['p50']:.2f} ms, p99 "
        f"{tpot['p99']:.2f} ms (from true arrival); "
        f"{report.midflight_submits} arrivals mid-flight, peak queue depth "
        f"{report.peak_queue_depth}; host {win_ms:.3f} ms in the overlap "
        f"window over {len(windows)} steps; roofline energy "
        f"{m['energy_joules']:.4g} J = {out['tok_per_joule']:.1f} tok/J "
        f"(phase 3 closed: {closed_energy['energy_joules']:.4g} J = "
        f"{closed_energy['tok_per_joule']:.1f} tok/J; model, not measured)")

    phase("phase 13: a decode-only step_async under sync debug mode "
          "'error', then a request past its deadline")
    build.reset_launches()
    eng = Engine(model, params, device=dev, **PAGED_KW)
    for p, kw in zip(prompts[:8], sampling[:8]):
        eng.submit(p, max_new_tokens=8, **kw)
    while eng.scheduler.has_work() and (
            eng.scheduler.waiting or not eng.plan_log
            or eng.plan_log[-1]["prefills"]):
        eng.step()
    # a ~0.5 s spin queued first: a dispatch that waited for the card
    # would return after it, with its tokens' event already passed
    torch.cuda.synchronize(dev)
    torch.cuda._sleep(int(1e9))
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        done, pending = eng.step_async()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    host_ms = (time.perf_counter() - t0) * 1e3
    if pending is None or eng.plan_log[-1]["prefills"]:
        raise AssertionError("the checked step was not a decode-only "
                             "dispatch")
    if pending.decode.draw.event.query():
        raise AssertionError(f"step_async returned after {host_ms:.1f} ms "
                             "with the card idle: it waited for the card")
    done += eng.finish_step(pending)
    wait_ms = (time.perf_counter() - t0) * 1e3
    late = eng.submit(prompts[8], max_new_tokens=8, deadline_ms=0.001)
    done += eng.run()
    check_launches(eng, dict(build.LAUNCHES), cfg, counted)
    kinds = {r.uid: r.error_kind for r in done}
    if kinds.pop(late) != ERR_DEADLINE or any(kinds.values()) \
            or eng.metrics["deadline_misses"] != 1:
        raise AssertionError(f"deadline check: {kinds}, late request "
                             f"{late}")
    log(f"  {len(pending.decode.slots)} rows dispatched in {host_ms:.2f} ms "
        f"of host time with no sync, the card still busy with the spin "
        f"queued before it (finish_step returned at {wait_ms:.1f} ms); the "
        f"request with deadline_ms=0.001 failed with {ERR_DEADLINE!r}, the "
        "other 8 completed")

    phase("phase 13: AsyncServer(max_queue_depth=2) under a burst of 6")
    build.reset_launches()
    eng = Engine(model, params, device=dev, **PAGED_KW)
    server = tas.AsyncServer(eng, max_queue_depth=2)
    burst = [server.submit(p, max_new_tokens=8, **kw)
             for p, kw in zip(prompts[:6], sampling[:6])]
    while server.has_work():
        server.step()
    check_launches(eng, dict(build.LAUNCHES), cfg, counted)
    shed = [h for h in burst if h.error_kind == ERR_SHED]
    if not shed or any(h.error for h in burst if h not in shed) \
            or eng.metrics["shed_requests"] != len(shed):
        raise AssertionError(f"shed check: {[h.error for h in burst]}")
    log(f"  {len(shed)} of 6 shed with {ERR_SHED!r}, the rest served")

    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--open-loop",
           "--full", "--requests", "16", "--slots", "8", "--max-seq", "1024"]
    phase(f"phase 13: {' '.join(cmd[1:])} as a subprocess")
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(SRC)))
    secs = time.perf_counter() - t0
    for line in res.stdout.splitlines():
        log(f"    {line}")
    if res.returncode != 0 or "[serve] open loop: 16/16 ok" not in res.stdout:
        raise AssertionError(f"serve --open-loop exited {res.returncode}: "
                             f"{res.stderr[-2000:]}")
    log(f"  serve --open-loop ran in {secs:.1f} s")
    out["module_s"] = secs
    return out


# ---------------------------------------------------------------------------
# phases 14-15: speculative decoding and the fault domain
# ---------------------------------------------------------------------------


class _Replay:
    """A proposer replaying known greedy streams, looked up by prompt: its
    drafts are right until the served stream parts from the known one,
    then it proposes nothing."""

    def __init__(self, prompts, streams):
        self.ref = {p.tobytes(): [int(t) for t in s]
                    for p, s in zip(prompts, streams)}

    def propose(self, prompt, output, k):
        ref = self.ref[np.asarray(prompt, np.int32).tobytes()]
        m = len(output)
        return ref[m:m + k] if output == ref[:m] else []


class _Wrong(_Replay):
    """Drafts that are always wrong: the known stream's tokens plus one."""

    def propose(self, prompt, output, k):
        ref = self.ref[np.asarray(prompt, np.int32).tobytes()]
        m = len(output)
        return [(t + 1) % 32000 for t in ref[m:m + k]] or [3] * k


class _CountingDraft:
    """Wraps a ``DraftModelProposer``: records (context length, drafts) of
    each call that ran the draft model, for its launches and the log."""

    def __init__(self, inner):
        self.inner, self.calls = inner, []

    def propose(self, prompt, output, k):
        drafts = self.inner.propose(prompt, output, k)
        if drafts:
            self.calls.append((len(prompt) + len(output), list(drafts)))
        return drafts


def _draft_launches(nl, calls):
    """The launches of the draft model's calls: per call one whole-context
    prefill (as a dense-cache prefill in ``check_launches``) and one dense
    decode step per draft after the first."""
    out = {}

    def add(k, n):
        out[k] = out.get(k, 0) + n
    for s, drafts in calls:
        add("flash_prefill", nl)
        add("q8_matmul" if s > 32 else "q8_matvec", 2 * nl)
        add("q8_matvec", 1)
        add("rmsnorm_quant", nl + 1)
        add("quantize", nl)
        d = len(drafts) - 1
        add("q8_matvec", (4 * nl + 1) * d)
        add("rope", nl * d)
        add("rmsnorm_quant", (2 * nl + 1) * d)
        add("quantize", 2 * nl * d)
        add("decode_attention", nl * d)
    return out


def _step_timers(eng):
    """Record the wall ms of each of ``eng``'s synchronous decode calls and
    verify calls: both end by waiting for their tokens, so each spans its
    device step and its host work."""
    times = {"decode": [], "verify": []}
    for key, name in (("decode", "_decode_once"),
                      ("verify", "_run_verifies")):
        def timed(*args, _fn=getattr(eng, name), _key=key):
            t0 = time.perf_counter()
            out = _fn(*args)
            times[_key].append(1e3 * (time.perf_counter() - t0))
            return out
        setattr(eng, name, timed)
    return times


# Phase 14's fixed bound (C2) on the verify step's logits against the
# decode step's at the same positions: plain_delta_bound's form, lambda *
# sqrt(N) * unit * scale, with the rounding sites where the two paths part
# counted from models/transformer.py, and the scale the plain logits'
# largest magnitude (the verify step on the plain versions over the same
# positions).  It never reads the measured difference.
#   Q8_0 weights, unit half a Q8_0 code step (1/254 of a group's largest
#   value).  A layer's verify (the chunk path, ``_chunk_step``) takes
#   Q/K/V/O through the dequant ``qeinsum`` on unquantized activations;
#   its decode requantizes them for the ``wqkv`` and ``wo_f`` GEMVs
#   (``norm_qdot``, ``qdot``): 2 sites a layer, each activation off by up
#   to half a step.  Both paths requantize the MLP's two inputs (norm2
#   for ``w13``, the SwiGLU product for ``w2``) and the head's (the final
#   norm), from inputs that already differ: a code flips only where that
#   difference carries a value over a rounding boundary, by one step at
#   most, so each is counted as one more site at the same unit: N = 4 *
#   n_layers + 1.
#   f32 weights: nothing is requantized.  The unit is the attention
#   kernels' own rounding, 2e-5 of the values' scale: the tolerance phase
#   2 holds both to against their plain versions (f32 summation order;
#   the prefix attention's 3xTF32 drops only the low x low products, ~2^-22
#   of each).  A layer's attention (the verify's prefix attention merged
#   with its chunk's keys, the decode's split-K) is one site; its four
#   f32 products run at M = 8 (k + 1) rows against 8, where the library
#   may sum K in another order, within 3 sqrt(K) 2^-24 < 2e-5 of the
#   values (K <= 2048): one site each at the same unit, and the head's one
#   more: N = 5 * n_layers + 1.
VERIFY_F32_UNIT = 2e-5


def verify_decode_bound(cfg, scale: float, quantized: bool = True) -> float:
    if quantized:
        return (PLAIN_DELTA_LAMBDA * math.sqrt(4 * cfg.n_layers + 1)
                * PLAIN_DELTA_UNIT * scale)
    return (PLAIN_DELTA_LAMBDA * math.sqrt(5 * cfg.n_layers + 1)
            * VERIFY_F32_UNIT * scale)


def verify_decode_delta(model, params, prompts, streams, dev, k,
                        fault=None, decode=True):
    """How far the verify step's logits are from the decode step's at the
    same positions: ``prompts`` (at most 8) prefilled as one chunk each
    into a fresh pool, then along their greedy ``streams``, for each
    stretch of k + 1 tokens, one ``verify_chunk_batch`` at the engine's
    (8, k + 1) extent and k + 1 ``decode_step`` s over the same positions,
    the decode's K/V rows written last, so each verify reads a prefix the
    decode wrote, as in the engine.  ``fault``: a planted fault
    (``_planted_faults``) wrapping its kernel entry for the verify calls
    only; ``decode=False``: the verify calls alone, each reading the
    prefix the verifies before it wrote (no difference: the first two
    results are None).  Runs under a config of its own, so the served
    config's shape counts do not move.  Returns (max |diff| over every
    position and logit, the median of the per-position maxima, the
    positions, both steps' logits' largest magnitude)."""
    from repro_torch.models.model import build_model
    m = build_model(model.cfg.with_(arch_id=model.cfg.arch_id + "-delta"))
    b, mb, bs = 8, 16, 64
    cache = m.init_paged_cache(b, block_size=bs, n_blocks=b * mb,
                               max_blocks_per_seq=mb, device=dev)
    pt = np.arange(b * mb, dtype=np.int32).reshape(b, mb)
    cache["page_table"] = torch.from_numpy(pt).to(dev)
    n = len(prompts)
    plen = np.zeros(b, np.int32)
    plen[:n] = [len(p) for p in prompts]
    toks = np.zeros((b, plen.max()), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    slots = np.where(np.arange(b) < n, np.arange(b), -1)
    _, cache = m.prefill_chunk_batch(params, toks, cache, slots, 0,
                                     page_table=pt, chunk_lens=plen)
    steps = min(len(s) for s in streams) - 1
    width, per, top = k + 1, [], []
    for start in range(0, steps, width):
        c = min(width, steps - start)
        vt = np.zeros((b, width), np.int32)
        for i, st in enumerate(streams):
            vt[i, :c] = st[start:start + c]
        offs = plen + start
        with planted(fault) if fault else contextlib.nullcontext():
            vl, cache = m.verify_chunk_batch(
                params, vt, cache, slots, offs, page_table=pt,
                chunk_lens=np.where(slots >= 0, c, 0))
        top.append(vl[:n, :c].abs().amax())
        if not decode:
            continue
        cache["lens"] = torch.as_tensor(offs, device=dev)
        for j in range(c):
            dl, cache = m.decode_step(params, cache,
                                      torch.as_tensor(vt[:, j], device=dev))
            per.append((dl[:n] - vl[:n, j]).abs().amax(dim=-1))
            top.append(dl[:n].abs().amax())
    scale = torch.stack(top).max().item()
    if not decode:
        return None, None, n * steps, scale
    per = torch.stack(per).flatten()
    return per.max().item(), per.median().item(), per.numel(), scale


# the planted faults on the verify path that phase 14's bound must reject
# (f32 pool, spec_tokens=4: the verify's M = 40 rows run q8_matmul; the
# prefix read runs paged_prefill_attention), and on the f32-weights run
# (no Q8_0 product; the prefix read)
VERIFY_CONTROLS = ("q8_matmul: last K group dropped",
                   "paged_prefill_attention: prefix one key short")
F32_VERIFY_CONTROLS = ("paged_prefill_attention: prefix one key short",)


def _verify_held(tag, model, params, reqs, streams, dev, k, quantized=True,
                 controls=()):
    """The verify step's logits against the decode step's
    (``verify_decode_delta`` over the first 8 requests along their plain
    ``streams``), held to the fixed bound ``verify_decode_bound`` at the
    scale of the plain versions' verify logits over the same positions
    (``plain_versions``, the verify calls alone); then,
    for each planted fault of ``controls``, the same difference with the
    fault on the verify calls.  Raises if the difference exceeds the
    bound, or a required control's does not.  Returns the record."""
    with plain_versions():
        scale = verify_decode_delta(model, params, reqs[:8], streams[:8],
                                    dev, k, decode=False)[3]
    delta, med, npos, _ = verify_decode_delta(model, params, reqs[:8],
                                              streams[:8], dev, k)
    tol = verify_decode_bound(model.cfg, scale, quantized)
    sites = (4 if quantized else 5) * model.cfg.n_layers + 1
    unit = PLAIN_DELTA_UNIT if quantized else VERIFY_F32_UNIT
    log(f"  {tag}: verify vs decode logits at the same positions ({npos} "
        f"positions of 8 streams): max |diff| {delta:.4g}, median of the "
        f"per-position maxima {med:.4g}; the plain versions' verify "
        f"logits' scale {scale:.4g}; fixed bound {PLAIN_DELTA_LAMBDA:g} * "
        f"sqrt({sites}) * {unit:.4g} * scale = {tol:.4g} "
        f"({delta / tol:.3f} of it)")
    if not delta <= tol:
        raise AssertionError(f"{tag}: verify vs decode logits differ by "
                             f"{delta} > the fixed bound {tol}")
    rec = {"verify_decode_max_abs_diff": delta,
           "verify_decode_median_diff": med, "scale": scale, "bound": tol,
           "controls": {}}
    faults = _planted_faults()
    for name in controls:
        hit = verify_decode_delta(model, params, reqs[:8], streams[:8], dev,
                                  k, fault=name)[0]
        rec["controls"][name] = hit
        log(f"    control, {name} (verify calls only): max |diff| "
            f"{hit:.4g} ({hit / tol:.2f} x the bound"
            f"{'' if faults[name][2] else '; measured, not required'})")
    missed = [n for n, hit in rec["controls"].items()
              if faults[n][2] and not hit > tol]
    if missed:
        raise AssertionError(f"{tag}: the fixed bound {tol} does not reject "
                             f"the planted faults {missed}: "
                             f"{rec['controls']}")
    return rec


def speculation(dev, cfg, params, prompts, counted):
    """Phase 14: phase 3's 16 requests plus 4 repetitive ones (a tiled
    8-token pattern), 32 greedy tokens each, served with and without
    speculation: the f32 pool at spec_tokens=4 (verify extent 8 x 5 = 40
    rows: q8_matmul) and the int8 pool at spec_tokens=3 (8 x 4 = 32 rows:
    q8_matvec), n-gram drafts.  Under the integer arithmetic the verify's
    logits come from the chunk path (dequant Q/K/V/O) and the decode's
    from the integer wqkv / wo_f GEMVs: their difference
    (``verify_decode_delta``) is held to the fixed bound
    ``verify_decode_bound`` (written before the run; never read from the
    measurement), which planted faults on the verify path must exceed
    (``VERIFY_CONTROLS`` on the f32 pool, ``F32_VERIFY_CONTROLS`` on the
    f32-weights run), and the streams may part only
    at a step whose top-2 gap is below that bound.  Then f32 weights (no
    activation quantization: the paths differ by the attention kernels'
    and the f32 products' rounding, their own bound), a replay oracle
    (acceptance near 1), always-wrong drafts (a rollback on every verify
    row, the plain streams), one verify shape per pool and no new chunk
    shape, drained pools, and ``DraftModelProposer`` with the target as
    its own draft over 2 requests."""
    from repro_torch.kernels import build
    from repro_torch.models.model import build_model
    from repro_torch.serving.spec_decode import DraftModelProposer
    nl = cfg.n_layers
    rng = np.random.default_rng(14)
    reqs = prompts + [np.tile(rng.integers(4, cfg.vocab_size, size=8), 6)
                      .astype(np.int32) for _ in range(4)]
    out = {}

    def served(tag, model, p, kw, reqs_=reqs, extra=None, **spec):
        build.reset_launches()
        times = {}
        shapes = model.prefill_compile_count()
        eng, streams, wall = serve(
            model, p, reqs_, dev, 32,
            setup=lambda e: times.update(_step_timers(e)), **kw, **spec)
        check_launches(eng, dict(build.LAUNCHES), cfg, counted,
                       extra=extra(eng) if extra else None,
                       float_weights=p is not params)
        m = eng.metrics
        if any(eng.pager.refcount) or not eng.pager.audit().clean:
            raise AssertionError(f"{tag}: the pool did not drain clean")
        if spec and model.prefill_compile_count() != shapes:
            raise AssertionError(f"{tag}: the chunk step took a new shape")
        if spec and eng.verify_compile_count() != 1:
            raise AssertionError(f"{tag}: the verify step ran at "
                                 f"{eng.verify_compile_count()} shapes")
        toks = sum(len(s) for s in streams)
        rec = {"tok_s": toks / wall,
               "steps_per_token": m["steps_per_token"],
               "decode_step_ms": float(np.mean(times["decode"]))
               if times["decode"] else None,
               "verify_step_ms": float(np.mean(times["verify"]))
               if times["verify"] else None,
               "accept_ratio": m["accept_ratio"]}
        log(f"  {tag}: {len(streams)} requests, {toks} tokens in {wall:.3f} "
            f"s = {rec['tok_s']:.1f} tok/s; steps/token "
            f"{m['steps_per_token']:.3f}; {len(times['decode'])} decode "
            f"calls {rec['decode_step_ms'] or 0:.3f} ms, "
            f"{len(times['verify'])} verify calls "
            f"{rec['verify_step_ms'] or 0:.3f} ms each; drafts "
            f"{m['draft_tokens']}, accepted {m['accepted_tokens']} "
            f"(ratio {m['accept_ratio']:.3f}), rollbacks "
            f"{m['spec_rollbacks']}; pool drained, audit clean")
        return eng, streams, rec

    for kv, k in (("float32", 4), ("int8", 3)):
        model = build_model(cfg.with_(kv_cache_dtype=kv))
        phase(f"phase 14: speculation, {kv} pool, 20 greedy requests (16 of "
              f"phase 3's + 4 repetitive), plain then spec_tokens={k} "
              f"(verify at M = {8 * (k + 1)} rows)")
        _, base, rec_base = served(f"{kv} pool, plain", model, params,
                                   PAGED_KW)
        eng, spec, rec_spec = served(f"{kv} pool, spec_tokens={k}", model,
                                     params, PAGED_KW, spec_tokens=k)
        if eng.metrics["verify_steps"] == 0:
            raise AssertionError(f"{kv}: no verify step ran")
        held = _verify_held(
            f"{kv} pool", model, params, reqs, base, dev, k,
            controls=VERIFY_CONTROLS if kv == "float32" else ())
        compare_streams(f"{kv} pool, spec_tokens={k} vs plain", spec, base,
                        reqs, lambda seq, *_: _top2_gap(model, params, seq,
                                                        dev), held["bound"])
        out[kv] = {"plain": rec_base, "spec": rec_spec, **held}
        if kv == "float32":
            model32, base32 = model, base

    phase("phase 14: f32 (unquantized) weights, f32 pool, plain then "
          "spec_tokens=4")
    p32 = model32.init(seed=0, device=dev)
    _, fbase, _ = served("f32 weights, plain", model32, p32, PAGED_KW)
    _, fspec, _ = served("f32 weights, spec_tokens=4", model32, p32,
                         PAGED_KW, spec_tokens=4)
    out["f32_weights"] = held = _verify_held(
        "f32 weights", model32, p32, reqs, fbase, dev, 4, quantized=False,
        controls=F32_VERIFY_CONTROLS)
    tol32 = held["bound"]
    compare_streams("f32 weights, spec_tokens=4 vs plain", fspec, fbase,
                    reqs, lambda seq, *_: _top2_gap(model32, p32, seq, dev),
                    tol32)

    phase("phase 14: replay-oracle and always-wrong drafts, f32 weights, "
          "f32 pool, spec_tokens=4, 8 requests")
    few, ref = reqs[12:], fbase[12:]
    gap = (lambda seq, *_: _top2_gap(model32, p32, seq, dev))
    eng, replay, rec = served("replay oracle", model32, p32, PAGED_KW, few,
                              spec_tokens=4,
                              draft_proposer=_Replay(few, ref))
    if not rec["accept_ratio"] > 0.95:
        raise AssertionError(f"replay oracle: accept_ratio "
                             f"{rec['accept_ratio']}")
    eng, wrong, _ = served("always-wrong drafts", model32, p32, PAGED_KW,
                           few, spec_tokens=4,
                           draft_proposer=_Wrong(few, ref))
    rows = sum(len(pl["verifies"]) for pl in eng.plan_log)
    m = eng.metrics
    if not (rows > 0 and m["spec_rollbacks"] == rows
            and m["accepted_tokens"] == 0):
        raise AssertionError(f"always-wrong drafts: {m['spec_rollbacks']} "
                             f"rollbacks over {rows} verify rows, "
                             f"{m['accepted_tokens']} accepted")
    log(f"  always-wrong drafts: a rollback on each of the {rows} verify "
        "rows, none accepted")
    compare_streams("replay oracle vs plain", replay, ref, few, gap, tol32)
    compare_streams("always-wrong drafts vs plain", wrong, ref, few, gap,
                    tol32)
    out["replay_accept_ratio"] = rec["accept_ratio"]
    del p32

    phase("phase 14: DraftModelProposer (the target drafting for itself), "
          "2 requests, spec_tokens=4")
    draft = _CountingDraft(DraftModelProposer(model32, params, max_seq=1024))
    two = [reqs[16], reqs[1]]
    eng, dstreams, rec = served(
        "draft model", model32, params, PAGED_KW, two, spec_tokens=4,
        draft_proposer=draft,
        extra=lambda e: _draft_launches(nl, draft.calls))
    for s, d in draft.calls[:6]:
        log(f"    draft model at context {s}: proposed {d}")
    log(f"    ... {len(draft.calls)} proposals in all")
    compare_streams("draft model vs plain", dstreams, [base32[16], base32[1]],
                    two, lambda seq, *_: _top2_gap(model32, params, seq, dev),
                    out["float32"]["bound"])
    out["draft_model_accept_ratio"] = rec["accept_ratio"]
    return out


def fault_domain(dev, cfg, params, counted):
    """Phase 15: 8 requests of 30 tokens (all admitted and prefilled in the
    first step, so a failure never moves another request's admission or
    chunks), 40 greedy tokens each, f32 pool.  Against the run without a
    fault layer: an empty ``FaultPlan`` gives the same streams and plans
    bitwise; a transient decode-step fault is retried (one retry) with the
    streams bitwise; a persistent fault aimed at one request fails it alone
    (``ERR_FAULT``); a NaN written into one request's decode row after its
    first block is registered fails it (``ERR_NAN``) and its blocks leave
    the prefix index; under spec_tokens=4 the same NaN hits a verify row;
    a corrupted refcount is repaired by the per-step audit, failing its
    leaseholder (``ERR_AUDIT``); a latency fault under ``SimClock`` counts
    a slow step.  Every survivor's stream is bitwise its fault-free
    one."""
    from repro_torch.kernels import build
    from repro_torch.models.model import build_model
    from repro_torch.serving.faults import (ERR_AUDIT, ERR_FAULT, ERR_NAN,
                                            FaultPlan, SimClock)
    model = build_model(cfg)
    reqs = _requests(8, 30, 30, cfg.vocab_size, seed=15)

    def run(tag, plan=None, reqs_=reqs, **kw):
        build.reset_launches()
        if plan is not None:
            kw.update(faults=plan, clock=SimClock())
        from repro_torch.serving.engine import Engine
        eng = Engine(model, params, device=dev, **PAGED_KW, **kw)
        for p in reqs_:
            eng.submit(p, max_new_tokens=40, temperature=0.0)
        done = {r.uid: r for r in eng.run()}
        check_launches(eng, dict(build.LAUNCHES), cfg, counted)
        if any(eng.pager.refcount) or not eng.pager.audit().clean:
            raise AssertionError(f"{tag}: the pool did not drain clean")
        return eng, done

    def survivors(tag, done, clean, failed, kind):
        bad = {u: (r.error_kind, r.error) for u, r in done.items()
               if (u in failed) != (r.error is not None)}
        wrong = [u for u in failed if done[u].error_kind != kind]
        diff = [u for u, r in done.items()
                if u not in failed and r.output != clean[u]]
        if bad or wrong or diff:
            raise AssertionError(f"{tag}: unexpected failures {bad}, kinds "
                                 f"{wrong}, survivors not bitwise {diff}")
        log(f"  {tag}: uids {sorted(failed)} failed ({kind}), the other "
            f"{len(done) - len(failed)} streams bitwise the fault-free ones")

    phase("phase 15: faults, 8 requests of 30 tokens, 40 greedy tokens, f32 "
          "pool")
    eng0, done = run("no fault layer")
    clean = {u: r.output for u, r in done.items()}
    full = [u for u, o in clean.items() if len(o) == 40]
    if len(full) < 4:
        raise AssertionError(f"too few full-length streams: {full}")
    eng, done = run("empty plan", FaultPlan())
    if {u: r.output for u, r in done.items()} != clean \
            or eng.plan_log != eng0.plan_log or eng.fault_log:
        raise AssertionError("an empty FaultPlan changed streams or plans")
    log("  empty FaultPlan: streams and plan_log bitwise the run without a "
        "fault layer, nothing logged")
    eng, done = run("transient", FaultPlan().step_exception(step=3))
    survivors("transient decode fault at step 3", done, clean, set(), None)
    if eng.metrics["step_retries"] != 1:
        raise AssertionError(f"transient: {eng.metrics['step_retries']} "
                             "retries")
    a, b, c = full[:3]
    eng, done = run("persistent", FaultPlan().step_exception(
        step=4, uid=a, times=10**6))
    survivors(f"persistent decode fault on uid {a}", done, clean, {a},
              ERR_FAULT)
    eng, done = run("nan", FaultPlan().nan_logits(step=40, uid=b))
    survivors(f"NaN in uid {b}'s decode row at step 40", done, clean, {b},
              ERR_NAN)
    req = done[b]
    hashes = eng.pager.prefix_hashes(np.concatenate(
        [req.prompt, np.asarray(req.output, np.int32)]))
    clean_hashes = eng0.pager.prefix_hashes(np.concatenate(
        [req.prompt, np.asarray(clean[b], np.int32)]))
    if not hashes or any(h in eng.pager.index for h in hashes) \
            or not all(h in eng0.pager.index for h in clean_hashes):
        raise AssertionError(f"NaN: uid {b}'s {len(hashes)} full blocks "
                             "were not quarantined out of the prefix index")
    log(f"  NaN: uid {b}'s {len(hashes)} full block(s) are out of the prefix "
        f"index (in the fault-free run they stay cached)")
    eng, done = run("audit", FaultPlan().corrupt_pages(step=10, uid=c),
                    audit_interval=1)
    survivors(f"refcount corruption of uid {c}'s tail block at step 10",
              done, clean, {c}, ERR_AUDIT)
    if eng.metrics["audit_repairs"] < 1:
        raise AssertionError("audit: no repair")
    eng, done = run("latency", FaultPlan()
                    .advance_clock(step=1, ms=10.0, site="decode",
                                   times=10**6)
                    .advance_clock(step=20, ms=200.0, site="decode"))
    survivors("latency faults (10 ms a step, 200 ms at step 20)", done,
              clean, set(), None)
    if eng.metrics["slow_steps"] < 1:
        raise AssertionError("latency: no slow step counted")
    out = {"step_retries": 1, "slow_steps": eng.metrics["slow_steps"]}

    phase("phase 15: a NaN on a verify row, spec_tokens=4, 4 repetitive and "
          "2 random requests")
    rng = np.random.default_rng(15)
    spec_reqs = [np.tile(rng.integers(4, cfg.vocab_size, size=8), 5)
                 .astype(np.int32) for _ in range(4)] + reqs[:2]
    eng0, done = run("speculation, no fault", reqs_=spec_reqs,
                     spec_tokens=4)
    sclean = {u: r.output for u, r in done.items()}
    step, uid = next((i + 1, v[0]) for i, pl in enumerate(eng0.plan_log)
                     for v in pl["verifies"] if i >= 3)
    eng, done = run("speculation, NaN", FaultPlan().nan_logits(
        step=step, uid=uid), reqs_=spec_reqs, spec_tokens=4)
    survivors(f"NaN in uid {uid}'s verify row at step {step}", done, sclean,
              {uid}, ERR_NAN)
    if "verify" not in done[uid].error:
        raise AssertionError(f"the NaN did not hit a verify row: "
                             f"{done[uid].error}")
    out["nan_verify"] = {"step": step, "uid": uid}
    return out



def _plain_entries():
    """Each kernel's entries of ``kernels/ops.py`` and their plain versions
    (``kernels/ref.py``), by the kernel's name."""
    from repro_torch.core.quantization import quantize
    from repro_torch.kernels import ref

    def quantize_plain(x, gs):
        t = quantize(x, group_size=gs, bits=8)
        return t.q, t.scale

    def prefill_plain(q, k_pool, v_pool, page_table, pfx_lens, q_lens,
                      ks_pool=None, vs_pool=None):
        b, c, kvh, hq, d = q.shape
        out, m, l = ref.ref_paged_prefill_attention(
            q.reshape(b, c, kvh * hq, d), k_pool, v_pool, page_table,
            pfx_lens, ks_pool, vs_pool)
        m = m[..., 0].transpose(1, 2).reshape(b, c, kvh, hq)
        l = l[..., 0].transpose(1, 2).reshape(b, c, kvh, hq)
        return out.reshape(b, c, kvh, hq, d), m, l

    def decode_plain(q, k, v, lens, k_scale=None, v_scale=None):
        return ref.ref_decode_attention(q, k, v, lens.reshape(-1, 1),
                                        k_scale, v_scale)

    def flash_plain(q, k, v, q_offset=None, q_lens=None, k_lens=None,
                    causal=True, scale=None):
        return ref.ref_flash_prefill(q, k, v, causal, q_offset, q_lens,
                                     k_lens, scale)

    return {"q8_matvec": {"q8_matvec_kernel": ref.ref_q8_matmul},
            "q8_matmul": {"q8_matmul_kernel": ref.ref_q8_matmul},
            "q4_matvec": {"q4_matvec_kernel": ref.ref_q4_matvec},
            "rmsnorm_quant": {"rmsnorm_quant_kernel": ref.ref_rmsnorm_quant},
            "quantize": {"quantize_kernel": quantize_plain},
            "rope": {"rope": ref.ref_rope, "rope_kernel": ref.ref_rope},
            "paged_decode_attention": {
                "paged_decode_attention_kernel":
                    ref.ref_paged_decode_attention},
            "paged_prefill_attention": {
                "paged_prefill_attention_kernel": prefill_plain},
            "decode_attention": {"decode_attention_kernel": decode_plain},
            "flash_prefill": {"flash_prefill_kernel": flash_plain}}


PLAIN_KERNELS = ("q8_matvec", "q8_matmul", "q4_matvec", "rmsnorm_quant",
                 "quantize", "rope", "paged_decode_attention",
                 "paged_prefill_attention", "decode_attention",
                 "flash_prefill")


@contextlib.contextmanager
def plain_versions(kernels=PLAIN_KERNELS):
    """For the duration, the entries of ``kernels/ops.py`` of each named
    kernel (default: all ten) are their plain versions
    (``kernels/ref.py``): with all of them the same engine serves on the
    card in plain PyTorch, launching no kernel.  A measurement device of
    this script; the port has no such switch (a CUDA tensor reaches its
    kernel or raises)."""
    from repro_torch.kernels import ops
    entries = _plain_entries()
    swap = {}
    for name in kernels:
        swap.update(entries[name])
    saved = {name: getattr(ops, name) for name in swap}
    try:
        for name, fn in swap.items():
            setattr(ops, name, fn)
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


@contextlib.contextmanager
def moe_routes(replay=None):
    """For the duration, every MoE layer's routing (``layers.moe_route``,
    the one place ``moe_mlp`` routes) is recorded, call by call, into the
    list this yields: the chosen experts (B, S, K), the gap between each
    token's k-th and (k+1)-th router logit, and the router logits' largest
    magnitude.  With ``replay`` (a list recorded so), each call takes its
    experts from the same call of ``replay`` instead of choosing them, its
    gates a softmax over its own logits at those experts: pinned routes.
    A measurement device of this script, as ``plain_versions``."""
    from repro_torch.models import layers
    route = layers.moe_route
    calls = []

    def patched(x, router, top_k):
        logits = layers.router_logits(x, router)
        srt = torch.sort(logits, dim=-1, descending=True).values
        if replay is None:
            gates, idx = route(x, router, top_k)
        else:
            idx = replay[len(calls)]["idx"]
            if idx.shape != (*x.shape[:-1], top_k):
                raise AssertionError(f"replayed routes {tuple(idx.shape)} "
                                     f"at a call of {tuple(x.shape)}")
            gates = torch.softmax(torch.gather(logits, -1, idx), dim=-1)
        calls.append({"idx": idx,
                      "gap": srt[..., top_k - 1] - srt[..., top_k],
                      "scale": logits.abs().amax()})
        return gates, idx

    layers.moe_route = patched
    try:
        yield calls
    finally:
        layers.moe_route = route
    if replay is not None and len(calls) != len(replay):
        raise AssertionError(f"{len(calls)} routing calls replayed "
                             f"{len(replay)} recorded ones")


# A routing decision flips where the k-th and the (k+1)-th router logits
# trade places.  The router of layer l (counted from 0) reads the hidden
# state after 2l + 1 of the rounding sites that plain_delta_bound counts
# (two residual adds a layer before it, its own attention's add), and the
# gap is one linear function of that state, as a logit is of the final
# one.  So a flip that rounding alone causes at layer l sits at a plain-run
# gap below plain_delta_bound's form over 2l + 1 sites at the router
# logits' largest magnitude.  A flip whose inputs hold an earlier flip (an
# earlier layer of the same row, at its position or, through the causal
# attention, before it) moves them by a whole expert's share: it is
# counted, not bounded.
def route_flip_bound(scale: float, layer: int) -> float:
    return (PLAIN_DELTA_LAMBDA * math.sqrt(2 * layer + 1) * PLAIN_DELTA_UNIT
            * scale)


def router_layers(cfg) -> list:
    """The layer (counted from 0) of each routing call of one forward pass:
    every layer, or the interleave's MoE layer of each pattern (layer 1, 3,
    ... at ``moe_every`` 2)."""
    me = cfg.moe_every
    return [j * me + me - 1 for j in range(cfg.n_layers // me)]


def route_flips(cfg, want, got, valid, what="free routes"):
    """Flipped routing decisions of one run (``got``) against the plain
    run's (``want``), both recorded by ``moe_routes`` over one chunk step
    (or one-shot prefill) and one decode step, ``valid`` (B, S) the chunk's
    positions within their rows' lengths.  A decision flips where its set
    of experts differs.  A flip is first when no flip precedes it in its
    inputs (an earlier layer of its row, at or before its position); it is
    out of bound where its plain-run gap is not below its layer's
    ``route_flip_bound``.  Returns the counts, the largest gaps, the share
    of the plain run's decisions whose gap sits below their layer's bound
    (the share a rounding could flip: the check's blind share) and
    ``rejected``, true where a first flip is out of bound."""
    layers = router_layers(cfg)
    nl = len(layers)
    scale = max(float(c["scale"]) for c in want)
    tol = torch.tensor([route_flip_bound(scale, layer) for layer in
                        layers], device=valid.device)[:, None, None]
    rec = {"decisions": 0, "flips": 0, "first": 0, "router_scale": scale,
           "bound_layer0": float(tol[0]), "bound_last": float(tol[-1]),
           "under_bound": 0, "under_bound_layer0": 0, "first_max_gap": 0.0,
           "first_max_ratio": 0.0, "later_max_gap": 0.0}
    for part, calls, mask in (("chunk", slice(0, nl), valid),
                              ("decode", slice(nl, 2 * nl), None)):
        w, g = want[calls], got[calls]
        flip = torch.stack([
            (torch.sort(a["idx"], -1).values
             != torch.sort(b["idx"], -1).values).any(-1)
            for a, b in zip(w, g)])                       # (nl, B, S)
        gap = torch.stack([a["gap"] for a in w])
        live = (torch.ones_like(flip) if mask is None
                else mask[None].expand_as(flip))
        flip &= live
        before = torch.cumsum(flip.int(), 0) - flip.int()  # earlier layers
        fed = torch.cummax((before > 0).int(), dim=2).values > 0
        first = flip & ~fed
        rec["decisions"] += int(live.sum())
        rec["under_bound"] += int((live & (gap < tol)).sum())
        rec["under_bound_layer0"] += int((live[0] & (gap[0] < tol[0])).sum())
        rec["flips"] += int(flip.sum())
        rec["first"] += int(first.sum())
        if bool(first.any()):
            rec["first_max_gap"] = max(rec["first_max_gap"],
                                       float(gap[first].max()))
            rec["first_max_ratio"] = max(rec["first_max_ratio"], float(
                (gap / tol)[first].max()))
        if bool((flip & fed).any()):
            rec["later_max_gap"] = max(rec["later_max_gap"],
                                       float(gap[flip & fed].max()))
        rec[part] = {"flips": int(flip.sum()), "first": int(first.sum())}
    rec["under_bound_share"] = rec["under_bound"] / rec["decisions"]
    rec["under_bound_layer0_share"] = (rec["under_bound_layer0"] * nl
                                       / rec["decisions"])
    rec["rejected"] = not rec["first_max_ratio"] < 1.0
    log(f"  routing flips, {what} against the plain run's: "
        f"{rec['flips']} of {rec['decisions']} (layer, token) decisions "
        f"(chunk {rec['chunk']['flips']}, decode {rec['decode']['flips']}); "
        f"{rec['first']} first flips, largest plain gap "
        f"{rec['first_max_gap']:.4g}, {rec['first_max_ratio']:.3g} x its "
        f"layer's fixed bound {PLAIN_DELTA_LAMBDA:g} * sqrt(2 l + 1) * "
        f"{PLAIN_DELTA_UNIT:.5f} * {scale:.4g} ({rec['bound_layer0']:.4g} "
        f"at layer {layers[0]} .. {rec['bound_last']:.4g} at layer "
        f"{layers[-1]}; {100 * rec['under_bound_share']:.1f}% of the plain "
        f"decisions under it, {100 * rec['under_bound_layer0_share']:.1f}% "
        f"of layer {layers[0]}'s); {rec['flips'] - rec['first']} flips fed "
        "by earlier "
        f"ones, largest gap {rec['later_max_gap']:.4g} (counted, not "
        "bounded)")
    return rec


# The fixed bound on the logits of the kernels against the plain versions
# on the same inputs (PERF.md section 6).  Both sides compute the same
# function; they part only where an f32 sum is taken in another order (a
# GEMV's groups, the attentions' online softmax, a norm's mean) and a
# rounding after it flips: a bf16 value by one ulp, or a requantized int8
# activation code by one step.  The unit of one such site is the larger of
# bf16's u = 2^-8 and half a Q8_0 code step, 1/254 of a group's largest
# value (under the kernel strategy every product's input is requantized).
# The CPU tests' form (tests/test_torch_llama3.py) charges each of a
# layer's two residual adds one unit of the logits' scale and adds them:
# 2 * n_layers units, every flip the same way.  Flips are independent and
# of either sign, so they add as a random walk: the probabilistic bound
# lambda * sqrt(N) * unit (Higham and Mary, SIAM J. Sci. Comput. 41(5),
# 2019) with N = 2 * n_layers sites and lambda = 3 (one such sum exceeds
# it with probability at most 2 exp(-lambda^2 / 2) = 0.022).  It bounds the
# final hidden state's relative error, and a logit moves with it, so the
# unit of the logits is the plain logits' largest magnitude: logits within
# 3 * sqrt(2 * n_layers) * max|plain logit| / 254.  It depends on the
# config and on the plain run's logits, never on the measured difference.
PLAIN_DELTA_UNIT = max(2.0 ** -8, 1.0 / 254)
PLAIN_DELTA_LAMBDA = 3.0


def plain_delta_bound(cfg, scale: float, sites_per_layer: float = 2) -> float:
    return (PLAIN_DELTA_LAMBDA * math.sqrt(sites_per_layer * cfg.n_layers)
            * PLAIN_DELTA_UNIT * scale)


# The sites of the SSM families (PERF.md section 6, counted from
# models/ssm.py and the shared block before their first run), as the dense
# bound counts them: one unit for each residual add a layer makes, the
# roundings inside its branch (a dense layer's requantized wqkv / wo_f /
# w13 / w2 inputs) folded into it.  A Mamba2 layer is one branch, x +
# out_proj(gated norm(scan(in-projections(norm(x))))): 1 site, its
# requantized input and gated norm inside it, every value between them f32.
# The hybrid's shared block is a dense layer, 2 sites at each of its
# n_layers // attn_every applications.  mamba2-370m: 48 sites, 1 a layer;
# zamba2-1.2b: 38 + 2 x 6 = 50, 1 + 12 / 38 a layer.  The encoder-decoder
# (counted from models/encdec.py before its first run): a decoder layer's
# three residual adds (self-attention, cross-attention, MLP), and an
# encoder layer's two, which reach the logits through every decoder
# layer's cross K/V: whisper-small 3 x 12 + 2 x 12 = 60 sites, 5 a
# decoder layer.
def delta_sites(cfg) -> float:
    """``plain_delta_bound``'s sites a layer for ``cfg``'s family."""
    if cfg.family == "audio":
        return 3 + 2 * cfg.n_enc_layers / cfg.n_layers
    if cfg.family == "ssm":
        return 1
    if cfg.family == "hybrid":
        return 1 + 2 * (cfg.n_layers // cfg.attn_every) / cfg.n_layers
    return 2


# Dense against paged streams (phase 17): two computations of the same
# function that round differently, each with its own sites, the paged path
# 2 a layer and the dense one 2 + 1/2 (its one-shot prefill keeps P in f32
# where the chunk merge rounds its own keys' P to bf16, at most 2^-9 of
# max |V|: half a unit; tests/test_torch_llama3_dense.py): one random walk
# over both paths' sites.
def dense_paged_bound(cfg, scale: float) -> float:
    return plain_delta_bound(cfg, scale, sites_per_layer=2 + 2 + 0.5)


def _planted_faults():
    """The controls of the fixed bounds (``kernel_plain_delta``'s and
    phase 14's ``_verify_held``): wiring faults that the per-kernel
    checks of phase 2 cannot see (they call each kernel right), each
    wrapping one kernel entry of ``kernels/ops.py``.  By name: (entry, the
    wrapper of the entry, whether the bound must reject it).  A decode
    length one short moves the logits by 0.49-1.15 at 28-32 layers, 3-8x
    rounding's own difference and 0.85-2.3x the bound (PERF.md section 6):
    it is measured, not required; phase 2 holds each kernel's lengths
    exactly and the CPU tests hold the model's wiring against JAX.  The
    verify's prefix one key short is required: phase 14's bound rejects
    it at 12 layers (PERF.md section 6)."""
    def last_group(fn):      # a K loop one Q8_0 group short
        def f(xq, xs, wq, ws, group_size):
            xs = xs.clone()
            xs[:, -1] = 0
            return fn(xq, xs, wq, ws, group_size)
        return f

    def newest_key(at):      # a length one short: the newest key dropped
        def wrap(fn):
            def f(*args):
                args = list(args)
                args[at] = (args[at] - 1).clamp(min=0)
                return fn(*args)
            return f
        return wrap

    def kv_heads(fn):        # GQA groups read the neighbouring KV head
        def f(q, *args):
            return fn(q.roll(1, dims=1).contiguous(), *args)
        return f

    def diagonal(fn):        # the causal diagonal one key short
        def f(q, k, v, q_offset=None, *args):
            off = (torch.zeros(q.shape[0], dtype=torch.int32,
                               device=q.device)
                   if q_offset is None else q_offset)
            return fn(q, k, v, off - 1, *args)
        return f

    return {
        "q8_matvec: last K group dropped": (
            "q8_matvec_kernel", last_group, True),
        "q4_matvec: last K group dropped": (
            "q4_matvec_kernel", last_group, True),
        "paged_decode_attention: newest key dropped": (
            "paged_decode_attention_kernel", newest_key(4), False),
        "paged_decode_attention: KV heads rotated": (
            "paged_decode_attention_kernel", kv_heads, True),
        "decode_attention: newest key dropped": (
            "decode_attention_kernel", newest_key(3), False),
        "decode_attention: KV heads rotated": (
            "decode_attention_kernel", kv_heads, True),
        "flash_prefill: causal diagonal one key short": (
            "flash_prefill_kernel", diagonal, True),
        "q8_matmul: last K group dropped": (
            "q8_matmul_kernel", last_group, True),
        "paged_prefill_attention: prefix one key short": (
            "paged_prefill_attention_kernel", newest_key(4), True)}


@contextlib.contextmanager
def planted(name):
    """For the duration, one planted fault (``_planted_faults``) wraps its
    kernel entry of ``kernels/ops.py``."""
    from repro_torch.kernels import ops
    entry, wrap, _ = _planted_faults()[name]
    saved = getattr(ops, entry)
    setattr(ops, entry, wrap(saved))
    try:
        yield
    finally:
        setattr(ops, entry, saved)


def _clone_tree(t):
    if isinstance(t, dict):
        return {k: _clone_tree(v) for k, v in t.items()}
    if isinstance(t, tuple):
        return tuple(map(_clone_tree, t))
    return t.clone()


def _fresh_cache(model, src, dev):
    """A new cache holding ``src``'s contents: a paged pool (with the
    scratch block the decode step writes dead rows to), or a dense cache,
    every leaf of it (K/V, and an SSM family's conv rings and states, which
    a decode step advances in place)."""
    if "page_table" not in src:
        return _clone_tree(src)
    nb, bs = src["attn"]["k"].shape[1:3]
    b, mb = src["page_table"].shape
    new = model.init_paged_cache(b, block_size=bs, n_blocks=nb,
                                 max_blocks_per_seq=mb, device=dev)
    for name, t in src["attn"].items():
        new["attn"][name].copy_(t)
    new["lens"].copy_(src["lens"])
    new["page_table"] = src["page_table"].clone()
    return new


def every_position_lambda(n: int) -> float:
    """The lambda of ``plain_delta_bound`` for the largest of ``n`` sums
    held at once, with the failure probability one sum has at
    ``PLAIN_DELTA_LAMBDA`` (delta = 2 exp(-lambda^2 / 2) = 0.022): by the
    union bound, sqrt(2 ln(2 n / delta)); 4.93 for 8 x 256 positions."""
    delta = 2 * math.exp(-PLAIN_DELTA_LAMBDA ** 2 / 2)
    return math.sqrt(2 * math.log(2 * n / delta))


def _prefill_every_position(model, params, toks):
    """The one-shot prefill's logits at every position, (B, S, V) f32:
    ``transformer.prefill``'s forward pass with its head over every row."""
    from repro_torch.models import transformer
    dev = params["final_norm"]["gamma"].device
    t = torch.as_tensor(toks, dtype=torch.long, device=dev)
    b, s = t.shape
    pos = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s)
    hidden, _ = transformer.forward_layers(
        params, model.cfg,
        transformer.embed_inputs(params, model.cfg, {"tokens": t}),
        transformer._streams(model.cfg, pos))
    return transformer._head(params, model.cfg, hidden)


def kernel_plain_delta(model, params, prompts, dev, shares=(),
                       dense=False, controls=(), every_position=False):
    """Logits of the kernels against the plain versions on the same inputs:
    one chunk step on an empty pool (each prompt's first 256 tokens, 8
    slots) or, ``dense``, one one-shot prefill of 8 x 256 tokens (a prompt
    shorter than 256 repeated) into an empty dense cache; then one decode
    step on the plain step's cache.  For each kernel of ``shares``, the
    same two differences with only that kernel on its plain version (all
    others launched) and with only that kernel launched (all others
    plain).  For each planted fault of ``controls``
    (``_planted_faults``), the same two differences with every kernel
    launched and that fault planted.  An MoE model's routes are pinned:
    the plain run records each layer's chosen experts and every other run
    replays them, its gates from its own router logits (``moe_routes``),
    so that a routing near-tie flipped by rounding cannot move a token by
    a whole expert's share; one more run with every kernel launched and
    free routes then counts the flipped decisions (``route_flips``), and
    so does one for each planted fault of ``controls``.
    Returns a dict: ``chunk`` and ``decode`` max |diff| with
    every kernel launched, ``scale`` (the plain logits' largest
    magnitude), ``bound`` (``plain_delta_bound``), ``shares``,
    ``controls`` and, for an MoE model, ``routes`` and
    ``route_controls``; raises if any difference but a control's exceeds
    the bound, or if a required control's does not: the check must reject
    those planted faults; for an MoE model also if a first flip of the
    free run is past its layer's bound, or if no first flip of a required
    control's free run is.  ``every_position`` (dense, no MoE): the
    prefill's logits are compared at every position of every row, each
    held to the bound with ``every_position_lambda`` in place of lambda
    (``bound_every_position``); the decode step's keep lambda.  A fault
    that acts on the first positions of a prompt (the causal diagonal one
    key short leaves position 0 no key) shows there, where the last
    position reads it only through the layers above it."""
    b, mb, c = len(prompts), 16, 256
    if dense:
        toks = np.stack([np.resize(p, c) for p in prompts]).astype(np.int32)
        valid = torch.ones((b, c), dtype=torch.bool, device=dev)
    else:
        toks = np.zeros((b, c), np.int32)
        lens = [min(len(p), c) for p in prompts]
        for i, p in enumerate(prompts):
            toks[i, :lens[i]] = p[:lens[i]]
        valid = (torch.arange(c, device=dev)[None]
                 < torch.tensor(lens, device=dev)[:, None])
        empty = model.init_paged_cache(b, block_size=64, n_blocks=b * mb,
                                       max_blocks_per_seq=mb, device=dev)
        empty["page_table"] = torch.arange(b * mb, dtype=torch.int32,
                                           device=dev).reshape(b, mb)

    def first():
        if dense:
            return model.prefill(params, {"tokens": toks}, max_seq=1024)
        return model.prefill_chunk_batch(params, toks,
                                         _fresh_cache(model, empty, dev),
                                         list(range(b)), [0] * b,
                                         chunk_lens=lens)

    moe = model.cfg.family == "moe"
    if every_position and not (dense and model.cfg.family != "moe"):
        raise ValueError("every_position: the dense prefill of a model "
                         "without MoE routes")
    with plain_versions(), moe_routes() as plain_routes:
        want, pcache = first()
        nxt = torch.argmax(want, dim=-1)
        dwant, _ = model.decode_step(params, _fresh_cache(model, pcache, dev),
                                     nxt)
        want_all = (_prefill_every_position(model, params, toks)
                    if every_position else want)

    def run(plain, pinned=True):
        with plain_versions(plain), moe_routes(
                plain_routes if pinned else None) as routes:
            got = (_prefill_every_position(model, params, toks)
                   if every_position else first()[0])
            dgot, _ = model.decode_step(params,
                                        _fresh_cache(model, pcache, dev),
                                        nxt)
        torch.cuda.synchronize()
        diff = ((got - want_all).abs().max().item(),
                (dgot - dwant).abs().max().item())
        return diff if pinned else (diff, routes)

    scale = max(want.abs().max().item(), dwant.abs().max().item())
    sites = delta_sites(model.cfg)
    tol = plain_delta_bound(model.cfg, scale, sites)
    # the prefill's bound: at every position with the union bound's lambda,
    # at the scale of every position's plain logits
    tol_first = tol
    if every_position:
        tol_first = (plain_delta_bound(model.cfg, want_all.abs().max().item(),
                                       sites)
                     * every_position_lambda(want_all.numel()
                                             // want_all.shape[-1])
                     / PLAIN_DELTA_LAMBDA)

    def ratio(d):
        """How far a (prefill, decode) difference is past its bounds."""
        return max(d[0] / tol_first, d[1] / tol)
    d_chunk, d_dec = run(())
    rec = {"chunk": d_chunk, "decode": d_dec, "scale": scale, "bound": tol,
           "shares": {}, "controls": {}}
    if every_position:
        rec.update(bound_every_position=tol_first,
                   scale_every_position=want_all.abs().max().item())
    for name in shares:
        rec["shares"][name] = {
            "plain_alone": run((name,)),
            "launched_alone": run(tuple(k for k in PLAIN_KERNELS
                                        if k != name))}
        log(f"    {name}: " + "; ".join(
            f"{how.replace('_', ' ')} chunk {d[0]:.4g}, decode {d[1]:.4g}"
            for how, d in rec["shares"][name].items()))
    worst = max([ratio((d_chunk, d_dec))]
                + [ratio(pair) for r in rec["shares"].values()
                   for pair in r.values()])
    pin = " (routes pinned to the plain run's)" if moe else ""
    n_rows = want_all.numel() // want_all.shape[-1]
    first_bound = (f"; the prefill's at every position, lambda "
                   f"{every_position_lambda(n_rows):.3g} and scale "
                   f"{want_all.abs().max().item():.4g}: {tol_first:.4g}"
                   if every_position else "")
    log(f"  kernels vs plain versions on the same inputs{pin}: "
        f"{'prefill' if dense else 'chunk step'} logits max |diff| "
        f"{d_chunk:.4g}{' (every position)' * every_position}, decode step "
        f"{d_dec:.4g}; plain logits' scale {scale:.4g}; fixed bound "
        f"{PLAIN_DELTA_LAMBDA:g} * sqrt({sites * model.cfg.n_layers:g} "
        f"sites) * {PLAIN_DELTA_UNIT:.5f} * scale = {tol:.4g}{first_bound}; "
        f"worst of {1 + 2 * len(shares)} runs {worst:.3g} x its bound")
    if not worst <= 1:
        raise AssertionError(f"{model.cfg.arch_id}: kernels vs plain logits "
                             f"differ by {worst} x the fixed bound {tol} "
                             f"(prefill {tol_first}): {rec}")
    faults = _planted_faults()
    for name in controls:
        with planted(name):
            rec["controls"][name] = hit = run(())
        log(f"    control, {name}: chunk {hit[0]:.4g}, decode {hit[1]:.4g} "
            f"({ratio(hit):.2f} x the bound"
            f"{'' if faults[name][2] else '; measured, not required'})")
    missed = [n for n, hit in rec["controls"].items()
              if faults[n][2] and not ratio(hit) > 1]
    if missed:
        raise AssertionError(f"{model.cfg.arch_id}: the fixed bound {tol} "
                             f"does not reject the planted faults {missed}: "
                             f"{rec['controls']}")
    if moe:
        (d_free, d_free_dec), free = run((), pinned=False)
        rec["routes"] = route_flips(model.cfg, plain_routes, free, valid)
        rec["routes"].update(chunk_free=d_free, decode_free=d_free_dec)
        log(f"  free routes: logits max |diff| chunk {d_free:.4g}, decode "
            f"{d_free_dec:.4g} (measured, not bounded)")
        if rec["routes"]["rejected"]:
            raise AssertionError(f"{model.cfg.arch_id}: a first routing flip "
                                 "at a plain gap past its layer's fixed "
                                 f"bound: {rec['routes']}")
        # the same planted faults with free routes: the controls of the
        # flip bound
        rec["route_controls"] = {}
        for name in controls:
            with planted(name):
                _, hit = run((), pinned=False)
            rec["route_controls"][name] = route_flips(
                model.cfg, plain_routes, hit, valid,
                what=f"control, {name},"
                + ("" if faults[name][2] else " (measured, not required)"))
        missed = [n for n, r in rec["route_controls"].items()
                  if faults[n][2] and not r["rejected"]]
        if missed:
            raise AssertionError(f"{model.cfg.arch_id}: the flip bound "
                                 f"rejects no first flip of the planted "
                                 f"faults {missed}")
    return rec


# the kernels of each llama3.2-3b path (phases 16-18), for the per-kernel
# shares of kernel_plain_delta
L3_PAGED_KERNELS = ("q8_matvec", "q8_matmul", "rmsnorm_quant", "quantize",
                    "rope", "paged_decode_attention",
                    "paged_prefill_attention")
# the planted faults each path's check must reject (kernel_plain_delta's
# controls): phases 16 (bf16 pool) and 18, phase 17's dense bf16 run
# the six kernels of the MoE paged path (phase 21): no MLP product runs
# on a kernel, so no q8_matmul
MOE_PAGED_KERNELS = ("q8_matvec", "rmsnorm_quant", "quantize", "rope",
                     "paged_decode_attention", "paged_prefill_attention")
PAGED_CONTROLS = ("q8_matvec: last K group dropped",
                  "paged_decode_attention: newest key dropped",
                  "paged_decode_attention: KV heads rotated")
DENSE_CONTROLS = ("decode_attention: newest key dropped",
                  "decode_attention: KV heads rotated",
                  "flash_prefill: causal diagonal one key short")
Q4_POLICY = dict(bits=4, min_size=512)        # launch/serve.py --bits 4


# phases 16-17's depth: llama3.2-3b's 28 layers cut to 14, the script's
# largest host-bound phases (~6 s a layer with both pools' plain-version
# engine runs and phase 17's four runs), to keep the whole script well
# inside its time limit; its kernels at its shapes stay in phase 2, and
# phase 27 trains it at all 28 layers
L3_PHASE_LAYERS = 14


def llama3_params(dev):
    """llama3.2-3b's parameters, cut to ``L3_PHASE_LAYERS`` layers, from
    the port's own seeded ``init_params`` on the card, drawn once: Q8_0
    (phases 16-17) and Q4_0 (``serve.py --bits 4``'s policy, phase 17)
    from the same f32 draw, which is then freed.  Returns (config, Q8_0,
    Q4_0, prompts, seconds)."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.core.quantization import tree_differs
    from repro_torch.models.model import build_model
    cfg = get_config(L3).with_(n_layers=L3_PHASE_LAYERS)
    model = build_model(cfg)
    t0 = time.perf_counter()
    init = model.init(seed=0, device=dev)
    params = model.quantize(init)
    p4 = model.quantize(init, QuantPolicy(**Q4_POLICY))
    torch.cuda.synchronize()
    made = time.perf_counter() - t0
    del init
    torch.cuda.empty_cache()
    for tag, want, policy in (("Q8_0", params, None),
                              ("Q4_0", p4, QuantPolicy(**Q4_POLICY))):
        differ = tree_differs(model.init_quantized(0, policy, device=dev),
                              want)
        if differ:
            raise AssertionError(f"{L3}: init_quantized {tag} differs from "
                                 f"quantize(init) at {differ}")
    torch.cuda.empty_cache()
    log(f"  {L3}: Model.init_quantized(0) bitwise equal to "
        "Model.quantize(Model.init(0)), Q8_0 and Q4_0, every leaf and the "
        "fused operands")
    prompts = _requests(8, 16, 600, cfg.vocab_size, seed=16, shared_len=128,
                        shared_at=(0, 5))
    return cfg, params, p4, prompts, made


def _suffixed(counted, mine, arch):
    for k, v in mine.items():
        counted[f"{k}@{arch}"] = counted.get(f"{k}@{arch}", 0) + v


def llama3_path(dev, cfg, params, prompts, made, counted):
    """Phase 16: llama3.2-3b at full width (``L3_PHASE_LAYERS`` layers,
    d_model 3072, 24 query heads over 8 KV heads of 128, d_ff 8192, vocab
    128256, bf16 compute), Q8_0 with the fused decode weights
    (``llama3_params``);
    the paged Engine (page 64, chunk 256, 8 slots, max_seq 1024) on a bf16
    pool, then an int8 pool; 8 requests of 16..600 tokens, two sharing a
    128-token prefix, 32 greedy tokens.  Per pool: the kernels' logits
    against the plain versions' on the same inputs (``kernel_plain_delta``,
    held to the fixed bound ``plain_delta_bound``; on the bf16 pool each
    kernel's share too) first, then the kernel run with its exact launch
    counts, then the same engine on the plain versions
    (``plain_versions``: no launch); the streams must be equal or part
    only at a step whose top-2 gap (plain) is below the fixed bound.
    Last, the bf16 pool's run is repeated under the profiler for the
    card's busy share and the heaviest kernels.  Launches are counted
    under ``<kernel>@llama3.2-3b``.  Returns (record, each pool's
    streams)."""
    from repro_torch.kernels import build
    from repro_torch.models.model import build_model
    phase(f"phase 16: {L3} full width, {cfg.n_layers} layers (cut) ("
          f"d_model {cfg.d_model}, {cfg.n_heads} / {cfg.n_kv_heads} heads of "
          f"{cfg.hd()}, vocab {cfg.vocab_size}, {cfg.compute_dtype}), "
          f"Q8_0 parameters {param_bytes(params) / 1e9:.2f} GB made on the "
          f"card in {made:.1f} s (with the Q4_0 copy); 8 requests of "
          f"{min(map(len, prompts))}..{max(map(len, prompts))} tokens, 32 "
          "greedy tokens")
    mine, out, runs = {}, {}, {}
    for kv in ("bfloat16", "int8"):
        model = build_model(cfg.with_(kv_cache_dtype=kv))
        log(f"  {kv} pool:")
        bf16 = kv == "bfloat16"
        delta = kernel_plain_delta(
            model, params, prompts, dev,
            shares=L3_PAGED_KERNELS if bf16 else (),
            controls=PAGED_CONTROLS if bf16 else ())
        build.reset_launches()
        eng, streams, wall = serve(model, params, prompts, dev, 32,
                                   **PAGED_KW)
        check_launches(eng, dict(build.LAUNCHES), cfg, mine)
        if eng.metrics["prefix_hits"] < 1:
            raise AssertionError(f"{L3}: the shared-prefix requests never "
                                 "hit the prefix cache")
        rec = engine_line(f"{L3}, {kv} pool, kernel strategy", eng,
                          streams, wall)
        rec["kernel_plain_delta"] = delta
        with plain_versions():
            build.reset_launches()
            _, plain, pwall = serve(model, params, prompts, dev, 32,
                                    **PAGED_KW)
            if any(build.LAUNCHES.values()):
                raise AssertionError(f"the plain run launched kernels: "
                                     f"{build.LAUNCHES}")
            log(f"  {L3}, {kv} pool, plain versions: {pwall:.3f} s, no "
                "kernel launched")
            compare_streams(f"{L3} {kv} pool, kernels vs plain", streams,
                            plain, prompts,
                            lambda seq, *_: _top2_gap(model, params, seq,
                                                      dev), delta["bound"])
        rec["plain_wall_s"] = pwall
        rec["streams_equal"] = sum(a == b for a, b in zip(streams, plain))
        out[kv] = rec
        runs[kv] = model, streams
    # the profiled run last, so that no pool's timed run follows it
    model, streams = runs["bfloat16"]
    again, out["bfloat16"]["device_busy_share"] = profiled(
        lambda: serve(model, params, prompts, dev, 32, **PAGED_KW)[1])
    if again != streams:
        raise AssertionError(f"{L3}: a second run gave different greedy "
                             "streams")
    log("  bf16 pool, second run (profiled): identical streams")
    _suffixed(counted, mine, L3)
    return out, {kv: s for kv, (_, s) in runs.items()}


def llama3_dense_q4(dev, cfg, params, p4, prompts, paged, counted,
                    plain_requests=4):
    """Phase 17: llama3.2-3b at full width (``L3_PHASE_LAYERS`` layers) on
    the dense cache (8 slots x 1024: one-shot prefill on
    ``flash_prefill``, decode on ``decode_attention``) and with Q4_0
    weights (``q4_matvec`` the only
    product kernel), from phase 16's draw (``llama3_params``): dense with
    Q8_0 on a bf16 and then an int8 cache, then Q4_0 on the paged bf16
    pool and on the dense bf16 cache; phase 16's 8 requests, 32 greedy
    tokens.  Each run: ``kernel_plain_delta`` on its own path (the one-shot
    prefill for the dense cache), with the shares of the kernels the path
    adds, held to the fixed bound; its exact launch counts.  The dense bf16
    and the Q4_0 paged runs are held against the same engine on the plain
    versions (the first ``plain_requests`` requests: 4 of the 8 keep the
    whole script near 600 s of command time), parting only at a
    top-2 gap below the fixed bound; the dense streams against phase 16's
    paged ones (``paged``, by pool) and Q4_0 dense against Q4_0 paged,
    parting only at a top-2 gap below ``dense_paged_bound``.  Launches are
    counted under ``<kernel>@llama3.2-3b``."""
    from repro_torch.kernels import build
    from repro_torch.models.model import build_model
    runs = (("dense bf16", "bfloat16", 8, DENSE_KW, True),
            ("dense int8", "int8", 8, DENSE_KW, False),
            ("Q4_0 paged bf16", "bfloat16", 4, PAGED_KW, True),
            ("Q4_0 dense bf16", "bfloat16", 4, DENSE_KW, False))
    phase(f"phase 17: {L3} full width, {cfg.n_layers} layers (cut), dense "
          "cache 8 x 1024 and "
          f"Q4_0 weights ({param_bytes(p4) / 1e9:.2f} GB against "
          f"{param_bytes(params) / 1e9:.2f} GB for Q8_0), 8 greedy requests "
          "a run")
    mine, out, streams = {}, {}, {}
    for tag, kv, bits, kw, with_plain in runs:
        model = build_model(cfg.with_(kv_cache_dtype=kv))
        prm = p4 if bits == 4 else params
        dense = kw is DENSE_KW
        shares = ("q4_matvec",) if bits == 4 else ()
        controls = ()
        if dense and bits == 8:
            shares = ("flash_prefill", "decode_attention")
            controls = DENSE_CONTROLS if kv == "bfloat16" else ()
        elif bits == 4 and not dense:
            controls = ("q4_matvec: last K group dropped",)
        phase(f"phase 17: {L3}, {tag}")
        delta = kernel_plain_delta(model, prm, prompts, dev, shares,
                                   dense=dense, controls=controls)
        build.reset_launches()
        eng, got, wall = serve(model, prm, prompts, dev, 32, **kw)
        check_launches(eng, dict(build.LAUNCHES), cfg, mine, bits=bits)
        rec = engine_line(f"{L3}, {tag}, kernel strategy", eng, got, wall)
        rec["kernel_plain_delta"] = delta

        def gap(seq, *_):
            return _top2_gap(model, prm, seq, dev)
        if with_plain:
            n = plain_requests
            with plain_versions():
                build.reset_launches()
                _, plain, pwall = serve(model, prm, prompts[:n], dev, 32,
                                        **kw)
                if any(build.LAUNCHES.values()):
                    raise AssertionError(f"the plain run launched kernels: "
                                         f"{build.LAUNCHES}")
                log(f"  {L3}, {tag}, plain versions ({n} requests): "
                    f"{pwall:.3f} s, no kernel launched")
                compare_streams(f"{L3} {tag}, kernels vs plain", got[:n],
                                plain, prompts, gap, delta["bound"])
            rec["plain_wall_s"] = pwall
            rec["streams_equal"] = sum(a == b for a, b in zip(got, plain))
        if dense:
            rec["dense_paged_bound"] = tol = dense_paged_bound(
                cfg, delta["scale"])
            want = paged[kv] if bits == 8 else streams["Q4_0 paged bf16"]
            compare_streams(f"{L3} {tag} vs {'Q4_0 ' * (bits == 4)}paged "
                            f"(bound {tol:.4g})", got, want, prompts, gap,
                            tol)
        streams[tag] = got
        out[tag] = rec
    _suffixed(counted, mine, L3)
    return out


def f32_init_bytes(cfg) -> int:
    """Bytes of ``init_params``'s tree at ``cfg`` in f32: what a draw in
    full before quantizing would hold (counted on the meta device)."""
    from repro_torch.models.transformer import init_bytes
    return init_bytes(cfg.with_(param_dtype="float32"))


def moe_init_bitwise(dev, cfg, n_layers=2, **cut):
    """``Model.init_quantized`` against ``Model.quantize(Model.init(0))``
    at ``cfg``'s full width cut to ``n_layers`` and ``cut``'s other fields
    (qwen3-moe-30b-a3b: ~6 GB of f32 at 2 layers, its banks drawn a layer
    at a time in both; llama4-maverick-400b-a17b's one pattern would hold
    a 21.5 GB bank and quantize it whole, so it is also cut to 8 experts):
    every code and scale equal, the router f32 in both.  Raises
    otherwise."""
    from repro_torch.core.quantization import tree_differs
    from repro_torch.models.model import build_model
    model = build_model(cfg.with_(n_layers=n_layers, **cut))
    want = model.quantize(model.init(seed=0, device=dev))
    got = model.init_quantized(seed=0, device=dev)
    differ = tree_differs(got, want)
    router = got["blocks_moe" if "blocks_moe" in got else "blocks"]["moe"][
        "router"]
    del got, want
    torch.cuda.empty_cache()
    what = ", ".join([f"{n_layers} layers"]
                     + [f"{k} {v}" for k, v in cut.items()])
    if differ or router.dtype != torch.float32:
        raise AssertionError(f"{cfg.arch_id} at {what}: init_quantized "
                             f"differs from quantize(init) at {differ}, "
                             f"router {router.dtype}")
    log(f"  {cfg.arch_id} at {what} of full width: "
        "Model.init_quantized(0) bitwise equal to "
        "Model.quantize(Model.init(0)), every leaf, the router f32")


def _vlm_positions(b, n_text, grid, dev):
    """Qwen2-VL's three position streams (3, B, S) for ``n_text`` text
    tokens, a ``grid`` x ``grid`` image of patches and ``n_text`` more text
    tokens: text at t = h = w = its index; the image's patches at temporal
    ``n_text``, height ``n_text + row``, width ``n_text + column``; the
    text after it from ``n_text + grid`` on."""
    head = torch.arange(n_text, device=dev)
    r, c = torch.meshgrid(torch.arange(grid, device=dev),
                          torch.arange(grid, device=dev), indexing="ij")
    img = torch.stack([torch.full((grid * grid,), n_text, device=dev),
                       n_text + r.reshape(-1), n_text + c.reshape(-1)])
    tail = n_text + grid + torch.arange(n_text, device=dev)
    pos = torch.cat([head.expand(3, -1), img, tail.expand(3, -1)], dim=1)
    return pos[:, None].expand(3, b, pos.shape[1]).to(torch.int32)


def vlm_prefill(model, params, dev, mine):
    """The M-RoPE case text tokens never reach: one model-level
    ``Model.prefill`` of 2 rows of stub patch embeddings (a seeded normal
    draw at the embedding table's 0.02) over three distinct position
    streams (``_vlm_positions``: 24 text tokens, a 16 x 16 patch grid, 24
    text tokens; 304 positions), on the kernels against the same call on
    the plain versions: last-position logits within ``plain_delta_bound``.
    Launches asserted exactly (a dense prefill: ``flash_prefill`` a layer,
    the MLP's two products a layer at M 608, the head's GEMV, norm2's and
    the final norm's ``rmsnorm_quant``, w2's ``quantize``) and added to
    ``mine``.  The same embeddings at text positions (three equal streams)
    must part from the plain logits by more than the bound: the check sees
    the streams.  Returns the record."""
    from repro_torch.kernels import build
    cfg = model.cfg
    gen = torch.Generator(device=dev).manual_seed(24)
    b, n_text, grid = 2, 24, 16
    pos = _vlm_positions(b, n_text, grid, dev)
    s = pos.shape[-1]
    emb = torch.randn((b, s, cfg.d_model), generator=gen, device=dev) * 0.02
    batch = {"embeds": emb, "positions": pos}
    with plain_versions():
        want, _ = model.prefill(params, batch)
    build.reset_launches()
    got, _ = model.prefill(params, batch)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    text, _ = model.prefill(params, {"embeds": emb})
    torch.cuda.synchronize()
    nl = cfg.n_layers
    expect = dict.fromkeys(launches, 0)
    expect.update(flash_prefill=nl, q8_matmul=2 * nl, q8_matvec=1,
                  rmsnorm_quant=nl + 1, quantize=nl)
    if launches != expect:
        raise AssertionError(f"{cfg.arch_id} prefill on embeds: launches "
                             f"{launches} != expected {expect}")
    for k, v in launches.items():
        mine[k] = mine.get(k, 0) + v
    scale = want.abs().max().item()
    tol = plain_delta_bound(cfg, scale)
    diff = (got - want).abs().max().item()
    moved = (text - want).abs().max().item()
    rec = {"rows": b, "positions": s, "logits_diff": diff, "scale": scale,
           "bound": tol, "text_positions_diff": moved,
           "finite": bool(torch.isfinite(got).all())}
    log(f"  {cfg.arch_id} Model.prefill on stub embeds (B {b}, S {s}: "
        f"{n_text} text, a {grid} x {grid} patch grid, {n_text} text) at "
        f"three distinct position streams: kernels vs plain versions, "
        f"last-position logits max |diff| {diff:.4g}, bound {tol:.4g} "
        f"({diff / tol:.3g} x); launches "
        f"{dict((k, v) for k, v in launches.items() if v)}; "
        f"the same embeds at text positions part by {moved:.4g} "
        f"({moved / tol:.3g} x the bound)")
    if not (rec["finite"] and diff <= tol and moved > tol):
        raise AssertionError(f"{cfg.arch_id} prefill on embeds: {rec}")
    return rec


def full_width_path(dev, counted, arch, n, n_layers=None):
    """Phase ``n``: ``arch`` (phi4-mini-3.8b, phase 18; glm4-9b, phase 19;
    command-r-35b, phase 20; qwen3-moe-30b-a3b, phase 21; qwen2-vl-7b,
    phase 24, on text tokens, then ``vlm_prefill``) at full width,
    and full depth unless ``n_layers`` cuts it, from the port's own seeded
    init quantized as it draws (``Model.init_quantized``: Q8_0 with the
    fused decode operands, bitwise ``quantize(init)``, the f32 tree never
    held; for the MoE config first held bitwise at 2 layers,
    ``moe_init_bitwise``), the paged Engine on a bf16 pool as phase 16; 8
    requests of 16..600 tokens, two sharing a 128-token prefix, 32 greedy
    tokens.  ``kernel_plain_delta`` with every kernel's share (each kernel
    plain alone and launched alone; the MoE config's routes pinned, then
    its flips counted), held to the fixed bound at the config's depth (and
    its planted faults rejected), stands in for the plain-version engine
    run and the int8 pool.  Asserts the exact launch counts, a
    prefix-cache hit and no token past the head's rows; for the MoE config
    a short run (two requests, 8 tokens) under the profiler gives the
    card's busy share and the heaviest device operations.  Launches are
    counted under ``<kernel>@<arch>`` and listed in the record, with the
    init's seconds, the f32 GB never held, the Q8_0 GB, the peak GB
    allocated by the init and over the phase, and a digest of the streams;
    the parameters are freed before it returns."""
    import hashlib
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models.model import build_model
    cfg = get_config(arch)
    if n_layers:
        cfg = cfg.with_(n_layers=n_layers)
    moe = cfg.family == "moe"
    if moe:
        moe_init_bitwise(dev, cfg)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init_quantized(seed=0, device=dev)
    torch.cuda.synchronize()
    made = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    held = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    f32_gb = f32_init_bytes(cfg) / 1e9
    prompts = _requests(8, 16, 600, cfg.vocab_size, seed=n, shared_len=128,
                        shared_at=(0, 5))
    mlp = (f"{cfg.n_experts} experts of d_ff {cfg.d_ff}, top {cfg.top_k}"
           if moe else f"d_ff {cfg.d_ff}")
    phase(f"phase {n}: {arch} full width, {cfg.n_layers} layers"
          f"{' (cut)' if n_layers else ''} (d_model {cfg.d_model}, "
          f"{cfg.n_heads} / {cfg.n_kv_heads} heads of "
          f"{cfg.hd()}, {mlp}, vocab {cfg.vocab_size} (head "
          f"{cfg.padded_vocab()} rows), rope theta {cfg.rope_theta:g}, "
          f"{cfg.compute_dtype}), Q8_0 parameters "
          f"{param_bytes(params) / 1e9:.2f} GB ({held:.2f} GB allocated) "
          f"quantized as drawn on the card in {made:.1f} s, their "
          f"{f32_gb:.2f} GB of f32 never held (peak {peak:.2f} GB "
          f"allocated); 8 requests of {min(map(len, prompts))}.."
          f"{max(map(len, prompts))} tokens, 32 greedy tokens, paged bf16 "
          "pool")
    delta = kernel_plain_delta(
        model, params, prompts, dev,
        shares=MOE_PAGED_KERNELS if moe else L3_PAGED_KERNELS,
        controls=PAGED_CONTROLS)
    mine = {}
    build.reset_launches()
    eng, streams, wall = serve(model, params, prompts, dev, 32, **PAGED_KW)
    check_launches(eng, dict(build.LAUNCHES), cfg, mine)
    if eng.metrics["prefix_hits"] < 1:
        raise AssertionError(f"{arch}: the shared-prefix requests never hit "
                             "the prefix cache")
    if any(t >= cfg.padded_vocab() for s in streams for t in s):
        raise AssertionError(f"{arch}: a token past the head's rows")
    rec = engine_line(f"{arch}, bf16 pool, kernel strategy", eng, streams,
                      wall)
    if cfg.family == "vlm":
        rec["mrope_prefill"] = vlm_prefill(model, params, dev, mine)
    if moe:
        # the MoE step's time is the plain experts' glue, which phase 2's
        # kernel times do not show: a profile splits it.  Two requests and
        # 8 tokens: profiling the whole run (~180000 device operations)
        # made the phase ~150 s longer, past the script's time
        _, rec["device_busy_share"] = profiled(
            lambda: serve(model, params, prompts[:2], dev, 8, **PAGED_KW))
    rec.update(kernel_plain_delta=delta, launches=mine, n_layers=cfg.n_layers,
               init_s=made, f32_gb_never_held=f32_gb,
               q8_gb=param_bytes(params) / 1e9, allocated_gb=held,
               init_peak_gb=peak,
               run_peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               streams_sha1=hashlib.sha1(
                   json.dumps(streams).encode()).hexdigest()[:12])
    _suffixed(counted, mine, arch)
    del params
    torch.cuda.empty_cache()
    return rec


def ssm_init_bitwise(dev, cfg, n_layers):
    """``Model.init_quantized`` against ``Model.quantize(Model.init(0))``
    at ``cfg``'s full width cut to ``n_layers``: every code and scale
    equal; ``wdt``, the convolutions and the SSM dynamics f32 and
    unquantized in both.  Raises otherwise."""
    from repro_torch.core.quantization import QuantizedTensor, tree_differs
    from repro_torch.models.model import build_model
    model = build_model(cfg.with_(n_layers=n_layers))
    want = model.quantize(model.init(seed=0, device=dev))
    got = model.init_quantized(seed=0, device=dev)
    differ = tree_differs(got, want)
    ssm = got["blocks" if cfg.family == "ssm" else "blocks_main"]["ssm"]
    floats = [k for k in ("wdt", "conv_x", "A_log", "dt_bias", "D_skip")
              if isinstance(ssm[k], QuantizedTensor)
              or ssm[k].dtype != torch.float32]
    del got, want
    torch.cuda.empty_cache()
    if differ or floats:
        raise AssertionError(f"{cfg.arch_id} at {n_layers} layers: "
                             f"init_quantized differs from quantize(init) "
                             f"at {differ}; not f32: {floats}")
    log(f"  {cfg.arch_id} at {n_layers} layers of full width: "
        "Model.init_quantized(0) bitwise equal to "
        "Model.quantize(Model.init(0)), every leaf, the SSM dynamics f32")


# the kernels of each SSM family's path (phases 22-23), for the shares of
# kernel_plain_delta, and the planted faults its bound must reject
SSM_KERNELS = ("q8_matvec", "q8_matmul", "rmsnorm_quant", "quantize")
HYBRID_KERNELS = SSM_KERNELS + ("rope", "decode_attention", "flash_prefill")
SSM_CONTROLS = ("q8_matvec: last K group dropped",
                "q8_matmul: last K group dropped")
HYBRID_CONTROLS = SSM_CONTROLS + DENSE_CONTROLS
# the engine as a user builds it: the default cache_kind, which an SSM
# family's model turns into the dense per-slot cache
SSM_KW = dict(max_slots=8, max_seq=1024)


def ssm_path(dev, counted, arch, n):
    """Phase ``n``: ``arch`` (mamba2-370m, phase 22; zamba2-1.2b, phase 23)
    at full width and depth, from the port's own seeded init quantized as
    it draws (``Model.init_quantized``, first held bitwise against
    ``quantize(init)`` at a cut depth, ``ssm_init_bitwise``: 2 layers, or
    for the hybrid 7, one super block and a tail layer), served by
    ``Engine(model, params)`` with the default ``cache_kind``, which must
    fall back to the dense per-slot cache (8 slots x 1024); phases 18-21's
    8 requests of 16..600 tokens, 32 greedy tokens (two share a 128-token
    prefix, which the dense cache never reuses: no prefix hit).
    ``kernel_plain_delta`` on the one-shot prefill and a decode step, every
    kernel's share, held to the fixed bound at the config's depth and
    ``delta_sites`` (its planted faults rejected).  Asserts the exact
    launch counts (``_ssm_launches``), no token past the head's rows, and
    a short run (two requests, 8 tokens) under the profiler for the card's
    busy share.  Launches are counted under ``<kernel>@<arch>``; the record
    carries the init's numbers and a digest of the streams.  The
    parameters are freed before it returns."""
    import hashlib
    from repro_torch.configs import get_config
    from repro_torch.core.quantization import QuantizedTensor
    from repro_torch.kernels import build
    from repro_torch.models.model import build_model
    cfg = get_config(arch)
    hybrid = cfg.family == "hybrid"
    ssm_init_bitwise(dev, cfg, cfg.attn_every + 1 if hybrid else 2)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init_quantized(seed=0, device=dev)
    torch.cuda.synchronize()
    made = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    held = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    # _ssm_launches counts five products a Mamba2 layer
    float_proj = [(stack, k) for stack in ("blocks", "blocks_main",
                                           "blocks_tail") if stack in params
                  for k in ("wz", "wx", "wB", "wC", "out_proj")
                  if not isinstance(params[stack]["ssm"][k], QuantizedTensor)]
    if float_proj:
        raise AssertionError(f"{arch}: projections left float {float_proj}")
    f32_gb = f32_init_bytes(cfg) / 1e9
    prompts = _requests(8, 16, 600, cfg.vocab_size, seed=n, shared_len=128,
                        shared_at=(0, 5))
    attn = (f"; one shared attention + SwiGLU block ({cfg.n_heads} / "
            f"{cfg.n_kv_heads} heads of {cfg.hd()}, d_ff {cfg.d_ff}, rope "
            f"theta {cfg.rope_theta:g}) after every {cfg.attn_every}"
            if hybrid else "")
    phase(f"phase {n}: {arch} full width and depth, {cfg.n_layers} Mamba2 "
          f"layers (d_model {cfg.d_model}, state {cfg.ssm_state}, heads of "
          f"{cfg.ssm_head_dim}){attn}, vocab {cfg.vocab_size} (head "
          f"{cfg.padded_vocab()} rows), {cfg.compute_dtype}; Q8_0 "
          f"parameters {param_bytes(params) / 1e9:.2f} GB ({held:.2f} GB "
          f"allocated) quantized as drawn on the card in {made:.1f} s, "
          f"their {f32_gb:.2f} GB of f32 never held (peak {peak:.2f} GB); "
          f"8 requests of {min(map(len, prompts))}..{max(map(len, prompts))}"
          " tokens, 32 greedy tokens, the default cache_kind")
    delta = kernel_plain_delta(
        model, params, prompts, dev,
        shares=HYBRID_KERNELS if hybrid else SSM_KERNELS, dense=True,
        controls=HYBRID_CONTROLS if hybrid else SSM_CONTROLS,
        every_position=True)
    mine = {}
    build.reset_launches()
    eng, streams, wall = serve(model, params, prompts, dev, 32, **SSM_KW)
    if eng.paged or "page_table" in eng.cache:
        raise AssertionError(f"{arch}: the engine did not fall back to the "
                             "dense cache")
    check_launches(eng, dict(build.LAUNCHES), cfg, mine)
    if eng.metrics["prefix_hits"]:
        raise AssertionError(f"{arch}: a prefix hit on the dense cache")
    if any(t >= cfg.padded_vocab() for s in streams for t in s):
        raise AssertionError(f"{arch}: a token past the head's rows")
    rec = engine_line(f"{arch}, dense fallback ({'bf16 KV, ' * hybrid}"
                      "kernel strategy)", eng, streams, wall)
    _, rec["device_busy_share"] = profiled(
        lambda: serve(model, params, prompts[:2], dev, 8, **SSM_KW))
    rec.update(kernel_plain_delta=delta, launches=mine, n_layers=cfg.n_layers,
               init_s=made, f32_gb_never_held=f32_gb,
               q8_gb=param_bytes(params) / 1e9, allocated_gb=held,
               init_peak_gb=peak,
               run_peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               prompt_lens=[len(p) for p in prompts],
               streams_sha1=hashlib.sha1(
                   json.dumps(streams).encode()).hexdigest()[:12])
    _suffixed(counted, mine, arch)
    del params
    torch.cuda.empty_cache()
    return rec


# whisper-small (phase 25): the kernels of its path, for the shares of
# whisper_plain_delta
WS_KERNELS = ("q8_matvec", "q8_matmul", "quantize", "flash_prefill",
              "decode_attention")


def _whisper_controls(cfg):
    """whisper-small's planted faults, which phase 2's per-kernel checks
    cannot see: by name, (a context that patches one entry of the port
    for its duration, or None; a function of the parameters, or None;
    whether the bound must reject it).  The encoder's square call made
    causal; the decoder's learned positions read one row on (every
    position p reads row p + 1); the cross K/V made from the encoder's
    last layer but one (its final norm kept); measured, not required: the
    cross cache read one key short (lens 1503) and PyTorch's default exact
    GELU in the tanh form's place."""
    from repro_torch.core.qlinear import qdot
    from repro_torch.kernels import ops
    from repro_torch.models import encdec, layers

    def patch(mod, name, wrap):
        @contextlib.contextmanager
        def ctx():
            saved = getattr(mod, name)
            setattr(mod, name, wrap(saved))
            try:
                yield
            finally:
                setattr(mod, name, saved)
        return ctx

    def causal_encoder(fn):
        def f(q, k, v, q_offset=None, q_lens=None, k_lens=None,
              causal=True, scale=None):
            causal = causal or q.shape[1] == k.shape[1]
            return fn(q, k, v, q_offset, q_lens, k_lens, causal, scale)
        return f

    def wrong_layer(fn):
        def f(params, c, frames, **kw):
            return fn(params, c.with_(n_enc_layers=c.n_enc_layers - 1),
                      frames, **kw)
        return f

    def short_cross(fn):
        def f(q, k, v, lens, *args):
            if k.shape[1] == cfg.enc_seq:
                lens = lens - 1
            return fn(q, k, v, lens, *args)
        return f

    def exact_gelu(fn):
        def f(p, x):
            h = torch.nn.functional.gelu(qdot(x, p["w1"]))
            return qdot(h.to(x.dtype), p["w2"]).to(x.dtype)
        return f

    def shifted(params):
        return dict(params, dec_pos=params["dec_pos"][1:])

    return {
        "flash_prefill: encoder made causal": (
            patch(ops, "flash_prefill_kernel", causal_encoder), None, True),
        "decoder positions shifted by one": (None, shifted, True),
        "cross K/V from the wrong encoder layer": (
            patch(encdec, "encode", wrong_layer), None, True),
        "decode_attention: cross cache one key short": (
            patch(ops, "decode_attention_kernel", short_cross), None,
            False),
        "gelu_mlp: exact GELU in place of tanh": (
            patch(layers, "gelu_mlp", exact_gelu), None, False)}


def _whisper_run(model, params, batch, feed=None):
    """The logits at every prefill position (B, S, V) (the encoder, the
    decoder over the prompts, the head over every row), then ``WS_STEPS``
    decode steps from ``Model.prefill``'s caches, each fed ``feed``'s
    token (default: its own greedy pick): (prefill logits, the steps'
    logits (steps, B, V), the tokens fed (steps, B))."""
    from repro_torch.models import encdec
    cfg = model.cfg
    enc = encdec.encode(params, cfg, batch["frames"])
    hidden, _ = encdec.decoder_hidden(params, cfg, batch["tokens"], enc)
    every = encdec._lm_head(params, hidden)
    logits, cache = model.prefill(params, batch, max_seq=WS_MAX_SEQ)
    steps, fed = [], []
    for t in range(WS_STEPS):
        tok = torch.argmax(logits, -1) if feed is None else feed[t]
        fed.append(tok)
        logits, cache = model.decode_step(params, cache, tok)
        steps.append(logits)
    return every, torch.stack(steps), torch.stack(fed)


def whisper_plain_delta(model, params, batch, shares=(), controls=None):
    """``kernel_plain_delta`` for the encoder-decoder, at the model level:
    ``_whisper_run`` on the kernels against the same run on the plain
    versions, each decode step fed the plain run's greedy token (the same
    inputs; each run keeps its own caches).  Logits at every prefill
    position and at every decode step, each set held to the fixed bound
    ``plain_delta_bound`` at ``delta_sites`` (three residual adds a
    decoder layer, two an encoder layer through the cross K/V) with the
    union bound's lambda for the rows held at once
    (``every_position_lambda``: 8 x 16 prefill rows, 8 x 32 decode rows),
    at the scale of its plain logits.  For each kernel of ``shares``, the
    same with only it plain (its share: what the difference loses without
    it; the runs with every other kernel plain, as ``kernel_plain_delta``
    adds, take ~2 s each on the plain GEMV and are left out for the
    script's time); each planted fault
    of ``controls`` (``_whisper_controls``) with every kernel launched,
    which the bound must reject where required.  Raises otherwise;
    returns the record."""
    cfg = model.cfg
    t0 = time.perf_counter()
    with plain_versions():
        p_every, p_steps, feed = _whisper_run(model, params, batch)

    def run(plain, ctx=None, transform=None):
        with plain_versions(plain), (ctx() if ctx else
                                     contextlib.nullcontext()):
            every, steps, _ = _whisper_run(
                model, transform(params) if transform else params, batch,
                feed)
        torch.cuda.synchronize()
        return ((every - p_every).abs().max().item(),
                (steps - p_steps).abs().max().item())

    sites = delta_sites(cfg)
    n_pre = p_every.numel() // p_every.shape[-1]
    n_dec = p_steps.numel() // p_steps.shape[-1]
    tols = [plain_delta_bound(cfg, t.abs().max().item(), sites)
            * every_position_lambda(n) / PLAIN_DELTA_LAMBDA
            for t, n in ((p_every, n_pre), (p_steps, n_dec))]

    def ratio(d):
        return max(d[0] / tols[0], d[1] / tols[1])
    d = run(())
    rec = {"prefill": d[0], "decode": d[1], "bound_prefill": tols[0],
           "bound_decode": tols[1], "sites": sites * cfg.n_layers,
           "lambda_prefill": every_position_lambda(n_pre),
           "lambda_decode": every_position_lambda(n_dec),
           "scale_prefill": p_every.abs().max().item(),
           "scale_decode": p_steps.abs().max().item(),
           "shares": {}, "controls": {}}
    rec["seconds"] = {"runs": time.perf_counter() - t0}
    t0 = time.perf_counter()
    for name in shares:
        rec["shares"][name] = x = run((name,))
        log(f"    {name}: plain alone prefill {x[0]:.4g}, decode {x[1]:.4g}")
    rec["seconds"]["shares"] = time.perf_counter() - t0
    worst = max([ratio(d)] + [ratio(x) for x in rec["shares"].values()])
    log(f"  kernels vs plain versions on the same inputs: logits max |diff| "
        f"at every prefill position {d[0]:.4g}, over {WS_STEPS} decode "
        f"steps {d[1]:.4g}; fixed bounds lambda * "
        f"sqrt({sites * cfg.n_layers:g} sites) * {PLAIN_DELTA_UNIT:.5f} * "
        f"scale: prefill (lambda "
        f"{rec['lambda_prefill']:.3g}, scale {rec['scale_prefill']:.4g}) "
        f"{tols[0]:.4g}, decode (lambda {rec['lambda_decode']:.3g}, scale "
        f"{rec['scale_decode']:.4g}) {tols[1]:.4g}; worst of "
        f"{1 + len(shares)} runs {worst:.3g} x its bound")
    if not worst <= 1:
        raise AssertionError(f"{cfg.arch_id}: kernels vs plain logits "
                             f"differ by {worst} x the fixed bound: {rec}")
    controls = controls or {}
    t0 = time.perf_counter()
    for name, (ctx, transform, _) in controls.items():
        rec["controls"][name] = hit = run((), ctx, transform)
        log(f"    control, {name}: prefill {hit[0]:.4g}, decode "
            f"{hit[1]:.4g} ({ratio(hit):.2f} x the bound"
            f"{'' if controls[name][2] else '; measured, not required'})")
    rec["seconds"]["controls"] = time.perf_counter() - t0
    missed = [k for k, hit in rec["controls"].items()
              if controls[k][2] and not ratio(hit) > 1]
    if missed:
        raise AssertionError(f"{cfg.arch_id}: the fixed bounds do not "
                             f"reject the planted faults {missed}: "
                             f"{rec['controls']}")
    return rec


def _whisper_launches(launches, cfg, b, s, steps, counted):
    """The launches of one ``Model.prefill`` of b rows of s tokens and
    ``steps`` decode steps, exactly.  A prefill: ``flash_prefill`` once an
    encoder layer and twice a decoder layer (causal self, non-causal
    cross), the MLP's w1 and w2 a layer of both stacks (the GEMM above 32
    rows) each behind a ``quantize``, the head's GEMV at the last
    position's b rows behind one more; the Q/K/V/O run on the dequant
    ``qeinsum`` and the layer norms in plain PyTorch.  A decode step: w1,
    w2 a decoder layer and the head on the GEMV, each behind a
    ``quantize``, ``decode_attention`` twice a layer (self, cross).  The
    counts are added to ``counted``."""
    from repro_torch.kernels import build
    ne, nd = cfg.n_enc_layers, cfg.n_layers
    want = dict.fromkeys(build.LAUNCHES, 0)
    want["flash_prefill"] = ne + 2 * nd
    for rows, n in ((b * cfg.enc_seq, ne), (b * s, nd)):
        want["q8_matmul" if rows > 32 else "q8_matvec"] += 2 * n
    want["q8_matvec"] += 1 + (2 * nd + 1) * steps
    want["quantize"] = 2 * (ne + nd) + 1 + (2 * nd + 1) * steps
    want["decode_attention"] = 2 * nd * steps
    if launches != want:
        raise AssertionError(f"{cfg.arch_id}: launches {launches} != "
                             f"expected {want}")
    for k, v in launches.items():
        counted[k] = counted.get(k, 0) + v
    log(f"  launches {dict((k, v) for k, v in launches.items() if v)}: per "
        f"prefill {ne + 2 * nd} flash_prefill, {2 * (ne + nd)} q8_matmul, "
        f"{2 * (ne + nd) + 1} quantize and 1 head q8_matvec; per decode "
        f"step {2 * nd + 1} q8_matvec, {2 * nd + 1} quantize and {2 * nd} "
        f"decode_attention, over {steps} steps")


def whisper_path(dev, counted, n=25):
    """Phase ``n``: whisper-small at full width and depth (12 encoder and
    12 decoder layers, d_model 768, 12 heads of 64, d_ff 3072, vocab 51865,
    bf16 compute), served at the model level, as the reference serves its
    audio family: the port's ``Engine`` must refuse it.  Q8_0 by the
    reference's policy, drawn by ``Model.init_quantized`` and held bitwise
    against ``Model.quantize(Model.init(0))``.  8 rows of stub frames
    (8, 1504, 768) and 16-token prompts from the seed; one
    ``Model.prefill`` into caches of Whisper's 448-token text context,
    then 32 greedy ``decode_step``s, on a bf16 and on an int8 KV cache:
    exact launches (``_whisper_launches``), finite logits, tokens inside
    the head's rows, ``lens`` 48; ``whisper_plain_delta`` on each (on the
    bf16 cache with every kernel's share and the planted faults); 4
    profiled decode steps for the card's busy share.
    Launches are counted under ``<kernel>@whisper-small``."""
    import hashlib
    from repro_torch.configs import get_config
    from repro_torch.core.quantization import tree_differs
    from repro_torch.kernels import build
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Engine
    cfg = get_config(WS)
    model = build_model(cfg)
    want = model.quantize(model.init(seed=0, device=dev))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init_quantized(seed=0, device=dev)
    torch.cuda.synchronize()
    made = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    differ = tree_differs(params, want)
    del want
    torch.cuda.empty_cache()
    if differ:
        raise AssertionError(f"{WS}: init_quantized differs from "
                             f"quantize(init) at {differ}")
    try:
        Engine(model, params, device=dev)
    except NotImplementedError as exc:
        refusal = str(exc)
    else:
        raise AssertionError(f"{WS}: the engine took the audio family")
    gen = torch.Generator(device=dev).manual_seed(n)
    batch = {"frames": torch.randn((WS_B, cfg.enc_seq, cfg.d_model),
                                   generator=gen, device=dev),
             "tokens": torch.randint(4, cfg.vocab_size, (WS_B, WS_PROMPT),
                                     generator=gen, device=dev)}
    phase(f"phase {n}: {WS} full width and depth, {cfg.n_enc_layers} "
          f"encoder + {cfg.n_layers} decoder layers (d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads of {cfg.hd()}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size} (head {cfg.padded_vocab()} rows), "
          f"{cfg.compute_dtype}), Q8_0 parameters "
          f"{param_bytes(params) / 1e9:.3f} GB quantized as drawn in "
          f"{made:.1f} s (peak {peak:.2f} GB), bitwise quantize(init); "
          f"the engine refuses it ({refusal[:60]}...); {WS_B} rows of "
          f"{cfg.enc_seq} stub frames and {WS_PROMPT}-token prompts, "
          f"Model.prefill then {WS_STEPS} greedy decode steps at max_seq "
          f"{WS_MAX_SEQ}")
    rec = {"init_s": made, "init_peak_gb": peak,
           "q8_gb": param_bytes(params) / 1e9, "refusal": refusal}
    mine = {}
    for kv in ("bfloat16", "int8"):
        m = build_model(cfg.with_(kv_cache_dtype=kv))
        build.reset_launches()
        t0 = time.perf_counter()
        logits, cache = m.prefill(params, batch, max_seq=WS_MAX_SEQ)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        out, finite = [], bool(torch.isfinite(logits).all())
        t0 = time.perf_counter()
        for _ in range(WS_STEPS):
            out.append(torch.argmax(logits, -1))
            logits, cache = m.decode_step(params, cache, out[-1])
            finite &= bool(torch.isfinite(logits).all())
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t0
        _whisper_launches(dict(build.LAUNCHES), cfg, WS_B, WS_PROMPT,
                          WS_STEPS, mine)
        streams = torch.stack(out, 1).tolist()
        lens = cache["lens"].tolist()
        if not (finite and logits.shape == (WS_B, cfg.padded_vocab())
                and lens == [WS_PROMPT + WS_STEPS] * WS_B
                and all(t < cfg.padded_vocab() for s in streams
                        for t in s)):
            raise AssertionError(f"{WS} {kv} cache: finite {finite}, "
                                 f"logits {tuple(logits.shape)}, lens {lens}")
        toks = WS_B * WS_STEPS
        log(f"  {WS}, {kv} KV, kernel strategy: prefill {1e3 * t_pre:.2f} "
            f"ms, {WS_STEPS} decode steps {1e3 * t_dec / WS_STEPS:.3f} ms "
            f"each, {toks / (t_pre + t_dec):.1f} tok/s")
        bf16 = kv == "bfloat16"
        delta = whisper_plain_delta(
            m, params, batch, shares=WS_KERNELS if bf16 else (),
            controls=_whisper_controls(cfg) if bf16 else None)
        rec[kv] = {"prefill_ms": 1e3 * t_pre,
                   "decode_step_ms": 1e3 * t_dec / WS_STEPS,
                   "tok_s": toks / (t_pre + t_dec),
                   "kernel_plain_delta": delta,
                   "streams_sha1": hashlib.sha1(
                       json.dumps(streams).encode()).hexdigest()[:12]}

    # the profile: decode steps alone (a prefill and 8 steps took ~20 s of
    # the profiler's own time)
    logits, cache = model.prefill(params, batch, max_seq=WS_MAX_SEQ)
    tok = torch.argmax(logits, -1)
    t0 = time.perf_counter()
    _, rec["decode_busy_share"] = profiled(
        lambda: [model.decode_step(params, cache, tok) for _ in range(4)])
    rec["profile_s"] = time.perf_counter() - t0
    rec.update(launches=mine, run_peak_gb=torch.cuda.max_memory_allocated()
               / 1e9)
    _suffixed(counted, mine, WS)
    del params
    torch.cuda.empty_cache()
    return rec


# phases 18-21's depths, cut to keep the script in its time: glm4-9b's
# 40 layers (phase 19) to make room for phase 20, command-r-35b's 40
# (phase 20) for phase 21, and, for phases 22-23 (~125 s), phi4-mini-3.8b's
# 32 (phase 18, ~0.6 s a layer), qwen3-moe-30b-a3b's 48 (phase 21, ~2 s a
# layer; its MoE init still held bitwise at 2 layers) and glm4-9b's and
# command-r-35b's further; every kernel at each config's shapes stays in
# phase 2.  Phase 24 (qwen2-vl-7b, ~1.6 s a layer with its controls; 45 s
# at all 28 layers) runs cut to 4 layers for phases 24-25; at all 28:
# ``full_width_path(dev, {}, Q2, 24)`` alone
# the kernels of the interleave's dense path (phase 26), for the shares of
# kernel_plain_delta, and the planted faults its bound must reject (the
# K group and the rotated KV heads; the newest key dropped is measured)
L4_KERNELS = ("q8_matvec", "q8_matmul", "rmsnorm_quant", "quantize", "rope",
              "decode_attention", "flash_prefill")
L4_CONTROLS = ("q8_matvec: last K group dropped",
               "q8_matmul: last K group dropped",
               "decode_attention: KV heads rotated",
               "decode_attention: newest key dropped")
# two patterns of the 24: its Q8_0 tree is ~424 GB at 48 layers, ~36 GB
# at 4, the f32 copy of one expert bank (21.5 GB) held beside it while a
# layer's experts run
L4_PHASE_LAYERS = 4


def _l4_prompts(vocab, seed, shared_len=64, shared_at=(0, 5)):
    """Phase 26's 8 seeded prompts of ``L4_PROMPT_LENS`` tokens; those at
    ``shared_at`` start with one common ``shared_len``-token prefix."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(4, vocab, size=shared_len)
    out = []
    for i, n in enumerate(L4_PROMPT_LENS):
        p = rng.integers(4, vocab, size=n)
        if i in shared_at:
            p[:shared_len] = shared
        out.append(p.astype(np.int32))
    return out


def _group_rule(cfg, s):
    """(group size, groups, capacity) of ``layers.moe_mlp``'s grouped
    dispatch for one prompt of ``s`` tokens: ``moe_group`` lowered until
    it divides s; capacity ``capacity_factor * group * top_k / n_experts``,
    at least 1, rounded up to a multiple of 4."""
    g_sz = min(cfg.moe_group, s)
    while s % g_sz:
        g_sz -= 1
    cap = max(int(cfg.capacity_factor * g_sz * cfg.top_k / cfg.n_experts), 1)
    return g_sz, s // g_sz, (cap + 3) & ~3


def _first_unit_group(cfg):
    """The shortest prompt whose group rule leaves groups of one token."""
    s = cfg.moe_group + 1
    while _group_rule(cfg, s)[0] != 1:
        s += 1
    return s


def interleave_path(dev, counted, n=26):
    """Phase ``n``: llama4-maverick-400b-a17b at full width (d_model 5120,
    40 / 8 heads of 128, 128 experts of d_ff 8192, top 1, vocab 202048),
    cut to ``L4_PHASE_LAYERS`` layers (two patterns of a dense and an MoE
    layer), from the port's own seeded init quantized as it draws
    (``Model.init_quantized``; first held bitwise against
    ``quantize(init)`` at one pattern of 8 experts, ``moe_init_bitwise``).
    ``Engine(model, params)`` with the default ``cache_kind`` falls back to
    the dense per-slot cache (8 slots x 1024), as the reference's does for
    the interleave: one-shot prefill on flash_prefill, the MoE's grouped
    dispatch; decode on decode_attention, its dense dispatch.  8 prompts
    (``L4_PROMPT_LENS``: 512 tokens, groups of 512; a prime 101, groups of
    one token; two sharing a 64-token prefix), 32 greedy tokens, on a bf16
    and then an int8 KV cache.  Before them: the peak memory of one
    one-shot prefill at 101 and at 512 tokens, and ``kernel_plain_delta``
    (8 x 256 prefill, then a decode step) with the routes pinned, every
    kernel's share and ``L4_CONTROLS`` on the bf16 cache, the bound alone
    on the int8 cache; each with its free-route flips counted.  Asserts the
    exact launch counts by layer kind (``check_launches``), no prefix hit
    and no token past the head's rows; a short run (two requests, 8
    tokens) under the profiler.  Launches are counted under
    ``<kernel>@<arch>``; the record carries the init's seconds and peak,
    the Q8_0 GB, the peaks of the prefills and of each run, and digests of
    the streams.  The parameters are freed before it returns."""
    import hashlib
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models.model import build_model
    cfg = get_config(L4).with_(n_layers=L4_PHASE_LAYERS)
    moe_init_bitwise(dev, cfg, 2, n_experts=8)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init_quantized(seed=0, device=dev)
    torch.cuda.synchronize()
    made = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    held = torch.cuda.memory_allocated() / 1e9
    q8_gb = param_bytes(params) / 1e9
    prompts = _l4_prompts(cfg.vocab_size, seed=n)
    phase(f"phase {n}: {L4} full width, {cfg.n_layers} layers (cut: "
          f"{cfg.n_layers // cfg.moe_every} patterns of a dense and an MoE "
          f"layer) (d_model {cfg.d_model}, {cfg.n_heads} / "
          f"{cfg.n_kv_heads} heads of {cfg.hd()}, {cfg.n_experts} experts "
          f"of d_ff {cfg.d_ff}, top {cfg.top_k}, vocab {cfg.vocab_size} "
          f"(head {cfg.padded_vocab()} rows), rope theta "
          f"{cfg.rope_theta:g}, {cfg.compute_dtype}), Q8_0 parameters "
          f"{q8_gb:.2f} GB ({held:.2f} GB allocated) quantized as drawn on "
          f"the card in {made:.1f} s (peak {peak:.2f} GB allocated); 8 "
          f"requests of {', '.join(map(str, L4_PROMPT_LENS))} tokens, 32 "
          "greedy tokens, the default cache_kind")
    rules = {str(len(p)): _group_rule(cfg, len(p)) for p in prompts}
    log("  the grouped dispatch's rule (group size, groups, capacity) by "
        "prompt length: " + ", ".join(f"{k}: {v}" for k, v in rules.items())
        + f"; groups of one token first at {_first_unit_group(cfg)} tokens "
        "(a prime past moe_group)")
    prefill_peak = {}
    for p in prompts[:2]:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        logits, _ = model.prefill(params, {"tokens": p[None]}, max_seq=1024)
        torch.cuda.synchronize()
        prefill_peak[str(len(p))] = {
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "s": time.perf_counter() - t0}
        if not torch.isfinite(logits).all():
            raise AssertionError(f"{L4}: non-finite prefill logits")
        del logits
    log("  one-shot prefill peaks: " + "; ".join(
        f"{k} tokens {v['peak_gb']:.2f} GB allocated ({v['s']:.2f} s)"
        for k, v in prefill_peak.items()))
    torch.cuda.empty_cache()
    mine, recs = {}, {}
    for kv in ("bfloat16", "int8"):
        m = build_model(cfg.with_(kv_cache_dtype=kv))
        delta = kernel_plain_delta(
            m, params, prompts, dev, dense=True,
            **(dict(shares=L4_KERNELS, controls=L4_CONTROLS)
               if kv == "bfloat16" else {}))
        build.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        eng, streams, wall = serve(m, params, prompts, dev, 32, **SSM_KW)
        if eng.paged or set(eng.cache) != {"lens", "attn_dense",
                                           "attn_moe"}:
            raise AssertionError(f"{L4}: the engine did not fall back to "
                                 "the dense cache's two attention banks")
        check_launches(eng, dict(build.LAUNCHES), m.cfg, mine)
        if eng.metrics["prefix_hits"]:
            raise AssertionError(f"{L4}: a prefix hit on the dense cache")
        if any(t >= cfg.padded_vocab() for s in streams for t in s):
            raise AssertionError(f"{L4}: a token past the head's rows")
        rec = engine_line(f"{L4}, dense fallback, {kv} KV, kernel "
                          "strategy", eng, streams, wall)
        rec.update(kernel_plain_delta=delta,
                   run_peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   streams_sha1=hashlib.sha1(
                       json.dumps(streams).encode()).hexdigest()[:12])
        log(f"  peak {rec['run_peak_gb']:.2f} GB allocated over the {kv} "
            "run")
        recs[kv] = rec
    _, busy = profiled(lambda: serve(model, params, prompts[6:], dev, 8,
                                     **SSM_KW))
    out = dict(recs, device_busy_share=busy, launches=mine, group_rule=rules,
               n_layers=cfg.n_layers, init_s=made, q8_gb=q8_gb,
               allocated_gb=held, init_peak_gb=peak,
               prefill_peak=prefill_peak,
               prompt_lens=list(L4_PROMPT_LENS))
    _suffixed(counted, mine, L4)
    del params
    torch.cuda.empty_cache()
    return out


P4_PHASE_LAYERS = 12
G4_PHASE_LAYERS = 4
CR_PHASE_LAYERS = 4
Q3_PHASE_LAYERS = 4
Q2_PHASE_LAYERS = 4


def bf16_paths(dev, counted):
    """Phases 16-21, the bf16 configs: llama3.2-3b's parameters drawn once
    (``llama3_params``), the paged pools (phase 16), the dense cache and
    Q4_0 (phase 17), then phi4-mini-3.8b at ``P4_PHASE_LAYERS`` layers
    (phase 18), glm4-9b at ``G4_PHASE_LAYERS`` (phase 19), command-r-35b at
    ``CR_PHASE_LAYERS`` (phase 20) and qwen3-moe-30b-a3b at
    ``Q3_PHASE_LAYERS`` (phase 21), each drawn after the last one's
    parameters are freed.  Alone on the
    card: ``build.build()``, ``qlinear.set_default_strategy("kernel")``
    and ``torch.backends.cuda.matmul.allow_tf32 = False`` first, as
    ``main`` does, then ``bf16_paths(torch.device("cuda"), {})``."""
    cfg, params, p4, prompts, made = llama3_params(dev)
    l3, paged = llama3_path(dev, cfg, params, prompts, made, counted)
    phase(f"phase 16: {L3} {json.dumps(l3)}")
    l3b = llama3_dense_q4(dev, cfg, params, p4, prompts, paged, counted)
    phase(f"phase 17: {L3} {json.dumps(l3b)}")
    del params, p4
    torch.cuda.empty_cache()
    phi = full_width_path(dev, counted, P4, 18, n_layers=P4_PHASE_LAYERS)
    phase(f"phase 18: {P4} {json.dumps(phi)}")
    glm = full_width_path(dev, counted, G4, 19, n_layers=G4_PHASE_LAYERS)
    phase(f"phase 19: {G4} {json.dumps(glm)}")
    cr = full_width_path(dev, counted, CR, 20, n_layers=CR_PHASE_LAYERS)
    phase(f"phase 20: {CR} {json.dumps(cr)}")
    q3 = full_width_path(dev, counted, Q3, 21, n_layers=Q3_PHASE_LAYERS)
    phase(f"phase 21: {Q3} {json.dumps(q3)}")
    return l3, l3b, phi, glm, cr, q3


def ssm_paths(dev, counted):
    """Phases 22-23, the SSM families on the dense fallback: mamba2-370m
    (phase 22) and zamba2-1.2b (phase 23), each at full width and depth
    (``ssm_path``).  Alone on the card: ``build.build()``,
    ``qlinear.set_default_strategy("kernel")`` and
    ``torch.backends.cuda.matmul.allow_tf32 = False`` first, as ``main``
    does, then ``ssm_paths(torch.device("cuda"), {})``."""
    m2 = ssm_path(dev, counted, M2, 22)
    phase(f"phase 22: {M2} {json.dumps(m2)}")
    z2 = ssm_path(dev, counted, Z2, 23)
    phase(f"phase 23: {Z2} {json.dumps(z2)}")
    return m2, z2


def vlm_audio_paths(dev, counted):
    """Phases 24-25, the vlm and audio families: qwen2-vl-7b at
    ``Q2_PHASE_LAYERS`` layers on the paged engine (``full_width_path``,
    then ``vlm_prefill``) and whisper-small at full depth at the model
    level (``whisper_path``).  Alone on the card: ``build.build()``,
    ``qlinear.set_default_strategy("kernel")`` and
    ``torch.backends.cuda.matmul.allow_tf32 = False`` first, as ``main``
    does, then ``vlm_audio_paths(torch.device("cuda"), {})``; or
    ``python3 chip_smoke.py --only vlm_audio_paths``."""
    q2 = full_width_path(dev, counted, Q2, 24, n_layers=Q2_PHASE_LAYERS)
    phase(f"phase 24: {Q2} {json.dumps(q2)}")
    ws = whisper_path(dev, counted, 25)
    phase(f"phase 25: {WS} {json.dumps(ws)}")
    return q2, ws


def interleave_paths(dev, counted):
    """Phase 26, the llama4 interleave on the dense fallback:
    llama4-maverick-400b-a17b at full width, ``L4_PHASE_LAYERS`` layers
    (``interleave_path``).  Alone on the card: ``build.build()``,
    ``qlinear.set_default_strategy("kernel")`` and
    ``torch.backends.cuda.matmul.allow_tf32 = False`` first, as ``main``
    does, then ``interleave_paths(torch.device("cuda"), {})``; or
    ``python3 chip_smoke.py --only interleave_paths``."""
    l4 = interleave_path(dev, counted, 26)
    phase(f"phase 26: {L4} {json.dumps(l4)}")
    return l4


# ---------------------------------------------------------------------------
# phase 27: training (launch/train.py), then serve.py --ckpt-dir
# ---------------------------------------------------------------------------

# llama2-110m at full width and depth, as launch/train.py --full runs it
TRAIN_KW = dict(arch="llama2-110m", use_reduced=False, batch=8, seq=256,
                log_every=10)
TRAIN_STEPS, RESUME_STEPS, TRAIN_CKPT_EVERY = 30, 45, 15
# The card-vs-CPU step (2 x 64 tokens, f32, 12 layers: the two differ by
# summation order alone), fixed before the first run: the loss within
# CPU_LOSS_RTOL of the CPU's, the gradient norm within CPU_GNORM_RTOL, each
# gradient leaf and each first moment within CPU_GRAD_RTOL of that leaf's
# largest CPU magnitude, and each updated parameter within two learning
# rates (AdamW's first step moves an element by lr * (g / (|g| + eps) +
# wd * p): +-lr wherever |g| >> eps, so the two can part by up to 2 lr only
# where g is within rounding of 0; the share of elements more than 1e-6
# apart is printed).
CPU_LOSS_RTOL = 2e-5
CPU_GNORM_RTOL = 1e-4
CPU_GRAD_RTOL = 1e-3
# a run resumed from step 30 against the uninterrupted run of the same
# schedule: steps 30-44's losses (f32; fixed before the first run, when the
# embedding's backward was thought to sum by atomics in an order the card
# does not fix: two card calls were then bitwise equal)
RESUME_LOSS_ATOL = 1e-3
L3_TRAIN_STEPS = 4


def _train(dev, **kw):
    """``launch/train.py``'s ``run`` at ``TRAIN_KW`` (``kw`` over them) on
    ``dev``: (losses, each step's record, without its batch but the
    batch's digest)."""
    import hashlib
    from repro_torch.launch import train
    recs = []

    def on_step(r):
        b = r.pop("batch")
        r["batch_sha1"] = hashlib.sha1(b["tokens"].tobytes()
                                       + b["labels"].tobytes()).hexdigest()
        recs.append(r)
    losses = train.run(**{**TRAIN_KW, **kw}, device=dev, on_step=on_step)
    return losses, recs


def _train_stats(recs):
    """Medians over the steps after the first (which pays the first call's
    set-up) of the data draw's ms, the step's device ms (synchronized) and
    tokens per second over both."""
    rest = recs[1:] or recs
    return {k: float(np.median([r[k] for r in rest]))
            for k in ("data_ms", "device_ms", "tok_s")}


def train_card_vs_cpu(dev):
    """One train step of llama2-110m at full width from the same seeded
    parameters and batch (2 x 64 tokens) on the card and on the CPU (what
    the CPU tests hold against JAX): the loss, the gradient norm, every
    gradient leaf, the first moments and the updated parameters within the
    tolerances above; every leaf's gradient on the card finite and not all
    zeros (a CUDA kernel on the autograd path would leave its weights'
    gradients zero); and a second card call bitwise equal to the first, or
    not (the run's determinism)."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import items, keystr
    from repro_torch.data.pipeline import DataConfig, SyntheticTinyStories
    from repro_torch.launch import steps
    from repro_torch.models.model import build_model, params_to
    from repro_torch.optim import adamw
    cfg = get_config("llama2-110m")
    model = build_model(cfg)
    ocfg = adamw.AdamWConfig(warmup_steps=min(20, TRAIN_STEPS // 5 + 1),
                             decay_steps=TRAIN_STEPS)
    batch = next(SyntheticTinyStories(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=64, batch_size=2,
        seed=1)).batches())
    p_cpu = model.init(0, device="cpu")
    p_dev = params_to(p_cpu, dev)
    t0 = time.perf_counter()
    l_cpu, g_cpu = steps.value_and_grad(model, p_cpu, batch)
    cpu_s = time.perf_counter() - t0
    l_dev, g_dev = steps.value_and_grad(model, p_dev, batch)
    l_again, g_again = steps.value_and_grad(model, p_dev, batch)
    deterministic = bool(torch.equal(l_dev, l_again)) and all(
        torch.equal(a, b) for (_, a), (_, b) in zip(items(g_dev),
                                                    items(g_again)))
    del g_again
    dead = [keystr(p) for p, g in items(g_dev)
            if not (torch.isfinite(g).all() and g.abs().max() > 0)]
    if dead:
        raise AssertionError(f"gradients not finite or all zero on the "
                             f"card: {dead}")

    def worst(got, want):
        return max((a.cpu() - b).abs().max().item()
                   / max(b.abs().max().item(), 1e-30)
                   for (_, a), (_, b) in zip(items(got), items(want)))
    grad_err = worst(g_dev, g_cpu)
    _, o_cpu, m_cpu, _ = adamw.apply_updates(p_cpu, adamw.init_state(p_cpu),
                                             g_cpu, ocfg)
    _, o_dev, m_dev, _ = adamw.apply_updates(p_dev, adamw.init_state(p_dev),
                                             g_dev, ocfg)
    moment_err = worst(o_dev["m"], o_cpu["m"])
    lr = float(m_cpu["lr"])
    d = torch.cat([(a.cpu() - b).abs().reshape(-1)
                   for (_, a), (_, b) in zip(items(p_dev), items(p_cpu))])
    rec = {"loss_card": float(l_dev), "loss_cpu": float(l_cpu),
           "loss_rel": abs(float(l_dev) - float(l_cpu)) / abs(float(l_cpu)),
           "grad_norm_rel": abs(float(m_dev["grad_norm"])
                                - float(m_cpu["grad_norm"]))
           / float(m_cpu["grad_norm"]),
           "grad_err": grad_err, "moment_err": moment_err,
           "param_max_diff": d.max().item(), "lr": lr,
           "param_share_past_1e-6": (d > 1e-6).float().mean().item(),
           "deterministic": deterministic, "cpu_step_s": cpu_s}
    log(f"  card vs CPU, one step of 2 x 64 tokens: loss "
        f"{rec['loss_card']:.7f} vs {rec['loss_cpu']:.7f} (rel "
        f"{rec['loss_rel']:.3g}, bound {CPU_LOSS_RTOL:g}); grad norm rel "
        f"{rec['grad_norm_rel']:.3g} (bound {CPU_GNORM_RTOL:g}); worst leaf "
        f"gradient {grad_err:.3g} and first moment {moment_err:.3g} of its "
        f"largest CPU magnitude (bound {CPU_GRAD_RTOL:g}); updated "
        f"parameters max |diff| {rec['param_max_diff']:.3g} (bound 2 lr = "
        f"{2 * lr:.3g}), {100 * rec['param_share_past_1e-6']:.4f}% of them "
        f"more than 1e-6 apart; every leaf's card gradient finite and "
        f"nonzero; two card calls "
        f"{'bitwise equal' if deterministic else 'differ'}; the CPU loss "
        f"and gradients took {cpu_s:.1f} s")
    if not (rec["loss_rel"] <= CPU_LOSS_RTOL
            and rec["grad_norm_rel"] <= CPU_GNORM_RTOL
            and grad_err <= CPU_GRAD_RTOL and moment_err <= CPU_GRAD_RTOL
            and rec["param_max_diff"] <= 2 * lr + 1e-6):
        raise AssertionError(f"train step: card vs CPU past its bounds: "
                             f"{rec}")
    return rec


def train_profile(dev, steps_n=2):
    """Two train steps of llama2-110m at 8 x 256 from one pre-drawn batch
    under the profiler: the card's busy share of the step itself (the data
    draw excluded) and its heaviest device operations."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTinyStories
    from repro_torch.launch import steps
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    cfg = get_config("llama2-110m")
    model = build_model(cfg)
    batch = next(SyntheticTinyStories(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_KW["seq"],
        batch_size=TRAIN_KW["batch"])).batches())
    params = model.init(0, device=dev)
    state = {"params": params, "opt": adamw.init_state(params)}
    fn = steps.make_train_step(model, adamw.AdamWConfig())
    state, _ = fn(state, batch)             # warm
    torch.cuda.synchronize()

    def run():
        st = state
        for _ in range(steps_n):
            st, m = fn(st, batch)
        return float(m["loss"])
    _, busy = profiled(run)
    return busy


def _ggml_lifecycle(dev, model, params, path):
    """``ggml_export.export`` of the trained Q8_0 tree (the unfused
    weights: the fused decode operands are the same codes again) on the
    card, and of the same tree moved to the CPU: the bytes equal; and
    ``read_back`` within the reference test's bound, each value within
    half a GGML 32-block step plus the f16 scale's rounding."""
    from repro_torch.checkpoint import ggml_export
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.core.quantization import QuantizedTensor
    from repro_torch.core.tree import items, keystr
    from repro_torch.models.model import params_to
    q = model.quantize(params, QuantPolicy(bits=8, min_size=512),
                       fuse_decode=False)
    t0 = time.perf_counter()
    ggml_export.export(f"{path}.card", q)
    secs = time.perf_counter() - t0
    ggml_export.export(f"{path}.cpu", params_to(q, "cpu"))
    same = (Path(f"{path}.card").read_bytes()
            == Path(f"{path}.cpu").read_bytes())
    back = ggml_export.read_back(f"{path}.card")
    worst = 0.0
    for p, leaf in items(q):
        if not isinstance(leaf, QuantizedTensor):
            continue
        src = leaf.dequantize().cpu().numpy().reshape(-1, 32)
        step = np.abs(src).max(-1, keepdims=True) / 127.0
        err = np.abs(back[keystr(p)][1].reshape(-1, 32) - src)
        worst = max(worst, float((err / (step * 0.51 + 1e-3)).max()))
    rec = {"bytes": Path(f"{path}.card").stat().st_size,
           "bytes_equal": same, "read_back_worst_share_of_bound": worst,
           "export_s": secs}
    log(f"  ggml_export: {rec['bytes'] / 1e6:.1f} MB in {secs:.1f} s from "
        f"the card; {'the same bytes as' if same else 'DIFFERENT bytes from'}"
        f" the export of the same tree on the CPU; read_back within "
        f"{worst:.3f} of the bound err <= step * 0.51 + 1e-3")
    if not same or not worst <= 1:
        raise AssertionError(f"ggml export on the card: {rec}")
    return rec


def train_path(dev, counted, n=27):
    """Phase ``n``: training at full width, then the trained weights served
    on the kernels.  (1) ``launch/train.py``'s ``run`` (``jit_train_step``
    on ``make_host_mesh()``, a world of one) trains llama2-110m
    (12 layers, d_model 768, f32) 30 steps of 8 x 256 from the
    synthetic TinyStories stream, checkpointing every 15 steps: every loss
    finite, the last below the first, no kernel launched.  (2)
    ``train_card_vs_cpu``.  (3) ``run(steps=45)`` on the same directory
    resumes at step 30 and runs 30-44 on the batches of an uninterrupted
    45-step run, bitwise; the reference's trainer sets the schedule from
    ``steps``, so those first 30 steps ran another schedule and the losses
    are printed beside the uninterrupted run's, not held; the uninterrupted
    run, resumed from its own step-30 checkpoint, is held to its own
    losses (``RESUME_LOSS_ATOL``).  (4) ``serve.py --arch llama2-110m
    --full --ckpt-dir`` as a subprocess and through ``run()`` (launches
    exact, counted), the kernels against the plain versions on the trained
    Q8_0 weights (``kernel_plain_delta``, ``PAGED_CONTROLS``), the GGML
    export (``_ggml_lifecycle``).  (5) llama3.2-3b at full width and depth
    (28 layers, bf16 compute, f32 parameters) ``L3_TRAIN_STEPS`` steps of
    8 x 256, its peak memory against the reckoning of parameters,
    gradients, both moments and one chunk's f32 logits and their
    gradient.  Training launches no CUDA kernel of ``kernels/``: the
    reference's training runs no Pallas kernel (``lm_loss`` reaches jnp
    only: ``qeinsum`` on float weights, ``attention_scores_blockwise``, the
    f32 ``lm_head``) and ``src/repro/`` holds no backward of a kernel
    (no ``custom_vjp``)."""
    import shutil
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.kernels import build
    from repro_torch.launch import serve as cli
    from repro_torch.models.model import build_model, count_params
    rec = {}
    cfg = get_config("llama2-110m")
    with tempfile.TemporaryDirectory(prefix="phase27_") as root:
        a, c = os.path.join(root, "a"), os.path.join(root, "c")
        phase(f"phase {n}: launch/train.py run(), llama2-110m full width "
              f"and depth, {TRAIN_STEPS} steps of {TRAIN_KW['batch']} x "
              f"{TRAIN_KW['seq']}, a checkpoint every {TRAIN_CKPT_EVERY}")
        build.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        losses, recs = _train(dev, steps=TRAIN_STEPS, ckpt_dir=a,
                              ckpt_every=TRAIN_CKPT_EVERY)
        peak = torch.cuda.max_memory_allocated() / 1e9
        if any(build.LAUNCHES.values()):
            raise AssertionError(f"training launched kernels: "
                                 f"{dict(build.LAUNCHES)}")
        if not (len(losses) == TRAIN_STEPS and np.all(np.isfinite(losses))
                and losses[-1] < losses[0]):
            raise AssertionError(f"llama2-110m training: losses {losses}")
        rec["llama2_110m"] = {**_train_stats(recs), "peak_gb": peak,
                              "first_loss": losses[0],
                              "last_loss": losses[-1],
                              "params": count_params(
                                  build_model(cfg).init_meta())}
        log(f"  {TRAIN_STEPS} steps: loss {losses[0]:.4f} -> "
            f"{losses[-1]:.4f}, all finite; no kernel launched; median "
            f"step: data {rec['llama2_110m']['data_ms']:.1f} ms, card "
            f"{rec['llama2_110m']['device_ms']:.1f} ms (synchronized), "
            f"{rec['llama2_110m']['tok_s']:.0f} tok/s over both; peak "
            f"{peak:.2f} GB allocated")
        rec["llama2_110m"]["busy_share_of_step"] = train_profile(dev)

        phase(f"phase {n}: one train step on the card against the CPU")
        rec["card_vs_cpu"] = train_card_vs_cpu(dev)

        phase(f"phase {n}: resume: run(steps={RESUME_STEPS}) on the same "
              "directory, against an uninterrupted run")
        rest, rest_recs = _train(dev, steps=RESUME_STEPS, ckpt_dir=a,
                                 ckpt_every=TRAIN_CKPT_EVERY)
        # uninterrupted, checkpointing at step 30 only; then resumed there
        whole, whole_recs = _train(dev, steps=RESUME_STEPS, ckpt_dir=c,
                                   ckpt_every=TRAIN_STEPS)
        again, again_recs = _train(dev, steps=RESUME_STEPS, ckpt_dir=c,
                                   ckpt_every=TRAIN_STEPS)
        shutil.rmtree(c)
        ran = [r["step"] for r in rest_recs]
        want = list(range(TRAIN_STEPS, RESUME_STEPS))
        same_batches = [r["batch_sha1"] for r in rest_recs] == [
            r["batch_sha1"] for r in whole_recs[TRAIN_STEPS:]] == [
            r["batch_sha1"] for r in again_recs]
        resumed = float(np.max(np.abs(np.subtract(again,
                                                  whole[TRAIN_STEPS:]))))
        other = float(np.max(np.abs(np.subtract(rest,
                                                whole[TRAIN_STEPS:]))))
        rec["resume"] = {"steps_run": [ran[0], ran[-1]] if ran else [],
                         "batches_bitwise": same_batches,
                         "resumed_max_loss_diff": resumed,
                         "other_schedule_max_loss_diff": other}
        log(f"  run(steps={RESUME_STEPS}) resumed at step {ran[0]} and ran "
            f"{len(ran)} steps ({ran[0]}..{ran[-1]}); its batches are "
            f"{'bitwise' if same_batches else 'NOT'} those of an "
            f"uninterrupted {RESUME_STEPS}-step run, and so are those of "
            f"that run resumed from its own step-{TRAIN_STEPS} checkpoint, "
            f"whose losses of steps {TRAIN_STEPS}-{RESUME_STEPS - 1} are "
            f"within {resumed:.3g} of the uninterrupted run's (bound "
            f"{RESUME_LOSS_ATOL:g}); the {TRAIN_STEPS}-step run's resume (its "
            f"first {TRAIN_STEPS} steps on the {TRAIN_STEPS}-step schedule) "
            f"within {other:.3g} (printed, not held)")
        if not (ran == want and same_batches and resumed <= RESUME_LOSS_ATOL
                and np.all(np.isfinite(rest))):
            raise AssertionError(f"resume: {rec['resume']}")

        phase(f"phase {n}: python -m repro_torch.launch.serve --arch "
              "llama2-110m --full --ckpt-dir <the trained run> as a "
              "subprocess")
        cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
               "llama2-110m", "--full", "--ckpt-dir", a, "--requests", "16",
               "--slots", "8", "--max-seq", "1024"]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                             env=dict(os.environ, PYTHONPATH=str(SRC)))
        secs = time.perf_counter() - t0
        for line in res.stdout.splitlines():
            log(f"    {line}")
        if (res.returncode != 0 or "[serve] 16/16 requests" not in res.stdout
                or f"restored checkpoint step {RESUME_STEPS}"
                not in res.stdout):
            raise AssertionError(f"serve --ckpt-dir exited "
                                 f"{res.returncode}: {res.stderr[-2000:]}")
        rec["serve_module_s"] = secs
        phase(f"phase {n}: serve.run(ckpt_dir=...), the trained Q8_0 "
              "weights on the kernels")
        build.reset_launches()
        eng, done = cli.run(arch="llama2-110m", use_reduced=False,
                            requests=16, slots=8, max_seq=1024, max_new=48,
                            ckpt_dir=a, device=dev)
        check_launches(eng, dict(build.LAUNCHES), cfg, counted)
        if len(done) != 16 or any(r.error is not None for r in done):
            raise AssertionError("serve.run --ckpt-dir: failed requests")
        model = build_model(cfg)
        params = cli._load_params(model, a, 0, dev)
        prompts = _requests(8, 16, 600, cfg.vocab_size, seed=n,
                            shared_len=128, shared_at=(0, 5))
        rec["kernel_plain_delta"] = kernel_plain_delta(
            model, model.quantize(params, QuantPolicy(bits=8, min_size=512)),
            prompts, dev, controls=PAGED_CONTROLS)
        rec["ggml"] = _ggml_lifecycle(dev, model, params,
                                      os.path.join(root, "llama2.rpq8"))
        del params
    torch.cuda.empty_cache()

    l3 = get_config(L3)
    phase(f"phase {n}: launch/train.py run(), {L3} full width and depth "
          f"({l3.n_layers} layers, d_model {l3.d_model}, {l3.compute_dtype} "
          f"compute, {l3.param_dtype} parameters), {L3_TRAIN_STEPS} steps "
          f"of {TRAIN_KW['batch']} x {TRAIN_KW['seq']}")
    n_params = count_params(build_model(l3).init_meta())
    b, s = TRAIN_KW["batch"], TRAIN_KW["seq"]
    # parameters, gradients, m and v in f32, and one CE chunk's f32 logits
    # and their gradient (the chunk is the whole 256-token sequence)
    reckon = (16 * n_params + 2 * 4 * b * s * l3.padded_vocab()) / 1e9
    before = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    losses, recs = _train(dev, arch=L3, steps=L3_TRAIN_STEPS, log_every=1)
    peak = torch.cuda.max_memory_allocated() / 1e9
    if not (np.all(np.isfinite(losses))
            and all(np.isfinite(r["grad_norm"]) for r in recs)):
        raise AssertionError(f"{L3} training: {recs}")
    rec["llama3_2_3b"] = {**_train_stats(recs), "peak_gb": peak,
                          "reckoned_gb": reckon, "params": n_params,
                          "allocated_before_gb": before,
                          "losses": losses, "n_layers": l3.n_layers,
                          "grad_norms": [r["grad_norm"] for r in recs]}
    log(f"  {L3}: {n_params / 1e9:.3f} B parameters, losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}, all finite; median step: "
        f"data {rec['llama3_2_3b']['data_ms']:.1f} ms, card "
        f"{rec['llama3_2_3b']['device_ms']:.1f} ms (synchronized); peak "
        f"{peak:.2f} GB allocated against {reckon:.2f} GB reckoned "
        f"({before:.2f} GB allocated before the run)")
    torch.cuda.empty_cache()
    return rec


# phase 29: llama2-110m at full width and depth, 8 x 256 (train.py's
# shape), through jit_train_step on make_host_mesh() against
# make_train_step, step for step
MESH_TRAIN_STEPS = 10
# phase 32: qwen3-moe-30b-a3b at full width, cut to 2 of its 48 layers
# (~1.5 B parameters), 3 steps through the mesh executor
MOE_TRAIN_LAYERS = 2
MOE_TRAIN_STEPS = 3


def _same_state(a, b) -> list:
    """Paths of the leaves of two states that are not bitwise equal."""
    from repro_torch.core.tree import items, keystr
    return [keystr(p) for (p, x), (_, y) in zip(items(a), items(b))
            if not torch.equal(x, y)]


def train_mesh_path(dev, n=29, arch="llama2-110m", use_reduced=False,
                    batch=8, seq=256, steps_n=MESH_TRAIN_STEPS,
                    layers=None, checkpoint=True):
    """Phase ``n``: training through the mesh executor at a world of one.
    ``launch/steps.py``'s ``jit_train_step`` on ``make_host_mesh()`` (one
    rank: NCCL on the card, gloo on the CPU) and the plain
    ``make_train_step`` each train ``arch`` (llama2-110m at full width and
    depth; ``layers`` cuts the depth) ``steps_n`` steps of ``batch`` x
    ``seq`` from the same seeded parameters over the same batches, with
    the microbatch count the executor picks (``pick_microbatches``), the
    two steps in turns (which goes first alternates): every loss, learning
    rate and gradient norm, and the parameters, both moments and the step
    counter after the last step bitwise equal; each step's ms
    (synchronized) and the peak GB allocated; the last loss below the
    first.  Then, with ``checkpoint``, the mesh run's
    checkpoint (``store.save(mesh=)``) restores in the plain trainer
    bitwise, and one more plain step from it equals one from the plain
    run's own state, bitwise."""
    import gc
    import torch.distributed as dist
    from repro_torch.configs import ShapeCell, get_config, reduced
    from repro_torch.core.tree import leaves
    from repro_torch.data.pipeline import DataConfig, SyntheticTinyStories
    from repro_torch.distribution import sharding as sh
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    t_start = time.perf_counter()
    cfg = get_config(arch)
    if use_reduced:
        cfg = reduced(cfg)
    if layers is not None:
        cfg = cfg.with_(n_layers=layers)
    model = build_model(cfg)
    ocfg = adamw.AdamWConfig(warmup_steps=min(20, steps_n // 5 + 1),
                             decay_steps=steps_n)
    it = SyntheticTinyStories(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, batch_size=batch,
        seed=n)).batches()
    batches = [next(it) for _ in range(steps_n + int(checkpoint))]
    phase(f"phase {n}: jit_train_step on make_host_mesh() against "
          f"make_train_step, {cfg.arch_id} ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}), {steps_n} steps of {batch} x {seq}")
    started = not dist.is_initialized()
    mesh = make_host_mesh(dev)
    try:
        backend = dist.get_backend()
        if backend != ("nccl" if dev.type == "cuda" else "gloo") \
                or mesh.size != 1:
            raise AssertionError(f"the mesh runs {backend} over "
                                 f"{mesh.size} ranks")
        cell = ShapeCell(f"phase{n}", seq, batch, "train")
        mesh_step, sstruct, _, (sspecs, bspecs) = steps.jit_train_step(
            model, mesh, ocfg, cell)
        k = steps.pick_microbatches(cell, mesh, cfg=cfg)
        plain_step = steps.make_train_step(model, ocfg, microbatches=k)

        def fresh():
            p = model.init(0, device=dev)
            return {"params": p, "opt": adamw.init_state(p)}
        # a collection first, so the peak is this phase's (``train.run``
        # frees its state on return: the collect should free ~0 GB)
        held = (torch.cuda.memory_allocated() / 1e9
                if dev.type == "cuda" else 0.0)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        before = (torch.cuda.memory_allocated() / 1e9
                  if dev.type == "cuda" else 0.0)
        plain, on_mesh = fresh(), sh.shard(fresh(), sspecs, mesh)
        ms = {"plain": [], "mesh": []}
        metrics = {"plain": [], "mesh": []}

        def timed(kind, st, bt):
            t0 = time.perf_counter()
            if kind == "mesh":
                st, m = mesh_step(st, steps.shard_batch(bt, bspecs, mesh))
            else:
                st, m = plain_step(st, bt)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            ms[kind].append((time.perf_counter() - t0) * 1e3)
            metrics[kind].append({k_: v.clone() for k_, v in m.items()})
            return st
        for i, bt in enumerate(batches[:steps_n]):
            order = ("plain", "mesh") if i % 2 == 0 else ("mesh", "plain")
            for kind in order:
                if kind == "mesh":
                    on_mesh = timed(kind, on_mesh, bt)
                else:
                    plain = timed(kind, plain, bt)
        peak = (torch.cuda.max_memory_allocated() / 1e9
                if dev.type == "cuda" else 0.0)
        diff = [(i, k_) for i, (a, b) in enumerate(zip(metrics["plain"],
                                                      metrics["mesh"]))
                for k_ in a if not torch.equal(a[k_], b[k_])]
        if diff:
            raise AssertionError(f"mesh step metrics differ from "
                                 f"make_train_step's at {diff}")
        bad = _same_state(plain, on_mesh)
        if bad:
            raise AssertionError(f"after {steps_n} steps the mesh state "
                                 f"differs from make_train_step's: {bad}")
        losses = [float(m["loss"]) for m in metrics["mesh"]]
        if not (np.all(np.isfinite(losses))
                and losses[-1] < losses[0]):
            raise AssertionError(f"phase {n} losses {losses}")
        rec = {"backend": backend, "microbatches": k, "layers": cfg.n_layers,
               "params_b": sum(t.numel() for t in leaves(plain["params"]))
               / 1e9,
               "losses": losses, "peak_gb": peak,
               "allocated_before_gb": before,
               "allocated_before_gc_gb": held,
               "freed_by_gc_gb": held - before,
               "step_ms": {kind: float(np.median(v[1:]))
                           for kind, v in ms.items()},
               "step_ms_all": ms}
        log(f"  {steps_n} steps, {k} microbatches a step: loss "
            f"{losses[0]:.4f} -> {losses[-1]:.4f}; every loss, lr and grad "
            f"norm, and the parameters, m, v and step after step {steps_n} "
            f"bitwise equal to make_train_step's; median step (after the "
            f"first, synchronized, in turns): mesh "
            f"{rec['step_ms']['mesh']:.2f} ms, plain "
            f"{rec['step_ms']['plain']:.2f} ms; peak {peak:.2f} GB allocated "
            f"for both states ({before:.2f} GB before, {held:.2f} GB before "
            f"a gc.collect(): the collect freed {held - before:.2f} GB)")
        if checkpoint:
            _checkpoint_turn(dev, n, model, mesh, sspecs, on_mesh, plain,
                             plain_step, batches[steps_n], steps_n, rec)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
    del plain, on_mesh
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t_start
    return rec


def _checkpoint_turn(dev, n, model, mesh, sspecs, on_mesh, plain,
                     plain_step, extra, steps_n, rec):
    """Phase ``n``'s checkpoint: the mesh state's step-``steps_n``
    checkpoint restored in the plain trainer bitwise, and one more plain
    step from it (on ``extra``) bitwise one from the plain state."""
    import shutil
    import tempfile
    from repro_torch.checkpoint import store
    from repro_torch.optim import adamw
    root = tempfile.mkdtemp(prefix=f"phase{n}_")
    try:
        store.save(root, steps_n, on_mesh, mesh=mesh, specs=sspecs)
        like = {"params": model.init_meta()}
        like["opt"] = adamw.init_state(like["params"])
        back, at, _ = store.restore(root, like, device=dev)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    bad = _same_state(back, plain)
    if at != steps_n or bad:
        raise AssertionError(f"the mesh checkpoint restored at step {at} "
                             f"differs from the plain state: {bad}")
    back, m_back = plain_step(back, extra)
    plain, m_plain = plain_step(plain, extra)
    bad = _same_state(back, plain)
    if bad or not torch.equal(m_back["loss"], m_plain["loss"]):
        raise AssertionError(f"a plain step from the restored checkpoint "
                             f"differs: {bad}")
    rec["checkpoint"] = {"restored_bitwise": True,
                         "next_step_bitwise": True,
                         "next_loss": float(m_back["loss"])}
    log(f"  the mesh run's step-{steps_n} checkpoint restores in the "
        f"plain trainer bitwise; one more plain step from it equals one "
        f"from the plain run's state, bitwise (loss "
        f"{rec['checkpoint']['next_loss']:.4f})")


def train_paths(dev, counted):
    """Phases 27, 29 and 32, training (``train_path``,
    ``train_mesh_path``).
    Alone on the card: ``build.build()``,
    ``qlinear.set_default_strategy("kernel")`` and
    ``torch.backends.cuda.matmul.allow_tf32 = False`` first, as ``main``
    does, then ``train_paths(torch.device("cuda"), {})``; or ``python3
    chip_smoke.py --only train_paths``."""
    rec = train_path(dev, counted, 27)
    phase(f"phase 27: training {json.dumps(rec)}")
    mesh_rec = train_mesh_path(dev)
    phase(f"phase 29: training through jit_train_step "
          f"{json.dumps({k: v for k, v in mesh_rec.items() if k != 'step_ms_all'})}; "
          f"{mesh_rec['seconds']:.1f} s")
    rec["mesh"] = mesh_rec
    moe_rec = train_mesh_path(dev, n=32, arch="qwen3-moe-30b-a3b",
                              steps_n=MOE_TRAIN_STEPS,
                              layers=MOE_TRAIN_LAYERS, checkpoint=False)
    moe_rec["card"] = card_line()
    phase(f"phase 32: MoE training through jit_train_step "
          f"{json.dumps({k: v for k, v in moe_rec.items() if k != 'step_ms_all'})}; "
          f"{moe_rec['seconds']:.1f} s")
    rec["moe_mesh"] = moe_rec
    return rec


def mesh_path(dev, counted, n=28):
    """Phase 28: llama2-110m at full width and depth (Q8_0, phase 3's 16
    requests, 32 greedy tokens each) on ``Engine(mesh=make_serve_mesh(1))``
    -- a world of one, NCCL on the card: the mesh's all-gathers and plan
    broadcast have one rank, the pool is whole, the weights replicated, as
    the reference places them at model size 1 -- against the unsharded
    engine on the same draw, on an f32 and an int8 pool: the streams
    bitwise, the launches equal (and exact, ``check_launches``), the
    metrics that read no clock equal.  Then ``serve.py --mesh 1`` against
    ``serve.py`` (in process, ``run``), the same requests: the streams
    bitwise.  A failed NCCL start, launch or comparison raises."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.models.model import build_model
    t0 = time.perf_counter()
    cfg = get_config("llama2-110m")
    model = build_model(cfg)
    params = model.quantize(model.init(seed=0, device=dev))
    prompts = _requests(16, 16, 600, cfg.vocab_size, seed=0, shared_len=128,
                        shared_at=(0, 9, 12, 15))
    mesh = make_serve_mesh(1, device=dev)
    backend = dist.get_backend()
    if backend != ("nccl" if dev.type == "cuda" else "gloo") \
            or mesh.device.type != dev.type:
        raise AssertionError(f"the mesh runs {backend} on {mesh.device}")
    rec = {"backend": backend, "world": dist.get_world_size(),
           "mesh": dict(mesh.shape)}
    keys = ("tokens_out", "decode_steps", "chunk_batch_calls",
            "prefix_hits", "prefix_cached_tokens", "preemptions",
            "energy_joules", "prefix_attn_bytes")
    for kv in ("float32", "int8"):
        phase(f"phase {n}: llama2-110m full width, {kv} pool, 16 greedy "
              "requests on Engine(mesh=make_serve_mesh(1)) against the "
              "unsharded engine")
        m = build_model(cfg.with_(kv_cache_dtype=kv))
        build.reset_launches()
        eng, want, wall = serve(m, params, prompts, dev, 32, **PAGED_KW)
        plain = dict(build.LAUNCHES)
        build.reset_launches()
        eng_m, got, wall_m = serve(m, params, prompts, dev, 32, mesh=mesh,
                                   **PAGED_KW)
        launches = dict(build.LAUNCHES)
        check_launches(eng_m, launches, cfg, counted)
        if got != want:
            bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
            raise AssertionError(f"mesh streams differ from the unsharded "
                                 f"engine's at requests {bad}")
        if launches != plain:
            raise AssertionError(f"mesh launches {launches} != unsharded "
                                 f"{plain}")
        diff = {k: (eng_m.metrics[k], eng.metrics[k]) for k in keys
                if eng_m.metrics[k] != eng.metrics[k]}
        if diff:
            raise AssertionError(f"mesh metrics differ: {diff}")
        rec[kv] = {"streams_equal": True, "launches_equal": True,
                   "tokens": sum(len(s) for s in got),
                   "unsharded": engine_line(f"unsharded {kv} pool", eng,
                                            want, wall),
                   "mesh_1": engine_line(f"mesh 1 {kv} pool", eng_m, got,
                                         wall_m)}
    phase(f"phase {n}: serve.py --mesh 1 against serve.py, 16 requests at "
          "its own sampling defaults")
    cli = {}
    for size in (0, 1):
        tc = time.perf_counter()
        _, done = serve_cli.run(use_reduced=False, requests=16, slots=8,
                                max_seq=1024, mesh_size=size, device=dev)
        cli[size] = ([[list(o) for o in r.outputs]
                      for r in sorted(done, key=lambda r: r.uid)],
                     time.perf_counter() - tc)
    if cli[0][0] != cli[1][0]:
        raise AssertionError("serve.py --mesh 1 streams differ from "
                             "serve.py's")
    rec["cli"] = {"streams_equal": True,
                  "tokens": sum(len(o[0]) for o in cli[1][0]),
                  "seconds": {"mesh_0": cli[0][1], "mesh_1": cli[1][1]}}
    dist.destroy_process_group()
    rec["seconds"] = time.perf_counter() - t0
    return rec


# phase 30: the serve-side executors on a world of one
SERVE_MESH_STEPS = 32
SERVE_MESH_PREFILL = (8, 512)          # the prefill cell: B x S
SERVE_MESH_DECODE = (8, 1024)          # the decode cell: B x max_seq


def _model_run(prefills=(), decode_steps=0):
    """What ``check_launches`` reads of an engine, for a run of model-level
    steps on the dense cache: one whole-prompt prefill call of S tokens a
    row each for every S of ``prefills``, and ``decode_steps`` decode
    steps."""
    import types
    return types.SimpleNamespace(
        paged=False, plan_log=[{"prefills": [(0, 0, s) for s in prefills]}],
        metrics={"decode_steps": decode_steps, "chunk_batch_calls": 0})


def _timed_launches(fn):
    """(``fn()``, its launches by kernel, its seconds, synchronized)."""
    from repro_torch.kernels import build
    build.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(build.LAUNCHES), time.perf_counter() - t0


def _add(total, launches):
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def serve_mesh_path(dev, counted, n=30):
    """Phase ``n``: the serve-side executors of ``launch/steps.py`` on
    ``make_host_mesh()``, a world of one over NCCL started here and ended
    before returning (phase 28 ends its own), at llama2-110m's full width
    and depth with Q8_0 weights, on an f32 and an int8 dense cache.
    ``jit_prefill_step`` on a prefill cell of 8 x 512 (phase 3's first 8
    prompts, each repeated to 512 tokens) against ``make_prefill_step``:
    the logits and the cache bitwise.  ``jit_serve_step``, 32 greedy steps
    on a decode cell of 8 x 1024 from ``Model.prefill(max_seq=1024)`` of
    the same 8 prompts zero-padded to one length, against
    ``make_serve_step`` on the same cache: the logits and the cache
    bitwise at every step.  ``jit_serve_sample_step``, 32 steps from the
    same cache with fixed threefry keys, each step's tokens fed back,
    against ``make_serve_sample_step``: the tokens and the cache bitwise
    at every step.  Each executor's launches equal the plain step's and
    are exact (``check_launches``; counted for the kernels line once, the
    executors' runs).  A failed NCCL start, launch or comparison raises."""
    import torch.distributed as dist
    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.core import prng
    from repro_torch.distribution import sharding as sh
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import build_model
    t0 = time.perf_counter()
    cfg = get_config("llama2-110m")
    params = build_model(cfg).quantize(build_model(cfg).init(seed=0,
                                                             device=dev))
    prompts = _requests(16, 16, 600, cfg.vocab_size, seed=0, shared_len=128,
                        shared_at=(0, 9, 12, 15))[:SERVE_MESH_DECODE[0]]
    b, s = SERVE_MESH_PREFILL
    pre_batch = {"tokens": torch.from_numpy(
        np.stack([np.resize(p, s) for p in prompts]))}
    width = max(len(p) for p in prompts)
    dec_batch = {"tokens": torch.from_numpy(np.stack(
        [np.pad(p, (0, width - len(p))) for p in prompts]))}
    pcell = ShapeCell("prefill", s, b, "prefill")
    dcell = ShapeCell("decode", SERVE_MESH_DECODE[1], SERVE_MESH_DECODE[0],
                      "decode")
    mesh = make_host_mesh(device=dev)
    backend = dist.get_backend()
    if backend != ("nccl" if dev.type == "cuda" else "gloo"):
        raise AssertionError(f"the mesh runs {backend} on {mesh.device}")
    rec = {"backend": backend, "world": dist.get_world_size(),
           "mesh": dict(mesh.shape), "prefill_cell": [b, s],
           "decode_cell": list(SERVE_MESH_DECODE),
           "steps": SERVE_MESH_STEPS}
    for kv in ("float32", "int8"):
        phase(f"phase {n}: llama2-110m full width, Q8_0, {kv} dense cache: "
              f"jit_prefill_step ({b} x {s}), jit_serve_step and "
              f"jit_serve_sample_step ({SERVE_MESH_STEPS} steps at "
              f"{dcell.global_batch} x {dcell.seq_len}) on make_host_mesh()"
              " against the plain steps")
        model = build_model(cfg.with_(kv_cache_dtype=kv))
        pre = steps.jit_prefill_step(model, mesh, pcell)[0]
        serve = steps.jit_serve_step(model, mesh, dcell)[0]
        sample = steps.jit_serve_sample_step(model, mesh, dcell)[0]
        sp_p = steps.serve_specs(model, mesh, pcell)
        sp_d = steps.serve_specs(model, mesh, dcell)
        sp_s = steps.serve_specs(model, mesh, dcell, sample=True)
        shards = sh.shard(params, sp_p.params, mesh)
        part = {}

        (lg_m, c_m), l_m, t_m = _timed_launches(lambda: pre(
            shards, steps.shard_batch(pre_batch, sp_p.batch, mesh)))
        (lg_p, c_p), l_p, t_p = _timed_launches(
            lambda: steps.make_prefill_step(model, s)(params, pre_batch))
        if not (torch.equal(sh.gather(lg_m, sp_p.logits, mesh), lg_p)
                and not _same_state(sh.gather_tree(c_m, sp_p.cache, mesh),
                                    c_p)):
            raise AssertionError(f"jit_prefill_step ({kv}) differs from "
                                 "make_prefill_step")
        if l_m != l_p:
            raise AssertionError(f"jit_prefill_step launches {l_m} != "
                                 f"make_prefill_step's {l_p}")
        launched = dict(l_m)
        part["prefill"] = {"seconds": t_m, "plain_seconds": t_p}
        del lg_m, c_m, lg_p, c_p

        first, start = model.prefill(params, dec_batch,
                                     max_seq=dcell.seq_len)
        for name, step, plain, sp in (
                ("serve", serve, steps.make_serve_step(model), sp_d),
                ("sample", sample, steps.make_serve_sample_step(model),
                 sp_s)):
            c_m = sh.shard(_clone_tree(start), sp_d.cache, mesh)
            c_p = _clone_tree(start)
            tok = torch.argmax(first, -1).int()
            lm, lp, tm, tp = {}, {}, 0.0, 0.0
            for i in range(SERVE_MESH_STEPS):
                extra = () if name == "serve" else (prng.prng_key(1000 + i),)
                (o_m, c_m), got, dt = _timed_launches(lambda: step(
                    shards, c_m, sh.shard(tok, sp.tokens, mesh), *extra))
                _add(lm, got)
                tm += dt
                (o_p, c_p), got, dt = _timed_launches(
                    lambda: plain(params, c_p, tok, *extra))
                _add(lp, got)
                tp += dt
                spec = sp_d.logits if name == "serve" else sp.tokens
                if not (torch.equal(sh.gather(o_m, spec, mesh), o_p)
                        and not _same_state(
                            sh.gather_tree(c_m, sp_d.cache, mesh), c_p)):
                    raise AssertionError(
                        f"jit_{name}_step ({kv}) differs from the plain "
                        f"step at step {i}")
                tok = (torch.argmax(o_p, -1) if name == "serve"
                       else o_p).int()
            if lm != lp:
                raise AssertionError(f"jit_{name}_step launches {lm} != the "
                                     f"plain step's {lp}")
            _add(launched, lm)
            part[name] = {"seconds": tm, "plain_seconds": tp,
                          "ms_per_step": tm / SERVE_MESH_STEPS * 1e3,
                          "plain_ms_per_step": tp / SERVE_MESH_STEPS * 1e3}
            del c_m, c_p
        del start, first
        # the three executors' launches: one prefill call, then both
        # decode loops' steps
        check_launches(_model_run(prefills=[s],
                                  decode_steps=2 * SERVE_MESH_STEPS),
                       launched, cfg, counted)
        rec[kv] = {"bitwise": True, "launches_equal": True,
                   "launches": {k: v for k, v in launched.items() if v},
                   **part}
        log(f"  {kv} cache: logits, caches and tokens bitwise at every "
            f"step; launches equal; prefill {part['prefill']['seconds']:.3f}"
            f" s (plain {part['prefill']['plain_seconds']:.3f}); decode "
            f"{part['serve']['ms_per_step']:.2f} ms/step (plain "
            f"{part['serve']['plain_ms_per_step']:.2f}); sampled "
            f"{part['sample']['ms_per_step']:.2f} ms/step (plain "
            f"{part['sample']['plain_ms_per_step']:.2f})")
        torch.cuda.empty_cache()
    dist.destroy_process_group()
    rec["seconds"] = time.perf_counter() - t0
    return rec


def mesh_paths(dev, counted):
    """Phases 28 and 30, the mesh (``mesh_path``, ``serve_mesh_path``).
    Alone on the card: ``python3 chip_smoke.py --only mesh_paths``, or
    ``build.build()`` and ``qlinear.set_default_strategy("kernel")`` first,
    as ``main`` does, then the checks of ``PHASE2["mesh_paths"]`` and
    ``mesh_paths(dev, {})``."""
    rec = mesh_path(dev, counted, 28)
    phase(f"phase 28: mesh {json.dumps(rec)}; {rec['seconds']:.1f} s")
    rec30 = serve_mesh_path(dev, counted, 30)
    phase(f"phase 30: serve-side executors {json.dumps(rec30)}; "
          f"{rec30['seconds']:.1f} s")
    return rec, rec30


# phase 31: the analysis tools -- the real steps against their dry run,
# and the dry-run CLI
ANALYSIS_ITERS = 10
ANALYSIS_CLI = (("--arch", "llama3.2-3b", "--shape", "decode_32k"),
                ("--arch", "qwen3-moe-30b-a3b", "--shape", "prefill_32k",
                 "--multi-pod", "multi"))


def _event_ms(fn, iters: int = ANALYSIS_ITERS) -> float:
    """Median of ``iters`` timings of ``fn()`` by CUDA events, after one
    warm-up call."""
    fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _analysis_cells():
    from repro_torch.configs import ShapeCell
    b, s = SERVE_MESH_PREFILL
    return (ShapeCell("prefill", s, b, "prefill"),
            ShapeCell("decode", SERVE_MESH_DECODE[1], SERVE_MESH_DECODE[0],
                      "decode"))


def _dry_records(model, cells):
    """Each cell's dry-run record on ``make_host_mesh()`` of a fake world
    of one (meta tensors, started and ended here)."""
    import torch.distributed as dist
    from repro_torch.launch import dryrun, mesh as meshlib
    meshlib.dryrun_world(1)
    try:
        mesh = meshlib.make_host_mesh()
        if mesh.device.type != "meta":
            raise AssertionError(f"a fake world's mesh on {mesh.device}")
        out = {}
        for cell in cells:
            lowered, flops_fn, pstruct, cstruct = dryrun.lower(model, mesh,
                                                               cell)
            out[cell.kind] = dryrun.analyse(lowered, flops_fn, model.cfg,
                                            cell, pstruct, cstruct, 1, 1,
                                            mesh=mesh)
    finally:
        dist.destroy_process_group()
    return out


def analysis_path(dev, n=31):
    """Phase ``n``: the analysis tools on the card.  (a) llama2-110m at
    full width and depth, Q8_0 and an f32 dense cache, phase 30's two
    cells (a prefill of 8 x 512 and a decode step at 8 x 1024) on
    ``make_host_mesh()``, a world of one over NCCL: each real step runs
    on the kernels under ``flops.Counter``, whose count must equal the
    meta dry run's count of the same step (``dryrun.analyse`` in a fake
    world of one) exactly -- every kernel wrapper's report on the card
    against its meta branch's; the collective tally must be empty and the
    real shards' bytes the dry run's ``argument_bytes``.  The measured
    step (CUDA events, median of 10) is printed beside the record's
    estimates at the card's data-sheet constants, and the growth of
    ``max_memory_allocated`` over the step beside ``temp_bytes``.  (b) the
    dry-run CLI in two subprocesses at full size (``ANALYSIS_CLI``): each
    must exit 0 and write a record with the reference's keys."""
    import tempfile
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.distribution import collectives as C
    from repro_torch.distribution import sharding as sh
    from repro_torch.kernels import build
    from repro_torch.launch import dryrun, flops, steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import build_model
    t0 = time.perf_counter()
    phase(f"phase {n}: analysis tools: llama2-110m full width, Q8_0, f32 "
          "dense cache, prefill and decode on make_host_mesh() against "
          "their meta dry run; the dry-run CLI at full size")
    out_dir = Path(tempfile.mkdtemp(prefix="dryrun_"))
    env = dict(os.environ, PYTHONPATH=str(SRC))
    clis = [(args, subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args, "--out",
         str(out_dir)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)) for args in ANALYSIS_CLI]
    cfg = get_config("llama2-110m").with_(kv_cache_dtype="float32")
    model = build_model(cfg)
    cells = _analysis_cells()
    dry = _dry_records(model, cells)
    params = model.quantize(model.init(seed=0, device=dev))
    mesh = make_host_mesh(device=dev)
    rec = {"backend": dist.get_backend(), "world": dist.get_world_size()}
    prompts = _requests(16, 16, 600, cfg.vocab_size, seed=0)
    try:
        for cell in cells:
            sp = steps.serve_specs(model, mesh, cell)
            shards = sh.shard(params, sp.params, mesh)
            b, s = cell.global_batch, cell.seq_len
            if cell.kind == "prefill":
                batch = {"tokens": torch.from_numpy(np.stack(
                    [np.resize(p, s) for p in prompts[:b]]))}
                step = steps.jit_prefill_step(model, mesh, cell)[0]
                args = (shards, steps.shard_batch(batch, sp.batch, mesh))
            else:
                start = {"tokens": torch.from_numpy(np.stack(
                    [np.resize(p, 64) for p in prompts[:b]]))}
                _, cache = model.prefill(params, start, max_seq=s)
                step = steps.jit_serve_step(model, mesh, cell)[0]
                tok = torch.arange(b, dtype=torch.int32) + 5
                args = (shards, sh.shard(cache, sp.cache, mesh),
                        sh.shard(tok, sp.tokens, mesh))
            d = dry[cell.kind]
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            build.reset_launches()
            with flops.Counter() as counter, C.tally() as calls:
                out = step(*args)
            torch.cuda.synchronize()
            growth = torch.cuda.max_memory_allocated() - base
            launched = {k: v for k, v in build.LAUNCHES.items() if v}
            del out
            if counter.flops != d["flops_dev_executed"]:
                raise AssertionError(
                    f"{cell.kind}: the card's count {counter.flops} != the "
                    f"meta dry run's {d['flops_dev_executed']}")
            if calls:
                raise AssertionError(f"{cell.kind}: a world of one called "
                                     f"collectives {calls}")
            arg_bytes = dryrun.tensor_bytes(args)
            if arg_bytes != d["memory_analysis"]["argument_bytes"]:
                raise AssertionError(
                    f"{cell.kind}: real shards hold {arg_bytes} bytes, the "
                    f"dry run {d['memory_analysis']['argument_bytes']}")
            if not launched:
                raise AssertionError(f"{cell.kind}: no kernel launched")
            ms = _event_ms(lambda: step(*args))
            rec[cell.kind] = {
                "cell": [b, s], "flops": counter.flops,
                "flops_equal": True, "tally_empty": True,
                "argument_bytes": arg_bytes, "launches": launched,
                "step_ms": ms, "est_step_time_s": d["est_step_time_s"],
                "t_memory_s": d["t_memory_s"],
                "t_compute_s": d["t_compute_s"], "dominant": d["dominant"],
                "max_memory_growth_bytes": growth,
                "temp_bytes": d["memory_analysis"]["temp_bytes"]}
            log(f"  {cell.kind} {b} x {s}: count {counter.flops:.6g} equals "
                f"the dry run's; tally empty; argument bytes {arg_bytes} "
                f"exact; measured {ms:.3f} ms (median of "
                f"{ANALYSIS_ITERS}) against est_step_time_s "
                f"{d['est_step_time_s'] * 1e3:.3f} ms (t_memory "
                f"{d['t_memory_s'] * 1e3:.3f} ms, t_compute "
                f"{d['t_compute_s'] * 1e3:.3f} ms, estimates at the data "
                f"sheet's constants); max_memory_allocated grew "
                f"{growth} bytes against temp_bytes "
                f"{d['memory_analysis']['temp_bytes']}")
            del args, shards
    finally:
        dist.destroy_process_group()
    del params
    torch.cuda.empty_cache()
    want = {"arch", "shape", "devices", "bw_fraction", "algo_flops_global",
            "model_flops_global", "useful_flop_ratio", "t_compute_s",
            "t_memory_s", "t_collective_s", "dominant", "est_step_time_s",
            "roofline_fraction", "mem_breakdown", "collective_bytes_dev",
            "raw_cost_analysis", "collective_breakdown",
            "param_bytes_global", "cache_bytes_global", "microbatches",
            "memory_analysis", "compile_s", "multi_pod",
            "flops_dev_executed", "t_compute_executed_s"}
    rec["cli"] = {}
    for args, proc in clis:
        stdout, err = proc.communicate(timeout=300)
        if proc.returncode != 0:
            raise AssertionError(f"dryrun {' '.join(args)} exited "
                                 f"{proc.returncode}: {err[-2000:]}")
        pod = "2pod" if "multi" in args else "1pod"
        r = json.loads((out_dir / f"{args[1]}__{args[3]}__{pod}.json")
                       .read_text())
        missing = want - set(r)
        if missing:
            raise AssertionError(f"dryrun {' '.join(args)}: record lacks "
                                 f"{sorted(missing)}")
        ratio = r["flops_dev_executed"] / (r["algo_flops_global"]
                                           / r["devices"])
        rec["cli"][f"{args[1]} {args[3]} {pod}"] = {
            "dominant": r["dominant"],
            "roofline_fraction": r["roofline_fraction"],
            "executed_over_global_per_dev": ratio,
            "trace_s": r["compile_s"]}
        log(f"  dryrun {' '.join(args)}: dominant {r['dominant']}, "
            f"roofline_fraction {r['roofline_fraction']:.4g}, "
            f"flops_dev_executed / (algo_flops_global / n_dev) "
            f"{ratio:.4g} (estimates at the data sheet's constants)")
    rec["seconds"] = time.perf_counter() - t0
    return rec


def analysis_paths(dev, counted):
    """Phase 31, the analysis tools (``analysis_path``).  Alone on the
    card: ``python3 chip_smoke.py --only analysis_paths``, or
    ``build.build()`` and ``qlinear.set_default_strategy("kernel")``
    first, then ``analysis_paths(dev, {})``.  Its launches run under the
    counter and are its own: ``counted`` is left as it is."""
    rec = analysis_path(dev, 31)
    phase(f"phase 31: analysis tools {json.dumps(rec)}; "
          f"{rec['seconds']:.1f} s")
    return rec


def closed_batch_turn(dev, runs: int = 4):
    """Phase 3's closed batch (16 greedy requests, paged f32 pool, Q8_0,
    kernel strategy) served ``runs`` times on the tree this script is run
    from; prints each run's tok/s, decode step and chunk step.  For turns
    against a parent tree: copy this script over the parent's own and call
    it from each tree in turn (parent, change, change, parent)."""
    from repro_torch.configs import get_config
    from repro_torch.core import qlinear
    from repro_torch.kernels import build
    from repro_torch.models.model import build_model
    build.build()
    qlinear.set_default_strategy("kernel")
    cfg = get_config("llama2-110m")
    model = build_model(cfg)
    params = model.quantize(model.init(seed=0, device=dev))
    prompts = _requests(16, 16, 600, cfg.vocab_size, seed=0, shared_len=128,
                        shared_at=(0, 9, 12, 15))
    for i in range(runs):
        eng, streams, wall = serve(model, params, prompts, dev, 32,
                                   **PAGED_KW)
        engine_line(f"run {i}", eng, streams, wall)


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


# The groups of phases ``--only`` selects (all by default, in this order):
# each with the phase-2 checks of the shapes its paths serve
GROUPS = ("phase2", "main_path", "bf16_paths", "ssm_paths",
          "vlm_audio_paths", "interleave_paths", "train_paths",
          "mesh_paths", "analysis_paths")
PHASE2 = {"main_path": ("check_q8_matvec", "check_q8_matmul",
                        "check_attention", "check_q4",
                        "check_dense_attention", "check_flash_prefill",
                        "check_rope", "check_rmsnorm_quant",
                        "check_verify_edges"),
          "bf16_paths": ("check_llama3", "check_llama3_dense_q4",
                         "check_phi4_head", "check_glm4", "check_command_r",
                         "check_qwen3_moe"),
          "ssm_paths": ("check_mamba2", "check_zamba2"),
          "vlm_audio_paths": ("check_qwen2_vl", "check_whisper"),
          "interleave_paths": ("check_llama4",),
          "train_paths": ("check_q8_matvec", "check_q8_matmul",
                          "check_attention", "check_rope",
                          "check_rmsnorm_quant"),
          "mesh_paths": ("check_q8_matvec", "check_q8_matmul",
                         "check_attention", "check_dense_attention",
                         "check_flash_prefill", "check_rope",
                         "check_rmsnorm_quant", "check_head_slices")}


def parse_groups(argv):
    """``--only a,b`` -> the selected groups of ``GROUPS``, in its order;
    no argument selects every group.  ``phase2`` alone runs every phase-2
    check and no path."""
    import argparse
    ap = argparse.ArgumentParser(
        description="Smoke test of the port on one NVIDIA card.")
    ap.add_argument("--only", default=",".join(GROUPS),
                    help="comma-separated groups of phases: "
                         + ", ".join(GROUPS))
    only = {g for g in ap.parse_args(argv).only.split(",") if g}
    bad = only - set(GROUPS)
    if bad or not only:
        ap.error(f"--only takes groups of {GROUPS}, got {sorted(bad)}")
    return [g for g in GROUPS if g in only]


def main(argv=None) -> int:
    groups = parse_groups(argv)
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
        f"{torch.version.cuda}; groups {', '.join(groups)}")
    secs = build.build()
    phase(f"phase 1: built {len(build.SIGNATURES)} kernels from "
          f"{len(build.SOURCES)} sources in {secs:.1f} s")
    for name in build.SOURCES:
        tail = (build.BUILD_DIR / f"{name}.log")
        if tail.exists():
            for line in tail.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  {name}: {line.strip()}")

    from repro_torch.core import qlinear
    qlinear.set_default_strategy("kernel")
    report = Report()
    phase("phase 2: kernels against their plain versions")
    ran = set()
    for group, checks in PHASE2.items():
        if "phase2" in groups or group in groups:
            for check in checks:
                if check not in ran:       # a check two groups share: once
                    ran.add(check)
                    globals()[check](report, dev)

    counted = {}
    if "main_path" in groups:
        cfg, params, prompts, paged, e2e, e2e_int8 = main_path(dev, counted)
        reduced_cpu_vs_card(dev)
        reduced_cpu_vs_card(dev, L3)
        phase(f"phase 6: end to end (f32 pool) {json.dumps(e2e)}; int8 pool "
              f"{json.dumps(e2e_int8)}")
        dense = dense_path(dev, cfg, params, prompts, paged, counted)
        model, p4, q4 = q4_path(dev, cfg, prompts, params, counted)
        b1 = single_stream(dev, model, {"Q8_0": params, "Q4_0": p4})
        phase(f"phase 10: dense cache {json.dumps(dense)}; Q4_0 "
              f"{json.dumps(q4)}; batch 1 {json.dumps(b1)}")
        cli = serve_cli(dev, cfg, counted)
        fanouts, sampler = best_of_n(dev, cfg, params, counted)
        phase(f"phase 12: serve CLI {json.dumps(cli)}; best-of-4 fanouts "
              f"{fanouts}; sampler {json.dumps(sampler)}")
        ol = open_loop(dev, cfg, params, counted, e2e)
        phase(f"phase 13: open loop {json.dumps(ol)}")
        spec = speculation(dev, cfg, params, prompts, counted)
        phase(f"phase 14: speculation {json.dumps(spec)}")
        faults = fault_domain(dev, cfg, params, counted)
        phase(f"phase 15: faults {json.dumps(faults)}")
        del params, p4
        torch.cuda.empty_cache()
    if "bf16_paths" in groups:
        bf16_paths(dev, counted)
    if "ssm_paths" in groups:
        ssm_paths(dev, counted)
    if "vlm_audio_paths" in groups:
        vlm_audio_paths(dev, counted)
    if "interleave_paths" in groups:
        interleave_paths(dev, counted)
    if "train_paths" in groups:
        train_paths(dev, counted)
    if "mesh_paths" in groups:
        mesh_paths(dev, counted)
    if "analysis_paths" in groups:
        analysis_paths(dev, counted)
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
