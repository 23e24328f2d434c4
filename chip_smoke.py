"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's four CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each against its plain PyTorch version at the shapes the llama2-110m
main path gives it (f32 and int8 KV pools), serves llama2-110m at full width
through ``repro_torch.serving.engine.Engine`` on the card, and checks the
reduced config on the card against the same weights on the CPU.  Any failed
phase exits non-zero.  The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it lists every kernel
with its launches on the main path, its error and its times.

It imports nothing of JAX or of the JAX package.  With no CUDA device, or
without the rest of the repository beside it, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import json
import math
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


def log(msg: str) -> None:
    print(msg, flush=True)


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


def check_q8(report, dev):
    from repro_torch.core.quantization import quantize
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev).manual_seed(0)

    def operands(m, n, k):
        x = torch.randn((m, k), generator=gen, device=dev)
        w = torch.randn((n, k), generator=gen, device=dev) / math.sqrt(k)
        xt, wt = quantize(x, 64), quantize(w, 64)
        return xt.q, xt.scale, wt.q, wt.scale

    def one(kernel, name, m, n, k):
        xq, xs, wq, ws = operands(m, n, k)
        got = kernel(xq, xs, wq, ws, 64)
        want = ref.ref_q8_matmul(xq, xs, wq, ws, 64)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        # the same exact per-group products; only the f32 sum over the
        # K/64 groups runs in another order
        tol = 2e-5 * max(1.0, want.abs().max().item())
        if not err <= tol:
            raise AssertionError(f"{name} M={m} N={n} K={k}: max abs err "
                                 f"{err:.3g} > tol {tol:.3g}")
        g = k // 64
        nb = m * k + 4 * m * g + n * k + 4 * n * g + 4 * m * n
        b_ms, b_by = bound(nb, 2.0 * m * n * k, INT8_OPS_PER_S)
        nxt = rotating(lambda: operands(m, n, k), n * k + 4 * n * g)
        ms = time_ms(lambda: kernel(*nxt(), 64))
        plain = time_ms(lambda: ref.ref_q8_matmul(*nxt(), 64), iters=5)
        xf = (xq.float().reshape(m, g, 64) * xs[..., None]).reshape(m, k)
        wfs = rotating(lambda: torch.randn((n, k), device=dev),
                       4 * n * k)
        lib = time_ms(lambda: torch.matmul(xf, wfs().T))
        log(f"  {name:10s} M={m:5d} N={n:6d} K={k:5d}  err {err:.2e} "
            f"(tol {tol:.1e})  kernel {ms:.4f} ms  plain {plain:.4f} ms  "
            f"torch.matmul {lib:.4f} ms  bound {b_ms:.4f} ms ({b_by})")
        return err, ms, plain, lib, b_ms, b_by

    # decode step: per layer wqkv, wo_f, w13, w2; then the head (M = slots)
    layer = [(2304, 768), (768, 768), (4096, 768), (768, 2048)]
    head = (32000, 768)
    step = {"err": 0.0, "ms": 0.0, "plain": 0.0, "lib": 0.0, "bound": 0.0}
    for m in (1, 8):
        for n, k in layer + [head]:
            err, ms, plain, lib, b_ms, _ = one(ops.q8_matvec_kernel,
                                               "q8_matvec", m, n, k)
            step["err"] = max(step["err"], err)
            if m == 8:
                w = 12 if (n, k) != head else 1
                for key, v in (("ms", ms), ("plain", plain), ("lib", lib),
                               ("bound", b_ms)):
                    step[key] += w * v
    log(f"  q8_matvec per decode step (12 layers x 4 + head, M=8): kernel "
        f"{step['ms']:.4f} ms, bound {step['bound']:.4f} ms")
    report.add("q8_matvec", route="cuda",
               source="src/repro_torch/kernels/csrc/q8_matvec.cu",
               replaces="src/repro/kernels/q8_matvec.py:67",
               max_abs_err=step["err"], ms=step["ms"],
               plain_ms=step["plain"], bound_ms=step["bound"],
               bound_by="bytes", library_ms=step["lib"],
               per="decode step at 8 slots: 48 layer GEMVs + head")

    chunk = {"err": 0.0, "ms": 0.0, "plain": 0.0, "lib": 0.0, "bound": 0.0}
    for n, k in [(4096, 768), (768, 2048)]:
        err, ms, plain, lib, b_ms, b_by = one(ops.q8_matmul_kernel,
                                              "q8_matmul", 8 * 256, n, k)
        chunk["err"] = max(chunk["err"], err)
        for key, v in (("ms", ms), ("plain", plain), ("lib", lib),
                       ("bound", b_ms)):
            chunk[key] += 12 * v
    report.add("q8_matmul", route="cuda",
               source="src/repro_torch/kernels/csrc/q8_matmul.cu",
               replaces="src/repro/kernels/q8_matmul.py:92",
               max_abs_err=chunk["err"], ms=chunk["ms"],
               plain_ms=chunk["plain"], bound_ms=chunk["bound"],
               bound_by=b_by, library_ms=chunk["lib"],
               per="chunk step at 8 x 256 rows: 12 layers x (w13, w2)")


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
# phases 3-5: the main path through the Engine
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


def serve(model, params, prompts, dev, max_new, **engine_kw):
    from repro_torch.serving.engine import Engine
    eng = Engine(model, params, device=dev, **engine_kw)
    for p in prompts:
        eng.submit(p, max_new_tokens=max_new, temperature=0.0)
    t0 = time.perf_counter()
    done = sorted(eng.run(), key=lambda r: r.uid)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    bad = [(r.uid, r.error) for r in done if r.error is not None]
    if bad or len(done) != len(prompts):
        raise AssertionError(f"requests failed: {bad}")
    return eng, [list(r.output) for r in done], wall


def engine_line(tag, eng, streams, wall):
    m = eng.metrics
    toks = sum(len(s) for s in streams)
    dec = m["t_decode"] / max(1, m["decode_steps"]) * 1e3
    chunk = m["t_prefill"] / max(1, m["chunk_batch_calls"]) * 1e3
    log(f"  {tag}: {len(streams)} requests, {toks} tokens in {wall:.3f} s "
        f"= {toks / wall:.1f} tok/s; {m['decode_steps']} decode steps "
        f"{dec:.3f} ms each; {m['chunk_batch_calls']} chunk steps "
        f"{chunk:.3f} ms each; prefix hits {m['prefix_hits']} "
        f"({m['prefix_cached_tokens']} tokens); preemptions "
        f"{m['preemptions']}")
    return {"tok_s": toks / wall, "decode_step_ms": dec,
            "chunk_step_ms": chunk}


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
    log(f"  profiler: card busy {busy:.3f} s of {wall:.3f} s wall "
        f"({100 * busy / wall:.1f}%); top kernels by device time:")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"    {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:6d}  "
            f"{e.key[:90]}")
    return out, busy / wall


def check_launches(eng, launches, cfg):
    """Every kernel ran, and exactly as often as the path's shape says:
    per decode step 4 GEMVs per layer + the head and one attention call per
    layer; per chunk step the MLP's two GEMMs per layer, the head's GEMV and
    one prefix-attention call per layer."""
    nl = cfg.n_layers
    d, c = eng.metrics["decode_steps"], eng.metrics["chunk_batch_calls"]
    want = {"q8_matvec": (4 * nl + 1) * d + c, "q8_matmul": 2 * nl * c,
            "paged_decode_attention": nl * d,
            "paged_prefill_attention": nl * c}
    if launches != want or min(launches.values()) <= 0:
        raise AssertionError(f"launches {launches} != expected {want}")
    log(f"  launches {launches}: {4 * nl + 1} q8_matvec and {nl} "
        f"paged_decode_attention per decode step over {d} steps")


def main_path(dev):
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models.model import build_model
    cfg = get_config("llama2-110m")
    model = build_model(cfg)
    params = model.quantize(model.init(seed=0, device=dev))
    kw = dict(max_slots=8, max_seq=1024, page_size=64,
              prefill_chunk_tokens=256)
    prompts = _requests(16, 16, 600, cfg.vocab_size, seed=0, shared_len=128,
                        shared_at=(0, 9, 12, 15))
    log("phase 3: llama2-110m full width, f32 KV pool, 16 greedy requests")
    build.reset_launches()
    eng, streams, wall = serve(model, params, prompts, dev, 32, **kw)
    launches = dict(build.LAUNCHES)
    check_launches(eng, launches, cfg)
    if eng.metrics["prefix_hits"] < 1:
        raise AssertionError("the shared-prefix requests never hit the "
                             "prefix cache")
    e2e = engine_line("kernel strategy", eng, streams, wall)
    again, e2e["device_busy_share"] = profiled(
        lambda: serve(model, params, prompts, dev, 32, **kw)[1])
    if again != streams:
        raise AssertionError("a second run gave different greedy streams")
    log("  second run (profiled): identical streams")

    log("phase 4: llama2-110m full width, int8 KV pool, 8 greedy requests")
    m8 = build_model(cfg.with_(kv_cache_dtype="int8"))
    build.reset_launches()
    eng8, s8, wall8 = serve(m8, params, prompts[:8], dev, 32, **kw)
    check_launches(eng8, dict(build.LAUNCHES), cfg)
    e2e_int8 = engine_line("kernel strategy, int8 pool", eng8, s8, wall8)
    return launches, e2e, e2e_int8


def reduced_cpu_vs_card(dev):
    """The reduced config with the same weights: plain versions on the CPU
    against the kernels on the card.  Logits may differ by the ~3e-2 an
    int8 activation code flipped by a last-place difference moves them (the
    CPU tests measure this); streams may part only at a step whose top-2
    gap is below that."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.model import build_model, params_to
    tol = 3e-2
    cfg = reduced(get_config("llama2-110m"))
    model = build_model(cfg)
    p_cpu = model.quantize(model.init(seed=0, device="cpu"))
    p_dev = params_to(p_cpu, dev)
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

    diff = (first_logits(p_cpu, torch.device("cpu"))
            - first_logits(p_dev, dev)).abs().max().item()
    log(f"phase 5: reduced config, CPU plain vs card kernels: first chunk "
        f"step logits max |diff| {diff:.3g} (tol {tol})")
    if not diff <= tol:
        raise AssertionError(f"first-step logits differ by {diff}")
    _, cpu_streams, _ = serve(model, p_cpu, prompts, torch.device("cpu"), 8,
                              **kw)
    _, dev_streams, _ = serve(model, p_dev, prompts, dev, 8, **kw)
    for i, (a, b) in enumerate(zip(cpu_streams, dev_streams)):
        part = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                    None)
        if part is None:
            continue
        seq = np.concatenate([prompts[i], np.asarray(a[:part], np.int32)])
        gap = _top2_gap(model, p_cpu, seq)
        log(f"  request {i}: streams part at token {part}, top-2 gap "
            f"{gap:.3g}")
        if not gap < tol:
            raise AssertionError(f"request {i} parts at token {part} with "
                                 f"top-2 gap {gap} >= {tol}")
    same = sum(a == b for a, b in zip(cpu_streams, dev_streams))
    log(f"  greedy streams: {same}/{len(prompts)} equal; any parting is at "
        "a near-tie")


def _top2_gap(model, params, seq):
    n = len(seq)
    nb = -(-n // 16)
    cache = model.init_paged_cache(1, block_size=16, n_blocks=nb,
                                   max_blocks_per_seq=nb, device="cpu")
    cache["page_table"] = torch.arange(nb, dtype=torch.int32)[None]
    logits, _ = model.prefill_chunk_batch(params, seq[None], cache, [0],
                                          [0], chunk_lens=[n])
    top = torch.topk(logits[0], 2).values
    return float(top[0] - top[1])


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
    log(f"phase 1: built {len(build.SIGNATURES)} kernels in {secs:.1f} s")
    for name in build.SIGNATURES:
        tail = (build.BUILD_DIR / f"{name}.log")
        if tail.exists():
            for line in tail.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  {name}: {line.strip()}")

    from repro_torch.core import qlinear
    qlinear.set_default_strategy("kernel")
    report = Report()
    log("phase 2: kernels against their plain versions")
    check_q8(report, dev)
    check_attention(report, dev)

    launches, e2e, e2e_int8 = main_path(dev)
    reduced_cpu_vs_card(dev)

    log(f"phase 6: end to end (f32 pool) {json.dumps(e2e)}; int8 pool "
        f"{json.dumps(e2e_int8)}")
    kernels = []
    for name, row in report.rows.items():
        kernels.append({"name": name, **row,
                        "launches": launches.get(name, 0)})
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
