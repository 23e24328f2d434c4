"""Serving entry point: quantize a fresh or trained model per the paper's
PTQ flow and serve it with the continuous-batching engine: a closed batch
by default, or an open-loop stream of seeded Poisson arrivals with
per-step token streaming (``--open-loop``).

PyTorch counterpart of ``repro/launch/serve.py``, on the card unless
``--device cpu`` is given:

  # llama2-110m at full width on one card
  PYTHONPATH=src python -m repro_torch.launch.serve --full --requests 16 \\
      --slots 8 --max-seq 1024

  # the same open loop: arrivals at 0.85 of the capacity a closed
  # calibration pass measures; goodput and TTFT / TPOT from true arrival
  PYTHONPATH=src python -m repro_torch.launch.serve --full --requests 16 \\
      --slots 8 --max-seq 1024 --open-loop

  # llama3.2-3b (GQA 24/8, head_dim 128, bf16 compute and KV pool) at
  # full width; --kv-int8 for the int8 pool.  Its reduced config on the
  # CPU: --arch llama3.2-3b --requests 6 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --full \\
      --arch llama3.2-3b --requests 16 --slots 8 --max-seq 1024

  # the same with Q4_0 weights (QuantPolicy(bits=4, min_size=512))
  PYTHONPATH=src python -m repro_torch.launch.serve --full \\
      --arch llama3.2-3b --bits 4 --requests 16 --slots 8 --max-seq 1024

  # phi4-mini-3.8b (llama3.2-3b's head layout, 32 layers, vocab 200064):
  # ~7 GB of Q8_0 with the fused operands
  PYTHONPATH=src python -m repro_torch.launch.serve --full \\
      --arch phi4-mini-3.8b --requests 16 --slots 8 --max-seq 1024

  # glm4-9b (40 layers, d_model 4096, 32 query heads over 2 KV heads of
  # 128, d_ff 13696, vocab 151552): Q8_0 with the fused decode operands,
  # each weight quantized as it is drawn
  PYTHONPATH=src python -m repro_torch.launch.serve --full \\
      --arch glm4-9b --requests 16 --slots 8 --max-seq 1024

  # command-r-35b (40 layers, d_model 8192, 64 query heads over 8 KV heads
  # of 128, d_ff 22528, vocab 256000): ~54 GB of Q8_0 with the fused
  # operands; its 121 GB f32 tree is never held (at most w2's 29.5 GB
  # draw).  Its reduced config on the CPU: --arch command-r-35b
  # --requests 6 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --full \\
      --arch command-r-35b --requests 16 --slots 8 --max-seq 1024

  # qwen3-moe-30b-a3b (48 layers, d_model 2048, 32 query heads over 4 KV
  # heads of 64, 128 experts of d_ff 768, top 8, vocab 151936): ~32 GB of
  # Q8_0, the router f32; each expert bank drawn a layer at a time, its
  # 119 GB f32 tree never held.  The experts run the reference's f32
  # products on dequantized weights.  Its reduced config on the CPU:
  # --arch qwen3-moe-30b-a3b --requests 6 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --full \\
      --arch qwen3-moe-30b-a3b --requests 16 --slots 8 --max-seq 1024

  # the SSM families on the dense per-slot cache (they have no paged
  # pool; the Engine falls back as the reference's does): mamba2-370m (48
  # Mamba2 layers, d_model 1024, no attention; ~0.40 GB of Q8_0) and
  # zamba2-1.2b (38 Mamba2 layers, d_model 2048, one shared attention +
  # SwiGLU block after every 6th; ~1.2 GB; --kv-int8 for an int8 KV
  # cache).  Their reduced configs on the CPU: --arch mamba2-370m
  # --requests 6 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --full \\
      --arch mamba2-370m --requests 16 --slots 8 --max-seq 1024
  PYTHONPATH=src python -m repro_torch.launch.serve --full \\
      --arch zamba2-1.2b --requests 16 --slots 8 --max-seq 1024

  # qwen2-vl-7b (the vlm family's language backbone on text tokens: 28
  # layers, d_model 3584, 28 query heads over 4 KV heads of 128, d_ff
  # 18944, vocab 152064, M-RoPE with its three position streams equal):
  # 12.4 GB of Q8_0 with the fused operands, its 28.3 GB f32 tree never
  # held.  Its reduced config on the CPU: --arch qwen2-vl-7b --requests 6
  # --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --full \\
      --arch qwen2-vl-7b --requests 16 --slots 8 --max-seq 1024

  # llama4-maverick-400b-a17b (the llama4 interleave: 48 layers, dense
  # and MoE in turn, d_model 5120, 40 query heads over 8 KV heads of 128,
  # 128 experts of d_ff 8192, top 1, vocab 202048) on the dense per-slot
  # cache, as the reference's engine falls back for it.  Its reduced
  # config on the CPU:
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch llama4-maverick-400b-a17b --requests 6 --device cpu
  # --full is refused before anything is drawn: its ~424 GB of Q8_0 do
  # not fit one card (chip_smoke.py serves it cut to 4 layers)

  # the reduced config on the CPU, open loop at 50 req/s, streaming tokens
  PYTHONPATH=src python -m repro_torch.launch.serve --requests 6 \\
      --device cpu --open-loop --rate 50 --stream

  # speculative decoding: n-gram drafts (or --draft draft_model, the
  # served model drafting for itself), verified 4 at a time
  PYTHONPATH=src python -m repro_torch.launch.serve --full --requests 16 \\
      --slots 8 --max-seq 1024 --spec-tokens 4

Requests sample at the engine's defaults, temperature 1.0 and top-p 1.0
(the paper's evaluation setup), with keys split from ``--seed``.  The
weights are random, drawn from ``--seed``.  The matmuls run the paper's
integer arithmetic on the port's CUDA kernels (the ``kernel`` strategy; the
plain versions on the CPU), where the reference CLI runs its process
default, ``dequant``.

The closed batch also prints the engine's roofline energy and tokens per
joule: a model on the H100's data-sheet constants, not a measurement; with
``--spec-tokens`` it prints the speculation line (acceptance, steps per
token, rollbacks).  ``--draft draft_model`` drafts with the served model
and weights themselves (the reference's CLI cannot build that proposer).

A tree larger than the memory of the device it would be drawn on (the
card's; on the CPU, an 80 GB H100's, the card the port serves on) is
refused with ``NotImplementedError`` before anything is drawn: at
``--full``, llama4-maverick-400b-a17b's ~424 GB of Q8_0.

whisper-small (the audio family) is refused with ``NotImplementedError``:
the engine prefills tokens alone, as the reference's does, and its encoder
needs frames; it is served at the model level (``Model.prefill`` with
``frames`` and ``tokens``, then ``Model.decode_step``).

``--ckpt-dir`` serves trained weights: the newest checkpoint of
``launch/train.py`` (or of the reference's trainer: the two share one
layout) is restored and quantized as above:

  PYTHONPATH=src python -m repro_torch.launch.serve --full \\
      --ckpt-dir /path/to/ckpt

``--mesh N`` serves tensor-parallel over a mesh of N devices
(``launch/mesh.make_serve_mesh``; ``serving/engine.py``: the pool sharded
on its KV heads, the weights held sharded and gathered whole at use, the
streams those of one device, bit for bit).  ``--mesh 1`` runs in this
process (a world of one: NCCL on the card, gloo on the CPU); N > 1 runs
one process a device under ``torchrun``, rank 0 printing and the others
serving in silence:

  torchrun --nproc-per-node 2 -m repro_torch.launch.serve --mesh 2 \
      --full --requests 16 --slots 8 --max-seq 1024

With ``--open-loop`` on a mesh of more than one, rank 0's clock releases
the arrivals on every rank (``serving/async_serving.py``), and the rate a
calibration pass measures is rank 0's.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import time

import numpy as np
import torch

from repro_torch.checkpoint import store
from repro_torch.configs import get_config, reduced
from repro_torch.core import qlinear
from repro_torch.core.device import resolve_device
from repro_torch.core.policy import QuantPolicy
from repro_torch.distribution import collectives as C
from repro_torch.models.model import build_model, params_to
from repro_torch.serving.async_serving import (first_token_latencies,
                                               poisson_arrivals,
                                               run_open_loop)
from repro_torch.serving.engine import Engine, check_servable
from repro_torch.serving.spec_decode import DraftModelProposer

# the memory of the card the port serves on (an H100's 80 GB): what a tree
# drawn on the CPU is held to
CARD_BYTES = 80e9


def _make_prompts(rng, cfg, n: int):
    return [rng.integers(4, cfg.vocab_size,
                         size=int(rng.integers(4, 32))).astype(np.int32)
            for _ in range(n)]


def _print_throughput(eng, toks: int, wall: float) -> None:
    print(f"[serve] throughput: {toks/wall:,.1f} tok/s end-to-end "
          f"wall-clock | {eng.throughput_tok_s():,.1f} tok/s decode-only "
          f"(tokens_out/t_decode)")


def _load_params(model, ckpt_dir: str, seed: int, dev, hold=None):
    """The float parameters: the seeded init (drawn on ``dev``), or with
    ``ckpt_dir`` the newest checkpoint there (``checkpoint/store.py``: the
    trainer's, or the reference's, restored into the init's tree); held on
    ``hold`` (``dev`` by default).  The step restored must be the latest
    on disk: a stale or missing step directory fails here rather than
    serving old weights."""
    if not ckpt_dir:
        return model.init(seed, device=dev, hold=hold)
    restored, step, _ = store.restore(ckpt_dir,
                                      {"params": model.init_meta()},
                                      device=hold or dev)
    latest = store.latest_step(ckpt_dir)
    if step != latest:
        raise RuntimeError(f"restored step {step} from {ckpt_dir} but "
                           f"latest on disk is {latest}")
    print(f"[serve] restored checkpoint step {step} from {ckpt_dir} "
          f"(latest on disk)")
    return restored["params"]


def _held_bytes(model, policy, mesh=None) -> float:
    """Bytes of parameters the device holds: the tree ``init_params`` (no
    ``policy``) or ``init_quantized`` would hold (``transformer.
    init_bytes``), or on a mesh of more than one this rank's serve-mode
    shards of it (``roofline.per_device_bytes``), counted on the meta
    device: nothing is drawn."""
    from repro_torch.models.transformer import init_bytes
    if mesh is None or mesh.shape["model"] == 1:
        return init_bytes(model.cfg, policy)
    from repro_torch.distribution import sharding as sh
    from repro_torch.launch.roofline import per_device_bytes
    from repro_torch.launch.steps import params_struct
    struct = params_struct(model, policy is not None, policy)
    return per_device_bytes(
        struct, sh.param_specs(model.cfg, struct, mesh, mode="serve"), mesh)


def _refuse_past_memory(model, policy, dev, mesh=None) -> None:
    """Raise ``NotImplementedError`` before any draw where the parameters
    would not fit the device (:func:`_held_bytes`) against the card's
    memory, or ``CARD_BYTES`` on the CPU."""
    cfg = model.cfg
    need = _held_bytes(model, policy, mesh)
    cap = (torch.cuda.get_device_properties(dev).total_memory
           if dev.type == "cuda" else CARD_BYTES)
    if need > cap:
        kind = "float" if policy is None else f"Q{policy.bits}_0"
        raise NotImplementedError(
            f"{cfg.arch_id}: {cfg.n_layers} layers hold {need / 1e9:.1f} GB "
            f"of {kind} parameters on a device, past the {cap / 1e9:.1f} GB of "
            "one card; a model this size is served cut in depth "
            "(cfg.with_(n_layers=...), as chip_smoke.py does) or on a "
            "larger mesh (--mesh)")


def run(arch: str = "llama2-110m", use_reduced: bool = True,
        requests: int = 16, bits: int = 8, kv_int8: bool = False,
        max_seq: int = 512, max_new: int = 48, slots: int = 4,
        ckpt_dir: str = "", seed: int = 0, no_quant: bool = False,
        spec_tokens: int = 0, draft: str = "ngram",
        open_loop: bool = False, rate: float = 0.0,
        load_factor: float = 0.85, stream: bool = False,
        stream_interval: int = 1, mesh_size: int = 0, device=None):
    """Serve ``requests`` seeded prompts as one closed batch, or open loop
    (:func:`_run_open_loop`); returns the engine and the requests.  The
    run is under the ``kernel`` strategy; the process default is restored
    after it.  ``spec_tokens > 0`` speculates with the ``draft`` proposer:
    ``"ngram"``, or ``"draft_model"`` with the served model and weights.
    ``mesh_size`` > 0 serves on a mesh of that many ranks (the module
    docstring); a rank other than 0 prints nothing."""
    mesh = None
    if mesh_size > 0:
        from repro_torch.launch.mesh import make_serve_mesh
        mesh = make_serve_mesh(mesh_size, device=device)
        device = mesh.device
    quiet = (contextlib.redirect_stdout(io.StringIO())
             if mesh is not None and mesh.rank != 0
             else contextlib.nullcontext())
    with quiet:
        return _run(arch, use_reduced, requests, bits, kv_int8, max_seq,
                    max_new, slots, ckpt_dir, seed, no_quant, spec_tokens,
                    draft, open_loop, rate, load_factor, stream,
                    stream_interval, mesh, device)


def _run(arch, use_reduced, requests, bits, kv_int8, max_seq, max_new,
         slots, ckpt_dir, seed, no_quant, spec_tokens, draft, open_loop,
         rate, load_factor, stream, stream_interval, mesh, device):
    cfg = get_config(arch)
    if use_reduced:
        cfg = reduced(cfg)
    if kv_int8:
        cfg = cfg.with_(kv_cache_dtype="int8")
    check_servable(cfg)
    dev = resolve_device(device)
    model = build_model(cfg)
    policy = None if no_quant else QuantPolicy(bits=bits, min_size=512)
    # on a mesh of more than one the tree is drawn (or restored) to the
    # host and cut there: the card holds this rank's shards alone
    host = (torch.device("cpu")
            if mesh is not None and mesh.shape["model"] > 1 else None)
    # a checkpoint's float tree is held before it is quantized: on the
    # device, unless the host holds it
    _refuse_past_memory(model, None if ckpt_dir and host is None else policy,
                        dev, mesh)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"[serve] {cfg.arch_id} ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}) on {dev} ({name})")
    if mesh is not None:
        n = mesh.shape["model"]
        print(f"[serve] tensor-parallel mesh: model={n} ({mesh.size} "
              "devices; KV pool sharded on KV heads, streams bit-identical "
              "to unsharded)")
    if no_quant or ckpt_dir:
        params = _load_params(model, ckpt_dir, seed, dev, host)
        if not no_quant:
            t0 = time.perf_counter()
            params = model.quantize(params, policy)
            print(f"[serve] Q{bits}_0 post-training quantization "
                  f"in {time.perf_counter()-t0:.2f}s")
    else:
        # post-training quantization as each weight is drawn: the same bits
        # as quantize(init(seed)), without the float tree
        t0 = time.perf_counter()
        params = model.init_quantized(seed, policy, device=dev, hold=host)
        print(f"[serve] Q{bits}_0 post-training quantization, drawn and "
              f"quantized in {time.perf_counter()-t0:.2f}s")

    # the draft model is the served one, whole, on the device
    proposer = (DraftModelProposer(model, params_to(params, dev),
                                   max_seq=max_seq)
                if spec_tokens > 0 and draft == "draft_model" else draft)

    def make_engine():
        return Engine(model, params, max_slots=slots, max_seq=max_seq,
                      seed=seed, spec_tokens=spec_tokens,
                      draft_proposer=proposer, mesh=mesh, device=dev)

    prompts = _make_prompts(np.random.default_rng(seed), cfg, requests)
    old = qlinear.default_strategy()
    qlinear.set_default_strategy("kernel")
    try:
        if open_loop:
            return _run_open_loop(make_engine, prompts, max_new, seed, rate,
                                  load_factor, stream, stream_interval, mesh)
        eng = make_engine()
        # the engine holds what it serves (on a mesh, this rank's shards):
        # the tree it was made from goes before the run
        del params
        for prompt in prompts:
            eng.submit(prompt, max_new_tokens=max_new)
        t0 = time.perf_counter()
        done = eng.run()
        _sync(dev)
        wall = time.perf_counter() - t0
    finally:
        qlinear.set_default_strategy(old)
    toks = eng.metrics["tokens_out"]
    print(f"[serve] {len(done)}/{requests} requests, {toks} tokens "
          f"in {wall:.2f}s")
    _print_throughput(eng, toks, wall)
    steps = eng.metrics["decode_steps"]
    if steps:
        step_ms = eng.metrics["t_decode"] / steps * 1e3
        print(f"[serve] decode step {step_ms:.3f} ms over {steps} steps")
    lat = first_token_latencies(done)
    if len(lat):
        print(f"[serve] TTFT p50 {np.median(lat)*1e3:.0f}ms  "
              f"p95 {np.percentile(lat, 95)*1e3:.0f}ms "
              f"(from arrival, {len(lat)}/{len(done)} with first token)")
    joules = eng.metrics["energy_joules"]
    if joules > 0:
        print(f"[serve] roofline energy {joules:.3g} J -> "
              f"{toks/joules:,.0f} tok/J (model, not measured)")
    if spec_tokens > 0:
        print(f"[serve] speculation ({draft}, k={spec_tokens}): "
              f"accept_ratio {eng.metrics['accept_ratio']:.2f} "
              f"({eng.metrics['accepted_tokens']}"
              f"/{eng.metrics['draft_tokens']} drafts), "
              f"steps/token {eng.metrics['steps_per_token']:.3f}, "
              f"{eng.metrics['spec_rollbacks']} rollbacks")
    return eng, done


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _run_open_loop(make_engine, prompts, max_new: int, seed: int,
                   rate: float, load_factor: float, stream: bool,
                   stream_interval: int, mesh=None):
    """Continuous arrivals: requests arrive mid-flight on a seeded Poisson
    process and tokens stream back per step.  Without ``rate`` a short
    closed calibration pass measures the service capacity and the arrival
    rate is set to ``load_factor`` of it: loaded enough for queueing delay
    to show, light enough for the queue to drain.  On a ``mesh`` the rate
    is rank 0's, so every rank draws the same schedule."""
    if rate <= 0:
        n_cal = min(4, len(prompts))
        cal = make_engine()
        for p in prompts[:n_cal]:
            cal.submit(p, max_new_tokens=max_new)
        t0 = time.perf_counter()
        cal.run()
        _sync(cal.device)
        cal_wall = max(time.perf_counter() - t0, 1e-6)
        rate = C.from_rank0(load_factor * n_cal / cal_wall, mesh)
        print(f"[serve] calibrated: {n_cal} requests in {cal_wall:.2f}s "
              f"-> open-loop arrival rate {rate:.2f} req/s "
              f"({load_factor:.0%} of measured capacity)")

    on_token = None
    if stream:
        def on_token(handle, sibling, tokens, done):
            for t in tokens:
                print(f"[stream] uid={handle.uid} sib={sibling} tok={t}")
            if done:
                tag = "ok" if handle.error is None else handle.error_kind
                print(f"[stream] uid={handle.uid} done ({tag})")

    arrivals = poisson_arrivals(seed, len(prompts), rate)
    workload = [(float(t), p, {"max_new_tokens": max_new, "seed": seed + i})
                for i, (t, p) in enumerate(zip(arrivals, prompts))]
    eng = make_engine()
    t0 = time.perf_counter()
    handles, report = run_open_loop(
        eng, workload, stream_interval_steps=stream_interval,
        on_token=on_token)
    _sync(eng.device)
    wall = time.perf_counter() - t0
    toks = eng.metrics["tokens_out"]
    print(f"[serve] open loop: {report.completed_ok}/{report.n_requests} "
          f"ok ({report.failed} failed), {report.midflight_submits} "
          f"arrivals landed mid-flight, peak queue depth "
          f"{report.peak_queue_depth}")
    print(f"[serve] goodput {report.goodput_tok_s:,.1f} tok/s "
          f"({report.goodput_req_s:.2f} req/s) at offered "
          f"{report.arrival_rate_req_s:.2f} req/s over {report.wall_s:.2f}s")
    print(f"[serve] TTFT p50 {report.ttft_ms['p50']:.0f}ms "
          f"p99 {report.ttft_ms['p99']:.0f}ms | TPOT p50 "
          f"{report.tpot_ms['p50']:.1f}ms p99 {report.tpot_ms['p99']:.1f}ms "
          f"(from true arrival time)")
    _print_throughput(eng, toks, wall)
    return eng, [h.req for h in handles]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama2-110m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--bits", type=int, default=8, choices=(4, 8))
    ap.add_argument("--kv-int8", action="store_true")
    ap.add_argument("--no-quant", action="store_true")
    ap.add_argument("--max-seq", type=int, default=512)
    ap.add_argument("--max-new", type=int, default=48)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--spec-tokens", type=int, default=0,
                    help="draft-then-verify speculation depth (0 = off)")
    ap.add_argument("--draft", default="ngram")
    ap.add_argument("--open-loop", action="store_true",
                    help="continuous Poisson arrivals instead of a "
                         "closed batch; reports goodput and TTFT/TPOT "
                         "percentiles from true arrival time")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="open-loop arrival rate in req/s "
                         "(0 = calibrate to --load-factor of capacity)")
    ap.add_argument("--load-factor", type=float, default=0.85,
                    help="target utilization for rate calibration")
    ap.add_argument("--stream", action="store_true",
                    help="print tokens as they stream back per step")
    ap.add_argument("--stream-interval", type=int, default=1,
                    help="flush streamed tokens every N engine steps")
    ap.add_argument("--mesh", type=int, default=0,
                    help="tensor-parallel mesh size over the model axis "
                         "(0 = single device; N > 1 under torchrun "
                         "--nproc-per-node N)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.set_defaults(reduced=True)
    return ap


def main(argv=None):
    """Parse ``argv`` and serve; returns ``run``'s (engine, requests)."""
    args = build_parser().parse_args(argv)
    return run(args.arch, args.reduced, args.requests, args.bits, args.kv_int8,
        args.max_seq, args.max_new, args.slots, args.ckpt_dir,
        no_quant=args.no_quant, spec_tokens=args.spec_tokens,
        draft=args.draft, open_loop=args.open_loop, rate=args.rate,
        load_factor=args.load_factor, stream=args.stream,
        stream_interval=args.stream_interval, mesh_size=args.mesh,
        device=args.device)


if __name__ == "__main__":
    main()
