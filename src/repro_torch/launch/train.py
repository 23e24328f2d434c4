"""Training launcher: end-to-end training with checkpoint and resume,
heartbeat and straggler records.

PyTorch counterpart of ``repro/launch/train.py``, on the card unless
``--device cpu`` is given:

  # llama2-110m at full width and depth on one card
  PYTHONPATH=src python -m repro_torch.launch.train --full --steps 30 \\
      --ckpt-dir /path/to/ckpt --ckpt-every 15

  # the reduced config on the CPU
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 20

  # tensor-parallel over 2 ranks (gloo on the CPU; NCCL on 2 cards)
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
      --device cpu --steps 20

As the reference's ``run``, the step is ``launch/steps.py``'s
``jit_train_step`` on ``make_host_mesh()`` (data=1, model=W) with
``zero=False``: the world ``torchrun`` started, or else a world of one
that the run starts and ends itself (where every collective is skipped
and the step is ``make_train_step``'s, bit for bit).  On a model axis of
more than one the dense family trains in Megatron tensor parallelism
(``models/transformer.py``'s ``_TrainTP``), each rank holding its shards;
every rank draws the same batch and the same seeded parameters, then
keeps its shards.  Rank 0 prints and writes the checkpoints
(``checkpoint/store.py`` gathers the leaves whole, so they restore on any
mesh).

The parameters are the port's own seeded init (``Model.init(seed)``), the
batches the synthetic TinyStories stream (``data/pipeline.py``, the
reference's numpy code, drawn on the host).  The forward runs the
reference's plain functions (its training runs no Pallas kernel and no
kernel of the port has a backward), so training launches no CUDA kernel of
``kernels/``.  With ``--ckpt-dir`` the run resumes from the newest
checkpoint there, the data stream's state included, and saves every
``--ckpt-every`` steps (asynchronously on a mesh of one).  As in the
reference the schedule is set from ``--steps`` (warmup ``min(20, steps //
5 + 1)``, decay to ``steps``), and ``--grad-compress`` changes nothing in
the step (no compression error is passed).

Each logged step prints the loss, the learning rate, the gradient norm and
tokens per second over the whole step, then the step's data time (drawing
the batch on the host) and its device time (the step itself, synchronized)
apart.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint import store
from repro_torch.configs import ShapeCell, get_config, reduced
from repro_torch.data.pipeline import DataConfig, SyntheticTinyStories
from repro_torch.distribution import sharding as sh
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import steps as steplib
from repro_torch.models.model import build_model, count_params
from repro_torch.optim import adamw
from repro_torch.runtime.health import HeartbeatMonitor, StragglerDetector


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(arch: str = "llama2-110m", steps: int = 100, batch: int = 8,
        seq: int = 256, use_reduced: bool = True, ckpt_dir: str = "",
        ckpt_every: int = 50, seed: int = 0, log_every: int = 10,
        microbatches: int = 1, grad_compress: bool = False, device=None,
        on_step: Optional[Callable[[dict], None]] = None):
    """Train ``steps`` steps (from the newest checkpoint in ``ckpt_dir``
    when there is one) on ``make_host_mesh()`` and return the losses of
    the steps this call ran.  ``on_step``, when given, receives each
    step's record: ``step``, ``loss``, ``lr``, ``grad_norm``, ``data_ms``,
    ``device_ms``, ``tok_s`` and the host ``batch``.  A process group this
    call started (a world of one) is ended before it returns."""
    started = not dist.is_initialized()
    mesh = meshlib.make_host_mesh(device)
    try:
        return _run(mesh, arch, steps, batch, seq, use_reduced, ckpt_dir,
                    ckpt_every, seed, log_every, microbatches, grad_compress,
                    on_step)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def _run(mesh, arch, steps, batch, seq, use_reduced, ckpt_dir, ckpt_every,
         seed, log_every, microbatches, grad_compress, on_step):
    cfg = get_config(arch)
    if use_reduced:
        cfg = reduced(cfg)
    dev = mesh.device
    lead = mesh.rank == 0
    model = build_model(cfg)
    cell = ShapeCell("custom", seq, batch, "train")
    ocfg = adamw.AdamWConfig(warmup_steps=min(20, steps // 5 + 1),
                             decay_steps=max(steps, 2),
                             grad_compress_bits=8 if grad_compress else 0)
    step_fn, state_struct, _, (sspecs, bspecs) = steplib.jit_train_step(
        model, mesh, ocfg, cell, zero=False, microbatches=microbatches)

    data = SyntheticTinyStories(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, batch_size=batch,
        seed=seed))
    it = data.batches()

    start_step = 0
    if ckpt_dir and store.latest_step(ckpt_dir) is not None:
        state, start_step, extra = store.restore(
            ckpt_dir, state_struct, device=dev, mesh=mesh, specs=sspecs)
        if "data_state" in extra:
            data.restore(extra["data_state"])
        if lead:
            print(f"[train] resumed from step {start_step}")
    else:
        params = model.init(seed, device=dev)
        state = sh.shard({"params": params, "opt": adamw.init_state(params)},
                         sspecs, mesh)
        del params

    hb = HeartbeatMonitor(n_hosts=mesh.size)
    straggle = StragglerDetector(n_hosts=mesh.size)
    n_params = count_params(state_struct["params"])
    if lead:
        tp = (f" on a model={mesh.shape['model']} mesh"
              if mesh.size > 1 else "")
        print(f"[train] {cfg.arch_id}: {n_params/1e6:.1f}M params, {steps} "
              f"steps, batch {batch} x seq {seq} on {dev}{tp}")

    losses = []
    writer = None
    for s in range(start_step, steps):
        t0 = time.perf_counter()
        batch_np = next(it)
        t1 = time.perf_counter()
        state, metrics = step_fn(
            state, steplib.shard_batch(batch_np, bspecs, mesh))
        loss = float(metrics["loss"])
        _sync(dev)
        t2 = time.perf_counter()
        losses.append(loss)
        dt = t2 - t0
        hb.beat(mesh.rank, s)
        straggle.record(mesh.rank, dt)
        rec = {"step": s, "loss": loss, "lr": float(metrics["lr"]),
               "grad_norm": float(metrics["grad_norm"]),
               "data_ms": (t1 - t0) * 1e3, "device_ms": (t2 - t1) * 1e3,
               "tok_s": batch * seq / dt, "batch": batch_np}
        if lead and (s % log_every == 0 or s == steps - 1):
            print(f"[train] step {s:5d} loss {loss:8.4f} "
                  f"lr {rec['lr']:.2e} gnorm {rec['grad_norm']:.3f} "
                  f"{rec['tok_s']:,.0f} tok/s (data {rec['data_ms']:.1f} "
                  f"ms, step on {dev.type} {rec['device_ms']:.1f} ms)",
                  flush=True)
        if ckpt_dir and (s + 1) % ckpt_every == 0:
            if writer is not None:
                writer.join()
            writer = store.save(
                ckpt_dir, s + 1, state,
                extra={"data_state": data.state(), "loss": loss},
                async_=True, mesh=mesh, specs=sspecs)
        if on_step is not None:
            on_step(rec)
    if writer is not None:
        writer.join()
    if ckpt_dir and lead:
        store.prune(ckpt_dir)
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama2-110m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.set_defaults(reduced=True)
    args = ap.parse_args(argv)
    losses = run(args.arch, args.steps, args.batch, args.seq, args.reduced,
                 args.ckpt_dir, args.ckpt_every,
                 microbatches=args.microbatches,
                 grad_compress=args.grad_compress, device=args.device)
    if losses and (not dist.is_initialized() or dist.get_rank() == 0):
        print(f"[train] final loss {losses[-1]:.4f} "
              f"(start {losses[0]:.4f}, min {min(losses):.4f})")


if __name__ == "__main__":
    main()
