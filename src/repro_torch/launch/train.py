"""Training launcher: end-to-end training with checkpoint and resume,
heartbeat and straggler records.

PyTorch counterpart of ``repro/launch/train.py``, on the card unless
``--device cpu`` is given:

  # llama2-110m at full width and depth on one card
  PYTHONPATH=src python -m repro_torch.launch.train --full --steps 30 \\
      --ckpt-dir /path/to/ckpt --ckpt-every 15

  # the reduced config on the CPU
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 20

The parameters are the port's own seeded init (``Model.init(seed)``), the
batches the synthetic TinyStories stream (``data/pipeline.py``, the
reference's numpy code, drawn on the host), the step ``launch/steps.py``'s
``make_train_step``: the loss and its gradients by autograd, then AdamW in
place.  The forward runs the reference's plain functions (its training runs
no Pallas kernel and no kernel of the port has a backward), so training
launches no CUDA kernel of ``kernels/``.  With ``--ckpt-dir`` the run
resumes from the newest checkpoint there, the data stream's state included,
and saves asynchronously every ``--ckpt-every`` steps.  As in the reference
the schedule is set from ``--steps`` (warmup ``min(20, steps // 5 + 1)``,
decay to ``steps``), and ``--grad-compress`` changes nothing in the step
(``make_train_step`` passes no compression error).

Each logged step prints the loss, the learning rate, the gradient norm and
tokens per second over the whole step, then the step's data time (drawing
the batch on the host) and its device time (the step itself, synchronized)
apart.  The reference's GSPMD wrapper (``jit_train_step``) trains on a
mesh, where its products are really partitioned (Megatron TP); training on
a mesh of more than one device waits (ROADMAP, queue A): the port's mesh
serves only (``serving/engine.py``).
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import torch

from repro_torch.checkpoint import store
from repro_torch.configs import get_config, reduced
from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import DataConfig, SyntheticTinyStories
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
    when there is one) and return the losses of the steps this call ran.
    ``on_step``, when given, receives each step's record: ``step``,
    ``loss``, ``lr``, ``grad_norm``, ``data_ms``, ``device_ms``, ``tok_s``
    and the host ``batch``."""
    cfg = get_config(arch)
    if use_reduced:
        cfg = reduced(cfg)
    dev = resolve_device(device)
    model = build_model(cfg)
    ocfg = adamw.AdamWConfig(warmup_steps=min(20, steps // 5 + 1),
                             decay_steps=max(steps, 2),
                             grad_compress_bits=8 if grad_compress else 0)
    step_fn = steplib.make_train_step(model, ocfg, microbatches=microbatches)

    data = SyntheticTinyStories(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, batch_size=batch,
        seed=seed))
    it = data.batches()

    start_step = 0
    if ckpt_dir and store.latest_step(ckpt_dir) is not None:
        like = model.init_meta()
        state, start_step, extra = store.restore(
            ckpt_dir, {"params": like, "opt": adamw.init_state(like)},
            device=dev)
        if "data_state" in extra:
            data.restore(extra["data_state"])
        print(f"[train] resumed from step {start_step}")
    else:
        params = model.init(seed, device=dev)
        state = {"params": params, "opt": adamw.init_state(params)}

    hb = HeartbeatMonitor(n_hosts=1)
    straggle = StragglerDetector(n_hosts=1)
    n_params = count_params(state["params"])
    print(f"[train] {cfg.arch_id}: {n_params/1e6:.1f}M params, {steps} "
          f"steps, batch {batch} x seq {seq} on {dev}")

    losses = []
    writer = None
    for s in range(start_step, steps):
        t0 = time.perf_counter()
        batch_np = next(it)
        t1 = time.perf_counter()
        state, metrics = step_fn(state, batch_np)
        loss = float(metrics["loss"])
        _sync(dev)
        t2 = time.perf_counter()
        losses.append(loss)
        dt = t2 - t0
        hb.beat(0, s)
        straggle.record(0, dt)
        rec = {"step": s, "loss": loss, "lr": float(metrics["lr"]),
               "grad_norm": float(metrics["grad_norm"]),
               "data_ms": (t1 - t0) * 1e3, "device_ms": (t2 - t1) * 1e3,
               "tok_s": batch * seq / dt, "batch": batch_np}
        if s % log_every == 0 or s == steps - 1:
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
                async_=True)
        if on_step is not None:
            on_step(rec)
    if writer is not None:
        writer.join()
    if ckpt_dir:
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
    if losses:
        print(f"[train] final loss {losses[-1]:.4f} "
              f"(start {losses[0]:.4f}, min {min(losses):.4f})")


if __name__ == "__main__":
    main()
