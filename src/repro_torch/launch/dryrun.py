"""Multi-pod dry run: trace every (arch x shape x mesh) cell on meta tensors.

PyTorch counterpart of ``repro/launch/dryrun.py``, which lowers and
compiles every cell on 512 placeholder host devices.  Here the devices
stay real in number and the data is abstracted: a fake world of 256 or
512 ranks (``launch/mesh.dryrun_world``: torch's ``FakeProcessGroup``,
seen from rank 0) and the production mesh built in it, which computes on
``meta``.  ``lower_cell`` builds the cell's executor
(``steps.jit_train_step`` / ``jit_prefill_step`` / ``jit_serve_step``) and
rank 0's shards of its inputs, and ``analyse`` runs it once: nothing is
computed, no collective moves a byte, and every kernel wrapper returns
empty meta outputs (``kernels/ops.py``).  The trace yields the roofline
inputs:

  * launch/flops.py           the rank's algorithmic operations, and the
                              raw step's on the global structs (a world
                              of one's arithmetic), as the reference
                              counts ``raw``,
  * launch/collective_cost.py per-device wire bytes of the rank's
                              collective tally,
  * launch/roofline.py        analytic HBM traffic + term assembly at the
                              H100's data-sheet constants,
  * ``memory_analysis``        the rank's argument bytes (exact, from the
                              meta shapes), output bytes, and the peak of
                              the bytes the step allocates beyond them.

The record keeps every key of the reference's, and adds
``flops_dev_executed`` / ``t_compute_executed_s`` (a rank of the port's
serve executors computes replicated over ``model``) and
``collective_calls``; ``compile_s`` is the trace's time.  Importing this
module starts nothing: the world starts in ``run_cell``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod both \\
      --out results/dryrun_torch
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import get_config, list_configs, shapes_for
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.quantization import QuantizedTensor
from repro_torch.distribution import collectives as C
from repro_torch.distribution import sharding as sh
from repro_torch.launch import collective_cost, roofline
from repro_torch.launch import flops as flopslib
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import steps as steplib
from repro_torch.models.model import build_model, count_params
from repro_torch.optim import adamw


def model_flops(cfg, cell, pstruct) -> float:
    """MODEL_FLOPS = 6·N_active·tokens (train) / 2·N_active·tokens (infer)."""
    n_total = count_params(pstruct)
    n_active = n_total
    if cfg.n_experts and cfg.top_k:
        n_pat = cfg.n_layers // cfg.moe_every
        per_expert = 3 * cfg.d_ff * cfg.d_model
        n_active = n_total - n_pat * (cfg.n_experts - cfg.top_k) * per_expert
    if cell.kind == "train":
        return 6.0 * n_active * cell.global_batch * cell.seq_len
    if cell.kind == "prefill":
        return 2.0 * n_active * cell.global_batch * cell.seq_len
    return 2.0 * n_active * cell.global_batch      # one decode step


def _tensors(tree: Any):
    """Every tensor of a tree of dicts, tuples and lists (a quantized
    leaf's codes and scales)."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, QuantizedTensor):
        yield tree.q
        yield tree.scale
    elif isinstance(tree, torch.Tensor):
        yield tree


def tensor_bytes(tree: Any) -> int:
    """Bytes of every tensor of a tree, from the shapes: meta tensors
    included."""
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _storages(tree: Any) -> dict:
    """{storage: bytes} of every tensor of a tree, each storage once."""
    return {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
            for t in _tensors(tree)}


@dataclasses.dataclass
class Lowered:
    """One cell's executor on one rank of the production mesh, with the
    rank's shards of its inputs (``args``) and the specs they were cut
    by (``specs``, one a positional argument)."""

    step: Callable
    args: tuple
    specs: tuple
    mesh: Any

    def __call__(self):
        return self.step(*self.args)


def _world(n: int) -> None:
    """A fake world of exactly ``n`` ranks in this process: started, or
    restarted where one of another size runs."""
    if dist.is_initialized():
        if meshlib.is_fake() and dist.get_world_size() == n:
            return
        if not meshlib.is_fake():
            raise RuntimeError("a dry run needs a process of its own: this "
                               f"one runs a {dist.get_backend()} world")
        dist.destroy_process_group()
    meshlib.dryrun_world(n)


def lower(model, mesh, cell, quantized: bool = True, zero: bool = True,
          microbatches: int = 0, quant_bits: int = 8):
    """One cell's executor on this rank of ``mesh``, on the rank's shards
    of meta structs.  Returns (lowered, flops_fn, pstruct, cstruct): see
    :func:`lower_cell`."""
    if cell.kind == "train":
        step, state_s, batch_s, (sspecs, bspecs) = steplib.jit_train_step(
            model, mesh, adamw.AdamWConfig(), cell, zero=zero,
            microbatches=microbatches)
        lowered = Lowered(step, (sh.shard(state_s, sspecs, mesh),
                                 steplib.shard_batch(batch_s, bspecs, mesh)),
                          (sspecs, bspecs), mesh)
        raw = steplib.make_train_step(
            model, adamw.AdamWConfig(),
            microbatches or steplib.pick_microbatches(cell, mesh,
                                                      cfg=model.cfg))
        return (lowered, lambda: flopslib.count_flops(raw, state_s, batch_s),
                state_s["params"], None)
    policy = QuantPolicy(bits=quant_bits)
    sp = steplib.serve_specs(model, mesh, cell, quantized, policy)
    params = sh.shard(sp.pstruct, sp.params, mesh)
    pstruct, cstruct, batch_s = sp.pstruct, sp.cstruct, sp.batch_struct
    if cell.kind == "prefill":
        step = steplib.jit_prefill_step(model, mesh, cell, quantized,
                                        policy)[0]
        lowered = Lowered(step, (params, steplib.shard_batch(
            batch_s, sp.batch, mesh)), (sp.params, sp.batch), mesh)
        raw = steplib.make_prefill_step(model, cell.seq_len)
        return (lowered, lambda: flopslib.count_flops(raw, pstruct, batch_s),
                pstruct, cstruct)
    step = steplib.jit_serve_step(model, mesh, cell, quantized, policy)[0]
    lowered = Lowered(step, (params, sh.shard(cstruct, sp.cache, mesh),
                             sh.shard(batch_s["tokens"], sp.tokens, mesh)),
                      (sp.params, sp.cache, sp.tokens), mesh)
    raw = steplib.make_serve_step(model)
    return (lowered, lambda: flopslib.count_flops(
        raw, pstruct, steplib.cache_struct(model, cell), batch_s["tokens"]),
        pstruct, cstruct)


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               quantized: bool = True, zero: bool = True,
               cfg_overrides: dict | None = None, microbatches: int = 0,
               quant_bits: int = 8):
    """Build one cell's executor on rank 0 of the production mesh, in a
    fake world of 256 (single pod) or 512 (multi pod) ranks.

    Returns (lowered, flops_fn, cfg, cell, pstruct, cstruct) where
    ``lowered()`` runs the executor on the rank's meta shards and
    ``flops_fn()`` counts the raw step's algorithmic operations on the
    global meta structs."""
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = cfg.with_(**cfg_overrides)
    cells = {c.name: c for c in shapes_for(cfg)}
    if shape_name not in cells:
        raise SystemExit(f"{arch} skips {shape_name} (long_500k is for the "
                         "sub-quadratic families only)")
    cell = cells[shape_name]
    _world(512 if multi_pod else 256)
    mesh = meshlib.make_production_mesh(multi_pod=multi_pod)
    lowered, flops_fn, pstruct, cstruct = lower(
        build_model(cfg), mesh, cell, quantized, zero, microbatches,
        quant_bits)
    return lowered, flops_fn, cfg, cell, pstruct, cstruct


def analyse(lowered: Lowered, flops_fn, cfg, cell, pstruct, cstruct,
            n_devices: int, microbatches: int, mesh=None) -> dict:
    """Run the executor once under the operation counter and the
    collective tally, count the raw step, and assemble the record."""
    with flopslib.Counter(track_memory=True) as counter, \
            C.tally() as calls:
        out = lowered()
    # the outputs' storages the step made (not its arguments', updated in
    # place): the peak less these is its temporaries
    args_at = _storages(lowered.args)
    new_out = sum(n for k, n in _storages(out).items() if k not in args_at)
    coll = collective_cost.collective_wire_bytes(calls)

    algo_flops = flops_fn()
    p_bytes = roofline.tree_bytes(pstruct)
    c_bytes = roofline.tree_bytes(cstruct) if cstruct is not None else 0
    mf = model_flops(cfg, cell, pstruct)
    p_dev = 0.0
    if mesh is not None:
        mode = "train" if cell.kind == "train" else "serve"
        pspecs = sh.param_specs(cfg, pstruct, mesh, mode=mode)
        p_dev = roofline.per_device_bytes(pstruct, pspecs, mesh)
    membd = roofline.analytic_bytes(
        cfg, cell, n_devices, p_bytes, c_bytes, microbatches,
        param_bytes_per_dev=p_dev,
        model_shards=mesh.shape["model"] if mesh is not None else 16)
    # a trace runs every loop iteration, so nothing is counted "once";
    # there is no compiler cost model to read bytes from
    raw_cost = {"flops_while_once": counter.flops, "bytes_while_once": None}
    rec = roofline.assemble(cfg, cell, n_devices, algo_flops, mf, membd,
                            coll["total"], raw_cost,
                            flops_dev_executed=counter.flops)
    rec["collective_breakdown"] = coll
    rec["collective_calls"] = collective_cost.summarize(calls)
    rec["param_bytes_global"] = p_bytes
    rec["cache_bytes_global"] = c_bytes
    rec["microbatches"] = microbatches
    rec["memory_analysis"] = {
        "argument_bytes": tensor_bytes(lowered.args),
        "output_bytes": tensor_bytes(out),
        "temp_bytes": max(counter.peak_bytes - new_out, 0),
    }
    return rec


def run_cell(arch, shape, multi_pod, out_dir=None, quantized=True,
             zero=True, overrides=None, microbatches: int = 0,
             verbose=True, tag_suffix="", quant_bits: int = 8):
    """Trace and analyse one cell (starting the fake world it needs), and
    write its record to ``out_dir``."""
    t0 = time.time()
    lowered, flops_fn, cfg, cell, pstruct, cstruct = lower_cell(
        arch, shape, multi_pod, quantized=quantized, zero=zero,
        cfg_overrides=overrides, microbatches=microbatches,
        quant_bits=quant_bits)
    n_dev = 512 if multi_pod else 256
    mesh = lowered.mesh
    mb = microbatches or (steplib.pick_microbatches(cell, mesh, cfg=cfg)
                          if cell.kind == "train" else 1)
    rec = analyse(lowered, flops_fn, cfg, cell, pstruct, cstruct, n_dev, mb,
                  mesh=mesh)
    rec["compile_s"] = round(time.time() - t0, 1)
    rec["multi_pod"] = multi_pod
    if verbose:
        print(json.dumps(rec, indent=2, default=str))
    if out_dir:
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        tag = f"{arch}__{shape}__{'2pod' if multi_pod else '1pod'}{tag_suffix}"
        (out / f"{tag}.json").write_text(json.dumps(rec, indent=2,
                                                    default=str))
    return rec


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--no-quant", action="store_true",
                    help="serve cells with float weights (paper-baseline "
                         "comparison)")
    args = ap.parse_args(argv)

    pods = {"single": [False], "multi": [True], "both": [False, True]}[
        args.multi_pod]

    if args.all:
        targets = []
        for arch in list_configs():
            if arch == "llama2-110m":
                continue        # the paper model is benchmarked, not dry-run
            cfg = get_config(arch)
            for cell in shapes_for(cfg):
                targets.append((arch, cell.name))
    else:
        if not args.arch or not args.shape:
            ap.error("--arch/--shape or --all required")
        targets = [(args.arch, args.shape)]

    failures = []
    for arch, shape in targets:
        for mp in pods:
            tag = f"{arch} x {shape} x {'2pod' if mp else '1pod'}"
            done = Path(args.out) / \
                f"{arch}__{shape}__{'2pod' if mp else '1pod'}.json"
            if args.all and done.exists():
                print(f"[skip cached] {tag}", flush=True)
                continue
            print(f"=== {tag} ===", flush=True)
            try:
                t0 = time.time()
                run_cell(arch, shape, mp, out_dir=args.out,
                         quantized=not args.no_quant, verbose=False)
                print(f"    OK ({time.time()-t0:.0f}s)", flush=True)
            except Exception as e:  # noqa: BLE001 — report and continue
                failures.append((tag, repr(e)[:500]))
                print(f"    FAIL {tag}: {repr(e)[:300]}", flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for t, e in failures:
            print(" -", t, e)
        sys.exit(1)
    print("\nall cells traced OK")


if __name__ == "__main__":
    main()
