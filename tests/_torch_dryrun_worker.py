"""Workers of the dry-run tests: the collective tally of the port's
executors on a mesh, run for real over gloo (``_torch_mesh_worker.Lane``
runs the job ``"_torch_dryrun_worker:tally"``, one process a rank) and in
a dry run's fake world on meta tensors (``python _torch_dryrun_worker.py
fake DATA MODEL``, one process, rank 0), and the checks that need a fake
world of their own (``python _torch_dryrun_worker.py cells``).

Imports ``torch`` and ``repro_torch`` only.  A fake world is a process's
one default process group, so each check here runs in a process of its
own and prints its result as one JSON line.
"""

from __future__ import annotations

import json
import sys

import torch

# the cells of the tally: the reduced llama2-110m in f32, a decode and a
# prefill cell of 4 rows, and a train cell of 4 rows of 16
CELLS = (("decode", 16), ("prefill", 8), ("train", 16))
BATCH = 4


def _config():
    from repro_torch.configs import get_config, reduced
    return reduced(get_config("llama2-110m")).with_(
        compute_dtype="float32", param_dtype="float32",
        kv_cache_dtype="float32")


def _real_tree(struct, gen):
    """A tree shaped as the meta ``struct`` with real CPU values: floats
    from ``gen``, integers small and non-negative."""
    from repro_torch.core.quantization import QuantizedTensor
    if isinstance(struct, dict):
        return {k: _real_tree(v, gen) for k, v in struct.items()}
    if isinstance(struct, QuantizedTensor):
        import dataclasses
        return dataclasses.replace(struct, q=_real_tree(struct.q, gen),
                                   scale=_real_tree(struct.scale, gen))
    if struct.dtype.is_floating_point:
        return torch.randn(struct.shape, generator=gen).to(struct.dtype)
    return torch.randint(0, 100, struct.shape, generator=gen,
                         dtype=struct.dtype)


def run_cells(mesh, real: bool) -> dict:
    """{kind: the tally summary of one call of the cell's executor} on
    this rank of ``mesh``: on real CPU values (``real``) or on the meta
    structs themselves."""
    from repro_torch.configs import ShapeCell
    from repro_torch.distribution import collectives as C
    from repro_torch.distribution import sharding as sh
    from repro_torch.launch import collective_cost, steps
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw

    model = build_model(_config())
    gen = torch.Generator().manual_seed(0)

    def values(t):
        return _real_tree(t, gen) if real else t

    out = {}
    for kind, seq in CELLS:
        cell = ShapeCell(kind, seq, BATCH, kind)
        if kind == "train":
            step, state_s, batch_s, (sspecs, bspecs) = steps.jit_train_step(
                model, mesh, adamw.AdamWConfig(), cell)
            state = values(state_s)
            if real:
                state["opt"]["step"] = torch.zeros((), dtype=torch.int32)
            args = (sh.shard(state, sspecs, mesh),
                    steps.shard_batch(values(batch_s), bspecs, mesh))
        else:
            sp = steps.serve_specs(model, mesh, cell)
            params = sh.shard(values(sp.pstruct), sp.params, mesh)
            if kind == "prefill":
                step = steps.jit_prefill_step(model, mesh, cell)[0]
                args = (params, steps.shard_batch(values(sp.batch_struct),
                                                  sp.batch, mesh))
            else:
                step = steps.jit_serve_step(model, mesh, cell)[0]
                cache = (model.init_cache(BATCH, seq, device="cpu") if real
                         else sp.cstruct)
                args = (params, sh.shard(cache, sp.cache, mesh),
                        sh.shard(values(sp.batch_struct["tokens"]),
                                 sp.tokens, mesh))
        with C.tally() as calls:
            step(*args)
        out[kind] = collective_cost.summarize(calls)
    return out


def tally(world, data: int, model: int):
    """The job of the gloo lane: this rank's tallies on a data x model
    mesh of the world's ranks."""
    from repro_torch.launch.mesh import make_train_mesh
    return run_cells(make_train_mesh(data, model, device="cpu"), real=True)


JOBS = {"tally": tally}


def fake(data: int, model: int) -> dict:
    """The same cells traced in a dry run's fake world of data x model
    ranks, as rank 0."""
    from repro_torch.launch import mesh as meshlib
    meshlib.dryrun_world(data * model)
    mesh = meshlib.make_train_mesh(data, model)
    assert mesh.device.type == "meta"
    return run_cells(mesh, real=False)


def cells() -> dict:
    """Full-size dry-run checks: llama3.2-3b decode_32k's argument bytes
    against ``per_device_bytes`` of its executor's specs (16 x 16), and
    qwen2-vl-7b's prefill_32k traced on meta (its M-RoPE streams)."""
    from repro_torch.launch import dryrun, roofline, steps
    lowered, _, cfg, cell, pstruct, cstruct = dryrun.lower_cell(
        "llama3.2-3b", "decode_32k", multi_pod=False)
    p_specs, c_specs, t_specs = lowered.specs
    mesh = lowered.mesh
    tokens = steps.input_specs(cfg, cell)["tokens"]
    want = (roofline.per_device_bytes(pstruct, p_specs, mesh)
            + roofline.per_device_bytes(cstruct, c_specs, mesh)
            + roofline.per_device_bytes(tokens, t_specs, mesh))
    got = dryrun.tensor_bytes(lowered.args)
    vl = dryrun.run_cell("qwen2-vl-7b", "prefill_32k", False, verbose=False)
    return {"argument_bytes": got, "per_device_bytes": want,
            "vl_flops": vl["algo_flops_global"],
            "vl_dev": vl["flops_dev_executed"]}


if __name__ == "__main__":
    if sys.argv[1] == "fake":
        print(json.dumps(fake(int(sys.argv[2]), int(sys.argv[3]))))
    elif sys.argv[1] == "cells":
        print(json.dumps(cells()))
