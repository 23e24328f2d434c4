"""Workers of the gloo lane: the port's mesh in several processes on the
CPU, one rank each, as ``torchrun`` would start them.

Imports ``torch`` and ``repro_torch`` only: ``spawn`` re-imports this
module in every worker, and JAX stays in the parent, which computes the
references and hands the workers numpy arrays.  A job's result is pickled
per rank into the run's directory; ``Lane.finish`` collects them, and a
worker that raised hands its traceback back instead.
"""

from __future__ import annotations

import contextlib
import datetime
import gc
import importlib
import io
import multiprocessing as mp
import os
import pickle
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

# a collective waits this long for a peer that diverged or died
GROUP_TIMEOUT_S = 60
# the reductions the serving path must never call
REDUCTIONS = ("all_reduce", "reduce", "reduce_scatter",
              "reduce_scatter_tensor", "all_reduce_coalesced")


def _watch_reductions() -> dict:
    """Count every call of a float reduction of ``torch.distributed``."""
    counts = {name: 0 for name in REDUCTIONS}

    def wrap(name, fn):
        def counted(*args, **kwargs):
            counts[name] += 1
            return fn(*args, **kwargs)
        return counted

    for name in REDUCTIONS:
        if hasattr(dist, name):
            setattr(dist, name, wrap(name, getattr(dist, name)))
    return counts


def _entry(rank, world, init_file, out_dir, job, args_file):
    os.environ["RANK"], os.environ["WORLD_SIZE"] = str(rank), str(world)
    torch.set_num_threads(1)
    out = {"rank": rank}
    try:
        with open(args_file, "rb") as f:
            args = pickle.load(f)
        dist.init_process_group(
            "gloo", init_method=f"file://{init_file}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        counts = _watch_reductions()
        out["result"] = _job(job)(world, **args)
        out["reductions"] = counts
    except BaseException:                           # noqa: BLE001
        out["error"] = traceback.format_exc()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(os.path.join(out_dir, f"{job}_{world}_{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _job(job: str):
    """A job of this module by name, or ``module:name``, a job of another
    worker module's ``JOBS``."""
    mod, _, name = job.rpartition(":")
    return (importlib.import_module(mod).JOBS if mod else JOBS)[name]


class Lane:
    """``world`` spawned ranks running ``job``; :meth:`finish` joins them
    by a deadline (a hang fails its test, not the suite) and returns each
    rank's result.  The job's arguments reach the ranks in a file: a start
    whose pickled arguments outgrow the pipe would wait for its child to
    import everything before the next rank could start."""

    def __init__(self, job: str, world: int, tmp_dir, **args):
        self.job, self.world, self.dir = job, world, str(tmp_dir)
        os.makedirs(self.dir, exist_ok=True)
        init_file = os.path.join(self.dir, f"init_{job}_{world}")
        args_file = os.path.join(self.dir, f"args_{job}_{world}.pkl")
        with open(args_file, "wb") as f:
            pickle.dump(args, f)
        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(target=_entry,
                                  args=(r, world, init_file, self.dir, job,
                                        args_file), daemon=True)
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def finish(self, deadline_s: float) -> list:
        end = time.monotonic() + deadline_s
        for p in self.procs:
            p.join(max(0.0, end - time.monotonic()))
        hung = [p for p in self.procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join(5)
        if hung:
            raise TimeoutError(f"{len(hung)} of {self.world} ranks of "
                               f"{self.job} still running after "
                               f"{deadline_s} s")
        outs = []
        for r in range(self.world):
            path = os.path.join(self.dir, f"{self.job}_{self.world}_{r}.pkl")
            if not os.path.exists(path):
                raise RuntimeError(f"rank {r} of {self.job} wrote no result "
                                   f"(exit code {self.procs[r].exitcode})")
            with open(path, "rb") as f:
                outs.append(pickle.load(f))
        errors = [o["error"] for o in outs if "error" in o]
        if errors:
            raise RuntimeError("\n".join(errors))
        return outs


# ---------------------------------------------------------------------------
# jobs
# ---------------------------------------------------------------------------


def held_bytes(tree) -> int:
    """Bytes the tensors of a tree hold as they are seen (a view counts
    its own extent; a quantized leaf its codes and scales)."""
    if isinstance(tree, dict):
        return sum(held_bytes(v) for v in tree.values())
    if hasattr(tree, "scale"):
        return held_bytes(tree.q) + held_bytes(tree.scale)
    return tree.numel() * tree.element_size()


def replicated(tree):
    """The spec tree of ``tree`` replicated on every rank."""
    if isinstance(tree, dict):
        return {k: replicated(v) for k, v in tree.items()}
    if hasattr(tree, "scale"):
        import dataclasses
        return dataclasses.replace(tree, q=(None,) * tree.q.dim(),
                                   scale=(None,) * tree.scale.dim())
    return (None,) * tree.dim()


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


PROMPT_SIZES = (5, 9, 17, 12)


def prompts(seed=0, sizes=PROMPT_SIZES):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 300, size=n).astype(np.int32) for n in sizes]


def serve(model, params, mesh, *, greedy=True, n_samples=1, n_pages=48,
          max_new=8, prompt_list=None, repeats=1, engine=None):
    """The reference test's ``_serve``: streams (one tuple of sibling
    streams a request) and the engine.  ``engine`` builds it (the port's
    on the CPU, or on the mesh's device, by default)."""
    if engine is None:
        from repro_torch.serving.engine import Engine

        def engine(model, params, **kw):
            return Engine(model, params, mesh=mesh,
                          device=None if mesh is not None else "cpu", **kw)
    eng = engine(model, params, max_slots=4, max_seq=64, page_size=4,
                 n_pages=n_pages, prefill_chunk_tokens=8)
    uids, done = [], {}
    for _ in range(repeats):
        for i, pr in enumerate(prompt_list or prompts()):
            uids.append(eng.submit(
                pr, max_new_tokens=max_new,
                temperature=0.0 if greedy else 0.9,
                top_p=1.0 if greedy else 0.95,
                seed=7 + i, n_samples=n_samples))
        done.update({r.uid: r for r in eng.run()})
    streams = []
    for u in uids:
        r = done[u]
        assert r.error is None, r.error
        streams.append(tuple(tuple(int(t) for t in o) for o in r.outputs))
    return streams, eng


# the sharded-serving cases: name -> the keywords of ``serve``
CASES = {
    "greedy": dict(greedy=True),
    "sampled": dict(greedy=False),
    "warm": dict(prompt_list=prompts(sizes=(16, 12)), repeats=2),
    "fork": dict(greedy=False, n_samples=3, n_pages=64,
                 prompt_list=prompts(sizes=(7, 11))),
    "preempt": dict(n_pages=12, max_new=6,
                    prompt_list=prompts(sizes=(9, 13, 11, 8))),
}
METRICS = ("prefix_hits", "prefix_cached_tokens", "fanouts", "cow_copies",
           "preemptions", "tokens_out", "requests_done", "decode_steps",
           "chunk_batch_calls", "prefill_chunks", "energy_joules",
           "prefix_attn_bytes")


def model_for(kind: str, params_np):
    """The reduced llama2-110m of the sharded-serving tests: f32 weights
    and pool, or Q8_0 weights (fused operands) and an int8 pool; or
    ``"gqa"``, its 4 query heads over 2 KV heads, f32, the port's own
    seeded init (the same draw in every process): at model size 4 the KV
    heads do not divide the axis and the pool degrades to replication."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.model import build_model
    cfg = reduced(get_config("llama2-110m")).with_(compute_dtype="float32")
    if kind == "gqa":
        model = build_model(cfg.with_(n_kv_heads=2))
        return model, model.init(1, device="cpu")
    if kind == "int8":
        cfg = cfg.with_(kv_cache_dtype="int8")
    model = build_model(cfg)
    params = _tensors(params_np)
    if kind == "int8":
        params = model.quantize(params)
    return model, params


# the cases the GQA model serves (``model_for("gqa")``)
GQA_CASES = ("greedy", "sampled")


def case_record(streams, eng) -> dict:
    return {"streams": streams,
            "metrics": {k: eng.metrics[k] for k in METRICS},
            "leaks": sum(rc != 0 for rc in eng.pager.refcount),
            "free": eng.pager.n_free() == eng.pager.cfg.n_blocks,
            "audit_clean": eng.pager.audit().clean}


def serving_job(world, params_np, kinds=("f32", "int8")):
    """Every case of the sharded-serving tests on a model=world mesh, for
    each kind of weights and pool; the compile probe; each rank's held
    bytes against ``per_device_bytes`` of its specs."""
    from repro_torch.distribution import sharding as sh
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.launch.roofline import per_device_bytes
    from repro_torch.models import transformer
    from repro_torch.serving.engine import Engine
    mesh = make_serve_mesh(world, device="cpu")
    out = {}
    for kind in kinds:
        model, params = model_for(kind, params_np)
        rec = {}
        for name, kw in CASES.items():
            rec[name] = case_record(*serve(model, params, mesh, **kw))
        probe = Engine(model, params, max_slots=4, max_seq=64, page_size=4,
                       n_pages=48, prefill_chunk_tokens=8, mesh=mesh)
        c0 = probe.prefill_compile_count()
        _, eng = serve(model, params, mesh)
        c1 = eng.prefill_compile_count()
        _, eng2 = serve(model, params, mesh, greedy=False,
                        prompt_list=prompts(seed=5, sizes=(3, 21, 8)))
        rec["compiles"] = (c0, c1, eng2.prefill_compile_count())
        # held bytes: the weights' shards and the pool's KV-head slice
        cfg = model.cfg
        pspecs = (sh.param_specs(cfg, params, mesh, mode="serve")
                  if mesh.shape["model"] > 1 else replicated(params))
        held = (eng.params.tree if isinstance(eng.params, sh.Sharded)
                else eng.params)
        full_pool = transformer.init_paged_cache(
            cfg, 4, block_size=4, n_blocks=48, max_blocks_per_seq=16,
            device="meta")
        rec["bytes"] = {
            "params_held": held_bytes(held),
            "params_specs": per_device_bytes(params, pspecs, mesh),
            "pool_held": held_bytes(eng.cache["attn"]),
            "pool_specs": per_device_bytes(
                full_pool["attn"],
                sh.cache_specs(cfg, full_pool, mesh)["attn"], mesh),
            "pool_full": held_bytes(full_pool["attn"])}
        out[kind] = rec
    model, params = model_for("gqa", None)
    eng = None
    out["gqa"] = {}
    for name in GQA_CASES:
        streams, eng = serve(model, params, mesh, **CASES[name])
        out["gqa"][name] = case_record(streams, eng)
    out["gqa"]["pool_split"] = (eng.cache["attn"]["k"].shape[3]
                                < model.cfg.n_kv_heads)
    return out


def _storages(tree) -> set:
    """The storages the tensors of a tree lie in."""
    if isinstance(tree, dict):
        return set().union(*(_storages(v) for v in tree.values()))
    if hasattr(tree, "scale"):
        return _storages(tree.q) | _storages(tree.scale)
    return {tree.untyped_storage().data_ptr()}


def _live_tensors(eng) -> list:
    """(shape, dtype) of every tensor alive in this process but those in
    the storages of ``eng``'s weights and pool."""
    gc.collect()
    own = _storages(eng.params.tree) | _storages(eng.cache)
    return [(tuple(o.shape), o.dtype) for o in gc.get_objects()
            if isinstance(o, torch.Tensor)
            and o.untyped_storage().data_ptr() not in own]


def _split_leaves(struct, specs, mesh) -> list:
    """(shape, dtype) of each whole leaf (codes and scales apart) of
    ``struct`` that ``specs`` split on ``mesh``."""
    from repro_torch.distribution import sharding as sh
    out = []

    def visit(t, spec):
        if isinstance(t, dict):
            for k in t:
                visit(t[k], spec[k])
        elif hasattr(t, "scale"):
            visit(t.q, spec.q)
            visit(t.scale, spec.scale)
        elif any(sh.live_axes(e, mesh) for e in spec):
            out.append((tuple(t.shape), t.dtype))
    visit(struct, specs)
    return out


def cli_job(mesh_size):
    """``serve.main`` with ``--mesh``: its printed lines and streams; on a
    mesh of more than one, what the rank holds as its engine starts to
    run: the whole leaves the specs split that are alive then, outside
    the engine's weights and pool (a shard of one leaf may have the shape
    of another leaf whole), the bytes
    of its shards and the bytes ``serve.py`` checked against the device."""
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch.steps import params_struct
    seen = {}

    class Probe(serve_cli.Engine):
        def run(self, *args, **kwargs):
            if self.mesh is not None and self.mesh.size > 1:
                seen["live"] = _live_tensors(self)
            return super().run(*args, **kwargs)

    buf = io.StringIO()
    serve_cli.Engine = Probe
    try:
        with contextlib.redirect_stdout(buf):
            eng, done = serve_cli.main(
                ["--mesh", str(mesh_size), "--device", "cpu", "--requests",
                 "3", "--max-new", "6", "--max-seq", "96"])
    finally:
        serve_cli.Engine = Probe.__bases__[0]
    out = {"stdout": buf.getvalue(),
           "streams": [[list(map(int, o)) for o in r.outputs]
                       for r in sorted(done, key=lambda r: r.uid)]}
    if mesh_size > 1:
        policy = QuantPolicy(bits=8, min_size=512)
        whole = _split_leaves(params_struct(eng.model, True, policy),
                              eng.params.specs, eng.mesh)
        out["memory"] = {
            "split_leaves": len(whole),
            "whole_alive": sum(x in whole for x in seen["live"]),
            "held": held_bytes(eng.params.tree),
            "checked": serve_cli._held_bytes(eng.model, policy, eng.mesh),
            "whole_tree": serve_cli._held_bytes(eng.model, policy)}
    return out


def sampling_job(world, logits, cases, vocab):
    """The vocab-sharded sampler on a model=world mesh: each rank samples
    its slice of ``logits``; the tokens of every (seed, temperature,
    top_p, k) case."""
    from repro_torch.core import prng
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.serving import sampling_distributed as sd
    mesh = make_serve_mesh(world, device="cpu")
    start, n = sd.vocab_range(vocab, mesh)
    local = torch.from_numpy(np.array(logits))[:, start:start + n]
    toks = []
    for seed, t, p, k in cases:
        key = prng.prng_key(seed)
        toks.append(sd.distributed_sample(key, local, t, p, k, mesh=mesh,
                                          vocab_size=vocab).tolist())
    return toks


JOBS = {"serving": serving_job, "sampling": sampling_job, "cli": cli_job}
