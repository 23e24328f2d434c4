"""Workers of the open loop on a mesh: the port's ``AsyncServer`` over
``Engine(mesh=make_serve_mesh(world))`` on spawned CPU ranks, one process
a rank (``_torch_mesh_worker.Lane`` runs them as
``Lane("_torch_open_loop_worker:<job>", ...)``).

Every rank reads its own simulated clock (``TickClock``), rank 1's jumping
ahead by a planted offset once the run's start is read
(``SkewedClock``), as two hosts' clocks part while they serve.  Imports
``torch`` and ``repro_torch`` only.
"""

from __future__ import annotations

import numpy as np

from repro_torch.serving.faults import SimClock

ENGINE = dict(max_slots=4, max_seq=64, page_size=4, n_pages=48,
              prefill_chunk_tokens=8)


class TickClock(SimClock):
    """A simulated clock that moves 1 ms each time it is read, so arrivals
    are released between and inside steps, deterministically."""

    def now(self) -> float:
        self._t += 1e-3
        return self._t


class SkewedClock(TickClock):
    """A ``TickClock`` that jumps ``offset`` seconds ahead after its first
    read (the open loop's start): arrivals fall due on it earlier."""

    def __init__(self, offset: float):
        super().__init__()
        self.offset, self.reads = float(offset), 0

    def now(self) -> float:
        self.reads += 1
        return super().now() + (self.offset if self.reads > 1 else 0.0)


def model_and_params():
    """The reduced llama2-110m (f32 compute) and its Q8_0 weights from the
    port's seeded init: the same draw in every process."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.model import build_model
    model = build_model(reduced(get_config("llama2-110m")).with_(
        compute_dtype="float32"))
    return model, model.quantize(model.init(1, device="cpu"))


def workload(n=8, rate=200.0, seed=12):
    """``n`` seeded requests on a Poisson schedule of ``rate`` a second:
    greedy and sampled in turn, 4-6 new tokens each."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(4, 500, size=int(rng.integers(4, 12)))
               .astype(np.int32) for _ in range(n)]
    kws = [dict(max_new_tokens=4 + i % 3, seed=100 + i,
                temperature=0.8 if i % 2 == 0 else 0.0,
                top_p=0.95 if i % 2 == 0 else 1.0) for i in range(n)]
    from repro_torch.serving.async_serving import poisson_arrivals
    offsets = poisson_arrivals(seed=seed, n=n, rate_per_s=rate)
    return [(float(t), p, kw) for t, p, kw in zip(offsets, prompts, kws)]


def streams(handles):
    out = []
    for h in handles:
        req = h.req
        outs = req.outputs if req.outputs is not None else [req.output or []]
        out.append(tuple(tuple(int(t) for t in o) for o in outs))
    return out


def serve_open_loop(clock, mesh=None):
    """The open loop of ``workload()`` on one engine reading ``clock``:
    (its plan log, every request's streams, its report, its arrival
    stamps)."""
    from repro_torch.distribution import collectives as C
    from repro_torch.serving.async_serving import run_open_loop
    from repro_torch.serving.engine import Engine
    model, params = model_and_params()
    eng = Engine(model, params, mesh=mesh,
                 device=None if mesh is not None else "cpu",
                 clock=clock, **ENGINE)
    with C.tally() as calls:
        handles, report = run_open_loop(eng, workload())
    return {"plan_log": list(eng.plan_log), "streams": streams(handles),
            "completed_ok": report.completed_ok,
            "midflight_submits": report.midflight_submits,
            "t_enqueue": [h.req.t_enqueue for h in handles],
            "broadcasts": sum(k == "broadcast" for k, _, _ in calls)}


def open_loop_job(world, offset, share=True):
    """``serve_open_loop`` on a model=world mesh, rank 1's clock skewed by
    ``offset``; with ``share`` False the release broadcast is patched out,
    so each rank releases arrivals by its own clock."""
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.serving.async_serving import AsyncServer
    import torch.distributed as dist
    mesh = make_serve_mesh(world, device="cpu")
    clock = SkewedClock(offset) if dist.get_rank() == 1 else TickClock()
    if not share:
        AsyncServer._released = AsyncServer._pop_due
    return serve_open_loop(clock, mesh)


def unsharded_job(world):
    """``serve_open_loop`` with no mesh on ``TickClock``, in a process of
    its own: the plan log's compile counts are a process's own."""
    return serve_open_loop(TickClock())


def cli_job(world, kw):
    """``serve.run(open_loop=True, mesh_size=world, **kw)``: the completed
    count and every request's streams, by uid."""
    from repro_torch.launch import serve
    _, reqs = serve.run(open_loop=True, mesh_size=world, device="cpu", **kw)
    return cli_result(reqs)


def cli_result(reqs):
    done = sorted(reqs, key=lambda r: r.uid)
    return {"completed": sum(r.error is None for r in done),
            "streams": [[[int(t) for t in o] for o in
                         (r.outputs or [r.output or []])] for r in done]}


JOBS = {"open_loop": open_loop_job, "unsharded": unsharded_job,
        "cli": cli_job}
