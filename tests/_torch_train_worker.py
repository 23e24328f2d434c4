"""Workers of the gloo lane for training on a mesh: ``jit_train_step`` of
the port on (data, model) meshes over spawned CPU ranks, one process a
rank (``_torch_mesh_worker.Lane`` runs them as
``Lane("_torch_train_worker:<job>", ...)``).

Imports ``torch`` and ``repro_torch`` only; the parent computes the JAX
references and hands the workers numpy arrays.  The planted faults
(``FAULTS``, and the MoE family's ``EXPERT_FAULTS``) patch one collective
of the step each.
"""

from __future__ import annotations

import contextlib
import io

import numpy as np
import torch
import torch.distributed as dist

# the step's collectives, counted a step by kind
KINDS = ("all_reduce", "all_gather", "reduce_scatter", "barrier")

STEPS = 5


def config(arch: str, **over):
    """The reduced config of ``arch`` in f32 (compute and parameters),
    with ``over`` replaced."""
    from repro_torch.configs import get_config, reduced
    return reduced(get_config(arch)).with_(
        compute_dtype="float32", param_dtype="float32", **over)


def ocfg():
    """The schedule of a 5-step ``train.py`` run: warmup 2, decay to 5."""
    from repro_torch.optim import adamw
    return adamw.AdamWConfig(warmup_steps=2, decay_steps=STEPS)


def tensors(tree):
    if isinstance(tree, dict):
        return {k: tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def numpy(tree):
    if isinstance(tree, dict):
        return {k: numpy(v) for k, v in tree.items()}
    return tree.detach().numpy().copy()


def held_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(held_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


@contextlib.contextmanager
def counting():
    """Count every call of ``KINDS`` in ``torch.distributed``."""
    counts = {k: 0 for k in KINDS}
    saved = {k: getattr(dist, k) for k in KINDS}

    def wrap(name, fn):
        def counted(*args, **kwargs):
            counts[name] += 1
            return fn(*args, **kwargs)
        return counted
    for k in KINDS:
        setattr(dist, k, wrap(k, saved[k]))
    try:
        yield counts
    finally:
        for k in KINDS:
            setattr(dist, k, saved[k])


# ---------------------------------------------------------------------------
# planted faults: each drops or misplaces one collective of the step
# ---------------------------------------------------------------------------


def _w2_reduce_dropped():
    """The MLP's row-parallel ``w2`` product left unsummed (*g* dropped)."""
    import copy
    from repro_torch.models import transformer
    real = transformer._TrainTP.mlp

    def mlp(self, p, x, cfg):
        alone = copy.copy(self)
        alone.reduce = lambda y: y
        return real(alone, p, x, cfg)
    return transformer._TrainTP, "mlp", mlp


def _data_reduce_skipped():
    """Each rank's gradients of its own rows, never summed over the data
    axes (ZeRO-1's leaves cut to the rank's slice unsummed)."""
    from repro_torch.core.tree import leaves, unflatten
    from repro_torch.distribution import sharding as sh
    from repro_torch.launch import steps
    from repro_torch.optim import adamw

    def reduce_grads(cfg, grads, specs, mesh, batch_axes=None):
        out = []
        for g, ps, os_ in zip(leaves(grads), leaves(specs["params"]),
                              leaves(specs["opt"]["m"])):
            z = adamw.zero_dim(ps, os_, mesh)
            if z is not None:
                start, n = sh.shard_range(g.shape[z[0]], z[1], mesh)
                g = g.narrow(z[0], start, n).contiguous()
            out.append(g)
        return unflatten(grads, out)
    return steps, "reduce_grads", reduce_grads


def _zero_gather_skipped():
    """ZeRO-1's all-gather after the update skipped: the rank writes back
    its own slice, the others' stay stale."""
    from repro_torch.distribution import sharding as sh
    from repro_torch.optim import adamw

    def gather_zero(p, part, dim, entry, mesh):
        start, n = sh.shard_range(p.shape[dim], entry, mesh)
        p.narrow(dim, start, n).copy_(part)
    return adamw, "gather_zero", gather_zero


def _target_from_own_shard():
    """The label's logit read from every rank's own vocab shard (the
    label's index wrapped into it) and summed."""
    from repro_torch.models import transformer

    def target_logit(self, logits, y, start):
        n = logits.shape[-1]
        return torch.gather(logits, -1, (y % n)[..., None])[..., 0]
    return transformer._TrainTP, "target_logit", target_logit


def _own_rows_grad(y, n, r):
    """``y`` (E/n, n*G, ...) as it is, its gradient kept on the slots of
    block ``r`` of the n alone."""
    keep = torch.zeros(y.shape[1], dtype=y.dtype)
    g = y.shape[1] // n
    keep[r * g:(r + 1) * g] = 1
    keep = keep.view(1, -1, *([1] * (y.dim() - 2)))
    return y * keep + (y * (1 - keep)).detach()


def _expert_sum_skipped():
    """``ep_data``'s experts, split over ``data``: the gradient of an
    expert's results on the other data ranks' slots dropped on the way
    back to its owner (the return all-to-all's backward), so each expert
    slice learns from its own data rank's rows alone."""
    from repro_torch.distribution import collectives as C
    real = C.from_owners

    def from_owners(y, group, n):
        return real(_own_rows_grad(y, n, dist.get_rank(group)), group, n)
    return C, "from_owners", from_owners


def _return_rotated():
    """The return all-to-all sends each rank's slots to the next rank
    along ``data``: every rank combines another rank's rows' results."""
    from repro_torch.distribution import collectives as C
    real = C.from_owners

    def from_owners(y, group, n):
        el, ng = y.shape[:2]
        rolled = y.reshape(el, n, ng // n, *y.shape[2:]).roll(1, dims=1)
        return real(rolled.reshape(y.shape), group, n)
    return C, "from_owners", from_owners


def _expert_w2_sum_skipped():
    """The experts' row-parallel ``w2`` partial sums over ``model`` left
    unsummed (their *g* dropped)."""
    import copy
    from repro_torch.models import transformer
    real = transformer._TrainTP.experts

    def experts(self, p, xin, combine):
        alone = copy.copy(self)
        alone.reduce = lambda y: y
        return real(alone, p, xin, combine)
    return transformer._TrainTP, "experts", experts


def _expert_grad_summed_over_data():
    """Each expert leaf's gradient, whole on its owner, all-reduced over
    ``data`` too, as a replicated leaf's is: every rank's shard takes the
    sum of the data ranks' different experts."""
    from repro_torch.core.tree import items, unflatten
    from repro_torch.distribution import collectives as C
    from repro_torch.launch import steps
    real = steps.reduce_grads

    def reduce_grads(cfg, grads, specs, mesh, batch_axes=None):
        out = real(cfg, grads, specs, mesh, batch_axes)
        group, n, _ = C.axis(mesh, "data")
        return unflatten(out, [
            C.all_reduce(g.contiguous(), group, n)
            if "moe" in k and k[-1] != "router" else g
            for k, g in items(out)])
    return steps, "reduce_grads", reduce_grads


# the dense family's faults; the MoE family's apart
FAULTS = {"w2_reduce_dropped": _w2_reduce_dropped,
          "data_reduce_skipped": _data_reduce_skipped,
          "zero_gather_skipped": _zero_gather_skipped,
          "target_from_own_shard": _target_from_own_shard}
EXPERT_FAULTS = {"expert_sum_skipped": _expert_sum_skipped,
                 "return_rotated": _return_rotated,
                 "expert_w2_sum_skipped": _expert_w2_sum_skipped,
                 "expert_grad_summed_over_data":
                     _expert_grad_summed_over_data}


@contextlib.contextmanager
def planted(name):
    if name is None:
        yield
        return
    obj, attr, fn = {**FAULTS, **EXPERT_FAULTS}[name]()
    real = getattr(obj, attr)
    setattr(obj, attr, fn)
    try:
        yield
    finally:
        setattr(obj, attr, real)


# ---------------------------------------------------------------------------
# jobs
# ---------------------------------------------------------------------------


def _expert_shapes(tree, specs, whole, mesh):
    """{path: (held shape, the shard's shape)} of every expert bank of
    ``tree`` (the rank's shards of ``whole``'s leaves under ``specs``)."""
    from repro_torch.core.tree import items, keystr, leaves
    from repro_torch.distribution import sharding as sh
    out = {}
    for (k, t), spec, w in zip(items(tree), leaves(specs), leaves(whole)):
        if "moe" in k and k[-1] != "router":
            want = tuple(sh.shard_range(d, e, mesh)[1] if e else d
                         for d, e in zip(w.shape, spec))
            out[keystr(k)] = (tuple(t.shape), want)
    return out


def _train(cfg, mesh, params_np, batches, zero=True, fault=None):
    """``jit_train_step`` on ``mesh`` from the whole ``params_np`` over
    ``batches``: (losses, grad norms, step-1 gradients gathered whole, the
    final parameters gathered whole, held bytes against
    ``per_device_bytes``, collectives a step by kind, the collective tally
    of the step-1 gradients (``train_grads``: the forward, the backward
    and their reduction), the leaves the specs split, and for the MoE family
    each expert bank's held shape against its shard's, before the steps,
    of its step-1 gradient and after the steps)."""
    from repro_torch.configs import ShapeCell
    from repro_torch.core.tree import leaves
    from repro_torch.distribution import collectives as C
    from repro_torch.distribution import sharding as sh
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    from repro_torch.launch.roofline import per_device_bytes
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    model = build_model(cfg)
    b, s = batches[0]["labels"].shape
    step, sstruct, _, (sspecs, bspecs) = steps.jit_train_step(
        model, mesh, ocfg(), ShapeCell("t", s, b, "train"), zero=zero)
    params = tensors(params_np)
    state = sh.shard({"params": params, "opt": adamw.init_state(params)},
                     sspecs, mesh)
    baxes = sh.train_batch_axes(cfg, mesh, b)
    out = {"bytes": (held_bytes(state),
                     per_device_bytes(sstruct, sspecs, mesh)),
           "batch_axes": baxes,
           "split_leaves": sum(any(sh.live_axes(e, mesh) for e in spec)
                               for spec in leaves(sspecs["params"]))}
    experts = {"start": _expert_shapes(state["params"], sspecs["params"],
                                       params, mesh)}
    with planted(fault):
        with C.tally() as calls:
            _, g1 = steps.train_grads(
                model, state["params"], steps.shard_batch(batches[0], bspecs,
                                                          mesh),
                1, mesh, sspecs, baxes)
        out["grad_tally"] = list(calls)
        experts["grad"] = _expert_shapes(g1, sspecs["params"], params, mesh)
        out["grads"] = numpy(sh.gather_tree(g1, sspecs["opt"]["m"], mesh))
        losses, norms = [], []
        with counting() as counts:
            for bt in batches:
                state, m = step(state, steps.shard_batch(bt, bspecs, mesh))
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
    experts["end"] = _expert_shapes(state["params"], sspecs["params"],
                                    params, mesh)
    out["experts"] = experts
    if cfg.family in transformer.TP_FAMILIES and cfg.train_shard == "tp":
        tp = transformer.train_view(state["params"], cfg, mesh,
                                    sspecs["params"], baxes)[1]
        out["layout"] = (tp.attn, tp.kv_whole, tp.mlp_split, tp.vocab_split)
        out["expert_axis"] = tp.expert_axis
    out.update(losses=losses, grad_norms=norms,
               collectives={k: v / len(batches) for k, v in counts.items()},
               params=numpy(sh.gather_tree(state["params"],
                                           sspecs["params"], mesh)),
               zero_split=[str(k) for k, (p, o) in _zipped(sspecs)
                           if adamw.zero_dim(p, o, mesh) is not None])
    return out


def _zipped(sspecs):
    from repro_torch.core.tree import items, leaves
    return [(k, (p, o)) for (k, p), o in zip(items(sspecs["params"]),
                                             leaves(sspecs["opt"]["m"]))]


def batches_for(cfg, b=4, s=32, n=STEPS, seed=0):
    """``n`` seeded batches of ``b`` x ``s``: tokens and labels, and a
    frontend's stub frames for the audio family; the vlm family's stub
    patch embeddings in place of the tokens (the train cell's inputs,
    ``steps.input_specs``)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        bt = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                  np.int32),
              "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                  np.int32)}
        if cfg.family == "vlm":
            bt["embeds"] = rng.standard_normal(
                (b, s, cfg.d_model)).astype(np.float32)
            del bt["tokens"]
        if cfg.family == "audio":
            bt["frames"] = rng.standard_normal(
                (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
        out.append(bt)
    return out


def init_numpy(arch, **over):
    """The port's seeded init (seed 0) of ``config(arch, **over)``, as
    numpy: the weights both packages start from."""
    from repro_torch.models.model import build_model
    return numpy(build_model(config(arch, **over)).init(0, device="cpu"))


def train_job(world, cases):
    """Each case ``(name, arch, overrides, shape, zero, fault[, batch])``
    on its mesh over the first ranks of the world (``shape`` (data,
    model), or (pod, data, model)), from ``init_numpy``'s weights over
    ``batches_for``'s batches of ``batch`` rows (4 by default); a rank
    outside a smaller mesh goes on to the next case.  Rank 0's results by
    name; the other ranks' losses, bytes and expert shapes alone."""
    from repro_torch.launch.mesh import make_train_mesh
    out = {}
    for name, arch, over, shape, zero, fault, *rest in cases:
        pod = shape[0] if len(shape) == 3 else 1
        try:
            mesh = make_train_mesh(*shape[-2:], device="cpu", pod=pod)
        except ValueError:
            continue                    # outside: it helped make the groups
        cfg = config(arch, **over)
        res = _train(cfg, mesh, init_numpy(arch, **over),
                     batches_for(cfg, *rest), zero, fault)
        out[name] = res if dist.get_rank() == 0 else {
            k: res[k] for k in ("losses", "bytes", "experts")}
    return out


def _checkpoints(mesh, params_np, batches, whole_dir, mesh_dir):
    """3 steps, a checkpoint at step 3 (``store.save`` of the shards) and
    the state gathered whole, to hold against that checkpoint restored in
    a world of one; and the world of one's checkpoint in ``whole_dir``
    restored on the mesh, against its shards cut from the whole arrays."""
    from repro_torch.checkpoint import store
    from repro_torch.configs import ShapeCell
    from repro_torch.core.tree import items
    from repro_torch.distribution import sharding as sh
    from repro_torch.launch import steps
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    model = build_model(config("llama2-110m"))
    b, s = batches[0]["labels"].shape
    step, sstruct, _, (sspecs, bspecs) = steps.jit_train_step(
        model, mesh, ocfg(), ShapeCell("t", s, b, "train"))
    params = tensors(params_np)
    state = sh.shard({"params": params, "opt": adamw.init_state(params)},
                     sspecs, mesh)
    for bt in batches[:3]:
        state, _ = step(state, steps.shard_batch(bt, bspecs, mesh))
    store.save(mesh_dir, 3, state, mesh=mesh, specs=sspecs)
    whole = numpy(sh.gather_tree(state, sspecs, mesh))
    back, at, _ = store.restore(whole_dir, sstruct, device="cpu", mesh=mesh,
                                specs=sspecs)
    cut = sh.shard(store.restore(whole_dir, sstruct, device="cpu")[0],
                   sspecs, mesh)
    return {"whole": whole if mesh.rank == 0 else None, "restored_step": at,
            "restored_shards_equal": all(
                a.shape == c.shape and torch.equal(a, c)
                for (_, a), (_, c) in zip(items(back), items(cut))),
            "split_leaves": sum(a.shape != w.shape for (_, a), (_, w) in
                                zip(items(back), items(sstruct)))}


def lifecycle_job(world, params_np, batches, whole_dir, mesh_dir, run_kw,
                  argv):
    """On the world's 1 x 2 mesh: ``_checkpoints``; ``train.run(**run_kw)``
    twice on one checkpoint directory (the second resumes where the
    first's last checkpoint left it), each run's losses and steps; and
    ``train.main(argv)``, what this rank printed."""
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_train_mesh
    out = {"ckpt": _checkpoints(make_train_mesh(1, 2, device="cpu"),
                                params_np, batches, whole_dir, mesh_dir)}
    runs = []
    for _ in range(2):
        recs = []
        losses = train.run(**run_kw, device="cpu",
                           on_step=lambda r: recs.append(r["step"]))
        runs.append({"losses": losses, "steps": recs})
    out["runs"] = runs
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(argv)
    out["stdout"] = buf.getvalue()
    return out


JOBS = {"train": train_job, "lifecycle": lifecycle_job}
