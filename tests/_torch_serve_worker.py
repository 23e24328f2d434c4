"""Workers of the gloo lane for the serve-side executors: the port's
``jit_prefill_step``, ``jit_serve_step`` and ``jit_serve_sample_step`` on
(data, model) meshes over spawned CPU ranks, one process a rank
(``_torch_mesh_worker.Lane`` runs them as
``Lane("_torch_serve_worker:serve", ...)``).

Imports ``torch`` and ``repro_torch`` only; the parent draws the weights
with the JAX package and hands the workers numpy arrays, which
``bridge.params_from_jax`` carries across.  Every rank runs the unsharded
steps (``make_prefill_step``, ``make_serve_step``,
``make_serve_sample_step``) on the whole batch itself and compares its
gathered results with them bit for bit; rank 0 also hands back what it
gathered, for the comparison with JAX.  The planted faults (``FAULTS``)
each patch one function the steps call.
"""

from __future__ import annotations

import numpy as np
import torch


def config(arch: str, kv: str = "f32", **over):
    """The reduced config of ``arch`` with f32 compute and parameters, an
    f32 (``kv="f32"``) or int8 cache, and ``over`` replaced."""
    from repro_torch.configs import get_config, reduced
    cache = "float32" if kv == "f32" else "int8"
    return reduced(get_config(arch)).with_(
        compute_dtype="float32", param_dtype="float32",
        kv_cache_dtype=cache, **over)


def _numpy(t):
    """A tensor or a tree of them (dicts, tuples) as numpy."""
    if isinstance(t, dict):
        return {k: _numpy(v) for k, v in t.items()}
    if isinstance(t, tuple):
        return tuple(_numpy(v) for v in t)
    return t.detach().cpu().numpy().copy()


def _clone(t):
    if isinstance(t, dict):
        return {k: _clone(v) for k, v in t.items()}
    if isinstance(t, tuple):
        return tuple(_clone(v) for v in t)
    return t.clone()


def _equal(a, b) -> bool:
    """Two trees of tensors bit for bit (the same structure, shapes,
    dtypes and bytes)."""
    if isinstance(a, dict):
        return set(a) == set(b) and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and torch.equal(a, b)


def held_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(held_bytes(v) for v in tree.values())
    if isinstance(tree, tuple):
        return sum(held_bytes(v) for v in tree)
    if hasattr(tree, "scale"):
        return held_bytes(tree.q) + held_bytes(tree.scale)
    return tree.numel() * tree.element_size()


def flat_specs(struct, specs, path: str = "") -> dict:
    """{path: spec} of every leaf of ``struct`` (a quantized leaf's codes
    and scales as ``path/q`` and ``path/scale``): plain data the parent
    reads without the port."""
    if isinstance(struct, dict):
        out = {}
        for k, v in struct.items():
            out.update(flat_specs(v, specs[k], f"{path}/{k}"))
        return out
    if isinstance(struct, tuple):
        out = {}
        for i, (v, sp) in enumerate(zip(struct, specs)):
            out.update(flat_specs(v, sp, f"{path}/{i}"))
        return out
    if hasattr(struct, "scale"):
        return {f"{path}/q": specs.q, f"{path}/scale": specs.scale}
    return {path: tuple(specs)}


# ---------------------------------------------------------------------------
# planted faults: each patches one function the serve steps call
# ---------------------------------------------------------------------------


def _seq_shard_wrong():
    """The new K/V row written on the rank after its owner along the
    sequence split (the owner writes nothing)."""
    from repro_torch.models import transformer
    real = transformer._ServeMesh.seq_slot

    def seq_slot(self, dst, start, n):
        total = n * self.mesh.shape["model"]
        return real(self, dst, (start + n) % total, n)
    return transformer._ServeMesh, "seq_slot", seq_slot


def _kv_heads_rotated():
    """Each rank attends the query heads of the next rank's KV heads
    against its own part of the cache."""
    from repro_torch.models import transformer

    def kv_slice(self, kvh, entry):
        from repro_torch.distribution import sharding as sh
        start, n = sh.shard_range(kvh, entry, self.mesh)
        return (start + n) % kvh, n
    return transformer._ServeMesh, "kv_slice", kv_slice


def _noise_local():
    """The sampler's Gumbel noise keyed on each rank's local vocab index
    (the winner's index still global)."""
    from repro_torch.serving import sampling_distributed as sd
    real = sd._gumbel_at

    def gumbel_at(key, index):
        v = _noise_local.vocab
        rows, cols = index // v, index % v
        per = -(-v // _noise_local.model)
        return real(key, rows * v + cols % per)
    return sd, "_gumbel_at", gumbel_at


def _rows_swapped():
    """The step's rows of the data ranks exchanged: each data rank's
    tokens (and prompts) go to the other's rows of the cache."""
    from repro_torch.distribution import sharding as sh
    from repro_torch.launch import steps
    real = steps._to_rows

    def to_rows(t, spec, dim, want, mesh):
        t = real(t, spec, dim, want, mesh)
        if not sh.live_axes(want, mesh):
            return t
        spec = (None,) * dim + (want,)
        whole = sh.gather(t, spec, mesh)
        half = whole.shape[dim] // sh.parts(want, mesh)
        return sh.shard(torch.roll(whole, half, dims=dim), spec, mesh)
    return steps, "_to_rows", to_rows


FAULTS = {"seq_shard_wrong": _seq_shard_wrong,
          "kv_heads_rotated": _kv_heads_rotated,
          "noise_local": _noise_local,
          "rows_swapped": _rows_swapped}


# ---------------------------------------------------------------------------
# one case
# ---------------------------------------------------------------------------


def inputs(cfg, b: int, s: int, steps: int, seed: int = 0) -> dict:
    """A case's host inputs, drawn from ``seed``: the prefill batch (B, S)
    (stub embeddings for the vlm family, stub frames beside the prompts
    for the audio family), the teacher-forced decode tokens (steps, B)
    and the sampler's key seeds."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(1, cfg.vocab_size, size=(b, s)
                                    ).astype(np.int32)}
    if cfg.family == "vlm":
        batch = {"embeds": rng.standard_normal((b, s, cfg.d_model)
                                               ).astype(np.float32)}
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return {"batch": batch,
            "tokens": rng.integers(1, cfg.vocab_size, size=(steps, b)
                                   ).astype(np.int32),
            "keys": [int(k) for k in rng.integers(0, 1 << 30, size=steps)]}


def _run(model, params, pcell, dcell, inp, mesh, quantized=True):
    """The three steps' results gathered whole (``mesh``) or unsharded
    (None): the prefill's logits and cache; each decode step's logits from
    the prefill of ``dcell.seq_len`` positions, teacher-forced, and the
    cache after them; each sampled step's tokens from the same start, and
    its cache after them."""
    from repro_torch.core import prng
    from repro_torch.distribution import sharding as sh
    from repro_torch.launch import steps
    batch = {k: torch.from_numpy(v) for k, v in inp["batch"].items()}
    toks = torch.from_numpy(inp["tokens"])
    keys = [prng.prng_key(k) for k in inp["keys"]]
    start = model.prefill(params, batch, max_seq=dcell.seq_len)[1]
    out = {}
    if mesh is None:
        out["prefill"] = steps.make_prefill_step(model, pcell.seq_len)(
            params, batch)
        serve = steps.make_serve_step(model)
        sample = steps.make_serve_sample_step(model)
        cache = _clone(start)
        logits = []
        for t in toks:
            lg, cache = serve(params, cache, t)
            logits.append(lg)
        out["decode"] = (logits, cache)
        cache = _clone(start)
        drawn = []
        for t, k in zip(toks, keys):
            nxt, cache = sample(params, cache, t, k)
            drawn.append(nxt)
        out["sample"] = (drawn, cache)
        return out, None
    q = quantized
    pre, pstruct, _ = steps.jit_prefill_step(model, mesh, pcell, q)
    serve, _, cstruct, _ = steps.jit_serve_step(model, mesh, dcell, q)
    sample = steps.jit_serve_sample_step(model, mesh, dcell, q)[0]
    sp_p = steps.serve_specs(model, mesh, pcell, q)
    sp_d = steps.serve_specs(model, mesh, dcell, q)
    sp_s = steps.serve_specs(model, mesh, dcell, q, sample=True)
    shards = sh.shard(params, sp_p.params, mesh)
    lg, cache = pre(shards, steps.shard_batch(inp["batch"], sp_p.batch,
                                              mesh))
    out["prefill"] = (sh.gather(lg, sp_p.logits, mesh),
                      sh.gather_tree(cache, sp_p.cache, mesh))
    info = {"bytes": {
        "params": (held_bytes(shards), per_device(pstruct, sp_p.params,
                                                  mesh)),
        "prefill_cache": (held_bytes(cache),
                          per_device(sp_p.cstruct, sp_p.cache, mesh)),
        "decode_cache": (None, per_device(cstruct, sp_d.cache, mesh))},
        "specs": {"prefill_cache": flat_specs(sp_p.cstruct, sp_p.cache),
                  "decode_cache": flat_specs(cstruct, sp_d.cache),
                  "tokens": sp_d.tokens, "sample_tokens": sp_s.tokens,
                  "logits": sp_d.logits, "batch": sp_p.batch}}
    del cache
    cache = sh.shard(_clone(start), sp_d.cache, mesh)
    info["bytes"]["decode_cache"] = (held_bytes(cache),
                                     info["bytes"]["decode_cache"][1])
    logits = []
    for t in toks:
        lg, cache = serve(shards, cache, sh.shard(t, sp_d.tokens, mesh))
        logits.append(sh.gather(lg, sp_d.logits, mesh))
    out["decode"] = (logits, sh.gather_tree(cache, sp_d.cache, mesh))
    cache = sh.shard(_clone(start), sp_d.cache, mesh)
    drawn = []
    for t, k in zip(toks, keys):
        nxt, cache = sample(shards, cache, sh.shard(t, sp_s.tokens, mesh), k)
        drawn.append(sh.gather(nxt, sp_s.tokens, mesh))
    out["sample"] = (drawn, sh.gather_tree(cache, sp_d.cache, mesh))
    return out, info


def per_device(struct, specs, mesh) -> float:
    from repro_torch.launch.roofline import per_device_bytes
    return per_device_bytes(struct, specs, mesh)


def run_case(case: dict, params_np, inp: dict) -> dict:
    """One case on its mesh: each check bitwise against the unsharded
    steps run here, the specs the wrappers used, the held bytes; rank 0
    of the mesh also hands back its gathered logits and tokens."""
    from repro_torch.bridge import params_from_jax
    from repro_torch.configs import ShapeCell
    from repro_torch.launch.mesh import make_train_mesh
    from repro_torch.models.model import build_model
    cfg = config(case["arch"], case["kv"], **case["over"])
    model = build_model(cfg)
    params = params_from_jax(params_np, device="cpu")
    b, s, ms = case["batch"], case["seq"], case["max_seq"]
    pcell = ShapeCell("prefill", s, b, "prefill")
    dcell = ShapeCell("decode", ms, b, "decode")
    if len(case["mesh"]) == 3:
        from repro_torch.launch.mesh import _build
        mesh = _build(tuple(case["mesh"]), ("pod", "data", "model"), "cpu")
    else:
        mesh = make_train_mesh(*case["mesh"], device="cpu")
    want, _ = _run(model, params, pcell, dcell, inp, None)
    saved = None
    if case.get("fault"):
        _noise_local.vocab = cfg.padded_vocab()
        _noise_local.model = mesh.shape["model"]
        owner, name, fn = FAULTS[case["fault"]]()
        saved = (owner, name, getattr(owner, name))
        setattr(owner, name, fn)
    try:
        got, info = _run(model, params, pcell, dcell, inp, mesh,
                         case["quantized"])
    finally:
        if saved is not None:
            setattr(*saved)
    checks = {
        "prefill_logits": _equal(got["prefill"][0], want["prefill"][0]),
        "prefill_cache": _equal(got["prefill"][1], want["prefill"][1]),
        "decode_logits": all(_equal(a, w) for a, w in
                             zip(got["decode"][0], want["decode"][0])),
        "decode_cache": _equal(got["decode"][1], want["decode"][1]),
        "sample_tokens": all(_equal(a, w) for a, w in
                             zip(got["sample"][0], want["sample"][0])),
        "sample_cache": _equal(got["sample"][1], want["sample"][1])}
    rec = {"checks": checks, **info}
    if mesh.rank == 0:
        rec["got"] = {"prefill_logits": _numpy(got["prefill"][0]),
                      "decode_logits": [_numpy(x) for x in got["decode"][0]],
                      "sample_tokens": [_numpy(x) for x in got["sample"][0]]}
    return rec


def serve_job(world, cases, weights, inputs_):
    """Every case of ``cases`` whose mesh spans ``world`` ranks, in
    order; {name: record}."""
    torch.manual_seed(0)
    return {c["name"]: run_case(c, weights[c["weights"]], inputs_[c["name"]])
            for c in cases}


JOBS = {"serve": serve_job}
