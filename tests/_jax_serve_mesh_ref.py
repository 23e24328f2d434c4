"""The JAX package's serve-side executors (``jit_prefill_step``,
``jit_serve_step``, ``jit_serve_sample_step``) on host meshes of several
shapes: the reference the port's serve mesh is held against.

Run as a subprocess under ``XLA_FLAGS=--xla_force_host_platform_device_count=4``
(JAX fixes its device count when it starts, and the test process has
started it with one):

  python tests/_jax_serve_mesh_ref.py CASES.pkl OUT.pkl

``CASES.pkl`` holds ``(cases, weights, inputs)`` as the port's lanes get
them (``_torch_serve_worker.serve_job``): each case's arch, config
overrides, cache kind, (data, model) or (pod, data, model) mesh, batch,
prompt length and cache length, its weights (numpy; a quantized leaf as a
mapping of its fields) and its inputs (the prefill batch, the teacher-forced decode tokens, the
sampler's key seeds).  ``OUT.pkl`` gets {name: {"prefill_logits",
"decode_logits", "sample_tokens"}} as numpy, each gathered whole.
"""

from __future__ import annotations

import functools
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from repro.configs import get_config, reduced
from repro.configs.base import ShapeCell
from repro.core.quantization import QuantizedTensor
from repro.launch import steps
from repro.models.model import build_model

_QT = ("q", "scale", "group_size", "bits", "orig_dim")


def config(arch, kv, over):
    cache = "float32" if kv == "f32" else "int8"
    return reduced(get_config(arch)).with_(
        compute_dtype="float32", param_dtype="float32",
        kv_cache_dtype=cache, **over)


def tree(t):
    """A numpy tree back into JAX arrays and ``QuantizedTensor``s."""
    if isinstance(t, dict) and set(t) == set(_QT):
        return QuantizedTensor(q=jnp.asarray(t["q"]),
                               scale=jnp.asarray(t["scale"]),
                               group_size=int(t["group_size"]),
                               bits=int(t["bits"]),
                               orig_dim=int(t["orig_dim"]))
    if isinstance(t, dict):
        return {k: tree(v) for k, v in t.items()}
    return jnp.asarray(t)


def run_case(case, params, inp):
    cfg = config(case["arch"], case["kv"], case["over"])
    model = build_model(cfg)
    shape = tuple(case["mesh"])
    devs = np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    mesh = Mesh(devs, ("pod", "data", "model")[-len(shape):])
    b, s, ms = case["batch"], case["seq"], case["max_seq"]
    batch = {k: jnp.asarray(v) for k, v in inp["batch"].items()}
    quantized = any(isinstance(x, QuantizedTensor) for x in
                    jax.tree_util.tree_leaves(
                        params, is_leaf=lambda x: isinstance(
                            x, QuantizedTensor)))
    start = jax.jit(functools.partial(model.prefill, max_seq=ms))
    out = {}
    with mesh:
        pre, _, _ = steps.jit_prefill_step(
            model, mesh, ShapeCell("prefill", s, b, "prefill"),
            quantized=quantized)
        out["prefill_logits"] = np.asarray(pre(params, batch)[0])
        cell = ShapeCell("decode", ms, b, "decode")
        serve = steps.jit_serve_step(model, mesh, cell, quantized=quantized)[0]
        sample = steps.jit_serve_sample_step(model, mesh, cell,
                                             quantized=quantized)[0]
        cache = start(params, batch)[1]
        logits = []
        for t in inp["tokens"]:
            lg, cache = serve(params, cache, jnp.asarray(t))
            logits.append(np.asarray(lg))
        out["decode_logits"] = logits
        cache = start(params, batch)[1]
        drawn = []
        for t, k in zip(inp["tokens"], inp["keys"]):
            nxt, cache = sample(params, cache, jnp.asarray(t),
                                jax.random.PRNGKey(k))
            drawn.append(np.asarray(nxt))
        out["sample_tokens"] = drawn
    return out


def main(argv):
    with open(argv[0], "rb") as f:
        cases, weights, inputs = pickle.load(f)
    out = {c["name"]: run_case(c, tree(weights[c["weights"]]),
                               inputs[c["name"]]) for c in cases}
    with open(argv[1], "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1:])
