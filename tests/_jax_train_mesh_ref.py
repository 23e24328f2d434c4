"""The JAX package's ``jit_train_step`` on host meshes of several shapes:
the reference the port's mesh training is held against.

Run as a subprocess under ``XLA_FLAGS=--xla_force_host_platform_device_count=4``
(the reference's multi-device idiom: JAX fixes its device count when it
starts, and the test process has started it with one):

  python tests/_jax_train_mesh_ref.py CASES.pkl OUT.pkl

``CASES.pkl`` holds a list of ``(name, arch, overrides, shape, params,
batches, zero)``: the reduced config of ``arch`` in f32 with
``overrides``, the mesh's shape ((data, model), or (pod, data, model)),
the whole parameters (numpy, ``model.init``'s tree) and the batches.  ``OUT.pkl`` gets {name: {"losses", "params"}}: each step's
loss and the final parameters gathered whole, as numpy.
"""

from __future__ import annotations

import pickle
import sys

import jax
import numpy as np
from jax.sharding import Mesh

from repro.configs import get_config, reduced
from repro.configs.base import ShapeCell
from repro.launch import steps
from repro.models.model import build_model
from repro.optim import adamw

STEPS = 5


def run_case(arch, over, shape, params, batches, zero):
    cfg = reduced(get_config(arch)).with_(
        compute_dtype="float32", param_dtype="float32", **over)
    model = build_model(cfg)
    devs = np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    mesh = Mesh(devs, ("pod", "data", "model")[-len(shape):])
    b, s = batches[0]["labels"].shape
    ocfg = adamw.AdamWConfig(warmup_steps=2, decay_steps=STEPS)
    with mesh:
        step, _, _, (s_shard, _) = steps.jit_train_step(
            model, mesh, ocfg, ShapeCell("t", s, b, "train"), zero=zero)
        state = jax.device_put(
            {"params": params, "opt": adamw.init_state(params)}, s_shard)
        losses = []
        for bt in batches:
            state, m = step(state, bt)
            losses.append(float(m["loss"]))
    return {"losses": losses,
            "params": jax.tree_util.tree_map(np.asarray, state["params"])}


def main(argv):
    with open(argv[0], "rb") as f:
        cases = pickle.load(f)
    out = {name: run_case(arch, over, shape, params, batches, zero)
           for name, arch, over, shape, params, batches, zero in cases}
    with open(argv[1], "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1:])
