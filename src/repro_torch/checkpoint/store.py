"""Atomic, resumable checkpointing (the fault-tolerance substrate).

PyTorch counterpart of ``repro/checkpoint/store.py``, on the same disk
layout, so that a checkpoint written by either package restores in the
other, bit for bit: one directory per step, ``step_XXXXXXXX/host_0.npz``
holding every leaf under the reference's ``jax.tree_util.keystr`` name
(``['params']['blocks']['attn']['wq']``; a ``QuantizedTensor`` as three
arrays, ``|q``, ``|scale`` and ``|meta`` = [group_size, bits, orig_dim]),
and ``manifest_0.json`` with the step, the time and the caller's ``extra``
(the data stream's state).  Writes go to a ``.tmp_step_*`` directory that is
renamed on commit, then ``LATEST`` names the step: a crashed writer never
corrupts the latest checkpoint.

The device-to-host copy of every leaf happens in ``save`` itself; with
``async_`` a background thread does the serialization, so the train loop
blocks only for the copy and may update its tensors in place meanwhile.

On a mesh of more than one rank (``launch/steps.py``'s ``jit_train_step``)
``save`` gathers every leaf whole from the ranks' shards, rank 0 writes
the same files as an unsharded run would (synchronously) and the others
wait for it at a barrier; ``restore`` reads the whole arrays and each rank
keeps its shard.  A checkpoint so crosses between meshes and a world of
one, bit for bit.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.device import Device, resolve_device
from repro_torch.core.quantization import QuantizedTensor
from repro_torch.core.tree import items, keystr, unflatten
from repro_torch.distribution import collectives as C
from repro_torch.distribution import sharding as sh

_SEP = "|"


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` that later in-place writes to ``t`` cannot
    reach (``.cpu()`` alone shares a CPU tensor's memory)."""
    return t.detach().to("cpu", copy=True).numpy()


def _flatten(tree: Any) -> dict:
    out = {}
    for path, leaf in items(tree):
        key = keystr(path)
        if isinstance(leaf, QuantizedTensor):
            out[key + _SEP + "q"] = _host(leaf.q)
            out[key + _SEP + "scale"] = _host(leaf.scale)
            out[key + _SEP + "meta"] = np.array(
                [leaf.group_size, leaf.bits, leaf.orig_dim])
        else:
            out[key] = _host(leaf)
    return out


def save(ckpt_dir: str | os.PathLike, step: int, state: Any,
         extra: Optional[dict] = None, host_id: int = 0,
         async_: bool = False, mesh=None,
         specs: Any = None) -> threading.Thread | None:
    """Write ``state`` for ``step``.  Returns the writer thread if async.
    On a ``mesh`` of more than one rank ``state`` holds the rank's shards
    under ``specs``: every rank gathers the leaves whole, rank 0 writes
    them (``async_`` does not apply) and the others wait for it."""
    if mesh is not None and mesh.size > 1:
        state = sh.gather_tree(state, specs, mesh)
        if mesh.rank == 0:
            save(ckpt_dir, step, state, extra, host_id)
        C.record("barrier", 0, mesh.size)
        dist.barrier(group=mesh.group)
        return None
    root = Path(ckpt_dir)
    final = root / f"step_{step:08d}"
    tmp = root / f".tmp_step_{step:08d}_{host_id}"
    host_arrays = _flatten(state)

    def _write():
        tmp.mkdir(parents=True, exist_ok=True)
        np.savez(tmp / f"host_{host_id}.npz", **host_arrays)
        manifest = {
            "step": step,
            "time": time.time(),
            "host_id": host_id,
            "n_leaves": len(host_arrays),
            "extra": extra or {},
        }
        (tmp / f"manifest_{host_id}.json").write_text(json.dumps(manifest))
        # one host: host 0 commits (several would meet at a barrier first)
        if host_id == 0:
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)
            _update_latest(root, step)

    if async_:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return None


def _update_latest(root: Path, step: int) -> None:
    (root / "LATEST.tmp").write_text(str(step))
    (root / "LATEST.tmp").rename(root / "LATEST")


def latest_step(ckpt_dir: str | os.PathLike) -> Optional[int]:
    """The step ``LATEST`` names if its directory exists, else the newest
    ``step_*`` directory (the marker lost in a crash), else None."""
    root = Path(ckpt_dir)
    marker = root / "LATEST"
    if marker.exists():
        s = int(marker.read_text().strip())
        if (root / f"step_{s:08d}").exists():
            return s
    steps = sorted(int(p.name.split("_")[1]) for p in root.glob("step_*"))
    return steps[-1] if steps else None


def restore(ckpt_dir: str | os.PathLike, state_like: Any,
            step: Optional[int] = None, host_id: int = 0,
            device: Device = None, mesh=None, specs: Any = None):
    """Restore the leaves at the keys of ``state_like`` (a tree whose leaves
    are only read for their kind: tensor or ``QuantizedTensor``) as tensors
    on ``device`` (the card by default), each in its stored dtype.  On a
    ``mesh`` each leaf is cut on the host to the rank's shard under
    ``specs`` before it moves.  Returns (state, step, extra)."""
    if mesh is not None:
        state, step, extra = restore(ckpt_dir, state_like, step, host_id,
                                     "cpu")
        state = sh.shard(state, specs, mesh)
        dev = resolve_device(device)
        return (unflatten(state, [t.to(dev) for _, t in items(state)]),
                step, extra)
    dev = resolve_device(device)
    root = Path(ckpt_dir)
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {root}")
    d = root / f"step_{step:08d}"
    manifest = json.loads((d / f"manifest_{host_id}.json").read_text())

    def tensor(a):
        return torch.from_numpy(np.array(a)).to(dev)

    leaves = []
    with np.load(d / f"host_{host_id}.npz") as data:
        for path, leaf in items(state_like):
            key = keystr(path)
            if isinstance(leaf, QuantizedTensor):
                meta = data[key + _SEP + "meta"]
                leaves.append(QuantizedTensor(
                    q=tensor(data[key + _SEP + "q"]),
                    scale=tensor(data[key + _SEP + "scale"]),
                    group_size=int(meta[0]), bits=int(meta[1]),
                    orig_dim=int(meta[2])))
            else:
                leaves.append(tensor(data[key]))
    return unflatten(state_like, leaves), step, manifest.get("extra", {})


def prune(ckpt_dir: str | os.PathLike, keep: int = 3) -> None:
    """Keep the newest ``keep`` checkpoints (bounded disk)."""
    root = Path(ckpt_dir)
    steps = sorted(root.glob("step_*"), key=lambda p: p.name)
    for p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)
