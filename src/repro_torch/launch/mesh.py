"""Device meshes over ``torch.distributed``.

PyTorch counterpart of ``repro/launch/mesh.py``.  JAX is single-controller:
one process addresses every device of a ``jax.sharding.Mesh``.  PyTorch is
multi-controller: a mesh of n devices is n processes, one per device, in
one process group, and a :class:`Mesh` is one rank's view of it: the axis
names and sizes (``shape``, a dict, as the spec rules of
``distribution/sharding.py`` read it), the rank's coordinate along each
axis, and a process group per axis holding the ranks that differ from this
one along that axis alone.

The groups run NCCL on the card and gloo on the CPU (``core/device``'s
``resolve_device`` picks the device: the card unless the caller asks for
the CPU).  A process group started elsewhere (``torchrun``, a test's
``init_process_group``) is used as it is; with none, a mesh of one starts a
world of one by itself, over a ``FileStore`` in a temporary directory.
With a card present a failed NCCL start is an error, never a switch to
gloo.

A dry run (``launch/dryrun.py``) starts a fake world instead
(:func:`dryrun_world`): torch's ``FakeProcessGroup``, n ranks seen from
rank 0, whose collectives move nothing.  Meshes built in it compute on
``meta``: the counterpart of the reference's 512 placeholder host
devices, with the data abstracted in place of the devices.

Defined as functions, not module constants: importing this module starts
nothing.
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
import math
import os
import tempfile
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.device import Device, resolve_device
from repro_torch.distribution import collectives as C

# seconds a collective may wait for its peers before it fails: a rank that
# diverged or died ends the others' wait with an error, not a hang
TIMEOUT_S = 300


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """One rank's view of a device mesh: ``axis_names`` in order, ``shape``
    {axis: size}, ``coords`` {axis: this rank's index}, ``groups`` {axis:
    the process group along it, None where the axis has size 1},
    ``group`` the process group of the whole mesh (the world's when the
    mesh spans it, a world of one included), ``device`` where this rank
    computes, ``host_group`` a gloo group of the whole mesh for what only
    the hosts exchange (``collectives.from_rank0``) where ``group`` runs
    NCCL on a mesh of more than one, else None: ``group`` itself is on the
    host, or nothing is exchanged."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[str, Any]
    group: Any
    device: torch.device
    host_group: Any = None

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def rank(self) -> int:
        """This rank's index in the mesh, row-major over ``axis_names``."""
        r = 0
        for a in self.axis_names:
            r = r * self.shape[a] + self.coords[a]
        return r


def backend_for(dev: torch.device) -> str:
    if dev.type == "meta":
        return "fake"
    return "nccl" if dev.type == "cuda" else "gloo"


def is_fake() -> bool:
    """Whether the running world is a dry run's fake one."""
    return dist.is_initialized() and dist.get_backend() == "fake"


def _fake_pg(common_opts, backend_opts):
    from torch._C._distributed_c10d import FakeProcessGroup
    make = getattr(FakeProcessGroup, "_create_internal", FakeProcessGroup)
    return make(common_opts.group_rank, common_opts.group_size, backend_opts)


def dryrun_world(n: int) -> None:
    """Start a fake world of ``n`` ranks as rank 0 (torch's
    ``FakeProcessGroup`` under ``dist.Backend.FAKE``, over a
    ``HashStore``): its collectives move nothing and return at once, so a
    step traced on meta tensors runs as rank 0 of an n-rank mesh would.
    The backend is registered here, on first use, never at import."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already running; a dry run "
                           "needs a process of its own")
    dist.Backend.register_backend(getattr(dist.Backend, "FAKE", "fake"),
                                  _fake_pg, extended_api=True,
                                  devices=["cpu", "cuda", "meta"])
    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=n)


def _timeout() -> datetime.timedelta:
    return datetime.timedelta(seconds=TIMEOUT_S)


def ensure_world(dev: torch.device) -> None:
    """The default process group, started here if none is: from
    ``torchrun``'s environment when it names a world of more than one,
    else a world of one over a ``FileStore`` in a temporary directory.  Its
    backend must be the device's: NCCL for the card, gloo for the CPU,
    a dry run's fake world (:func:`dryrun_world`) for ``meta``."""
    if not dist.is_initialized():
        backend = backend_for(dev)
        if backend == "fake":
            dryrun_world(1)
        elif int(os.environ.get("WORLD_SIZE", "1")) > 1:
            dist.init_process_group(backend, init_method="env://",
                                    timeout=_timeout())
        else:
            if backend == "nccl":
                # one process: NCCL's bootstrap socket on the loopback
                # interface, the only one a world of one needs
                os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
            store = dist.FileStore(
                os.path.join(tempfile.mkdtemp(prefix="repro_torch_mesh_"),
                             "store"), 1)
            dist.init_process_group(backend, store=store, rank=0,
                                    world_size=1, timeout=_timeout())
    got = dist.get_backend()
    if got != backend_for(dev):
        raise ValueError(f"a mesh on {dev} needs the {backend_for(dev)} "
                         f"backend; the process group runs {got}")


def world_size() -> int:
    """Ranks in the world: the process group's, or ``torchrun``'s
    ``WORLD_SIZE`` (1 without it) before one is started."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def _device(device: Device) -> torch.device:
    if device is None and is_fake():
        return torch.device("meta")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        # one card per rank: torchrun's local rank picks it
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    return dev


def _build(shape: Tuple[int, ...], axes: Tuple[str, ...],
           device: Device) -> Optional[Mesh]:
    """A mesh of ``shape`` over the first ``prod(shape)`` ranks of the
    world, row-major.  Every rank of the world takes part in making the
    groups (``new_group`` is collective); a rank outside the mesh gets
    None."""
    dev = _device(device)
    ensure_world(dev)
    n, world, me = math.prod(shape), dist.get_world_size(), dist.get_rank()

    def group_of(ranks):
        if len(ranks) == world:
            return dist.group.WORLD
        if len(ranks) == 1:
            return None
        return dist.new_group(list(ranks), timeout=_timeout())

    coords = (dict(zip(axes, _unravel(me, shape))) if me < n else None)
    groups: Dict[str, Any] = {}
    for i, a in enumerate(axes):
        others = [range(s) for j, s in enumerate(shape) if j != i]
        for rest in itertools.product(*others):
            line = []
            for c in range(shape[i]):
                idx = list(rest)
                idx.insert(i, c)
                line.append(_ravel(idx, shape))
            g = group_of(line) if shape[i] > 1 else None
            if coords is not None and me in line:
                groups[a] = g
    whole = group_of(list(range(n)))
    # the hosts' decisions must not queue behind the card's work on
    # NCCL's stream: they go over gloo
    host = (dist.new_group(list(range(n)), timeout=_timeout(),
                           backend="gloo")
            if n > 1 and dist.get_backend() == "nccl" else None)
    if coords is None:
        return None
    mesh = Mesh(axis_names=axes, shape=dict(zip(axes, shape)),
                coords=coords, groups=groups, group=whole, device=dev,
                host_group=host)
    if dev.type != "meta":
        # a fake world has nothing to exchange
        _handshake(mesh)
    return mesh


def _unravel(r: int, shape) -> Tuple[int, ...]:
    out = []
    for s in reversed(shape):
        out.append(r % s)
        r //= s
    return tuple(reversed(out))


def _ravel(idx, shape) -> int:
    r = 0
    for c, s in zip(idx, shape):
        r = r * s + c
    return r


def _handshake(mesh: Mesh) -> None:
    """Every rank's mesh index, all-gathered over the mesh's group on its
    device: the group works (NCCL's communicator is made here, on the
    card), and the ranks agree on their order."""
    me = torch.tensor([mesh.rank], dtype=torch.int64, device=mesh.device)
    if mesh.group is None:
        parts = [me.clone()]
    else:
        parts = [torch.empty_like(me) for _ in range(mesh.size)]
        C.record("all-gather", mesh.size * C.nbytes(me), mesh.size)
        dist.all_gather(parts, me, group=mesh.group)
    got = [int(p) for p in parts]
    if got != list(range(mesh.size)):
        raise RuntimeError(f"mesh ranks disagree on their order: {got}")


def make_production_mesh(*, multi_pod: bool = False,
                         device: Device = None) -> Mesh:
    """(data=16, model=16), or (pod=2, data=16, model=16): only in a world
    of exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if world_size() != math.prod(shape):
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs "
                         f"{math.prod(shape)} ranks; the world has "
                         f"{world_size()}")
    return _build(shape, axes, device)


def make_host_mesh(device: Device = None) -> Mesh:
    """(data=1, model=W) over the whole world (W ranks; 1 without a
    process group)."""
    return _build((1, world_size()), ("data", "model"), device)


def make_train_mesh(data: int, model: int, device: Device = None,
                    pod: int = 1) -> Mesh:
    """(data, model) over the first ``data * model`` ranks of the world,
    row-major: the meshes of 2 x 1, 1 x 2, 2 x 2 and 1 x 4 the gloo tests
    train on; with ``pod`` > 1, (pod, data, model), the multi-pod mesh's
    axes.  ``ValueError`` when the world is smaller (before any process
    group is started) or when this rank lies outside."""
    shape, axes = (data, model), ("data", "model")
    if pod > 1:
        shape, axes = (pod, *shape), ("pod", *axes)
    n, name = math.prod(shape), " x ".join(map(str, shape))
    if not 1 <= n <= world_size():
        raise ValueError(f"a {name} mesh needs {n} ranks; the "
                         f"world has {world_size()}")
    mesh = _build(shape, axes, device)
    if mesh is None:
        raise ValueError(f"rank {dist.get_rank()} is outside a {name} mesh")
    return mesh


def make_serve_mesh(model_size: Optional[int] = None,
                    device: Device = None) -> Mesh:
    """Serving mesh: (data=1, model=n) over the first n ranks of the world
    (the whole world by default).  ``ValueError`` when n is not in 1..W,
    before any process group is started.  A rank past the first n takes
    part in making the groups and then gets ``ValueError``: it is not in
    the mesh."""
    w = world_size()
    n = w if model_size is None else int(model_size)
    if not 1 <= n <= w:
        raise ValueError(f"mesh model_size={n} needs 1..{w} devices")
    mesh = _build((1, n), ("data", "model"), device)
    if mesh is None:
        raise ValueError(f"rank {dist.get_rank()} is outside a model={n} "
                         "mesh")
    return mesh


def batch_axes(mesh) -> tuple:
    """Mesh axes that carry the batch dim: everything except 'model'."""
    return tuple(a for a in mesh.axis_names if a != "model")


def model_axis_size(mesh) -> int:
    return mesh.shape["model"]
