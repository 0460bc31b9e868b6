"""Device meshes over ``torch.distributed`` ranks, as ``repro.launch.mesh``.

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` with named
dims: ``data`` carries the batch, the FL clients' D-tiles
(:mod:`repro_torch.core.sharded`) and the MoE experts, ``model`` tensor
parallelism, ``pod`` the cross-pod replica.  One process is one rank; the
product of a mesh's axis sizes must equal the world size.

``parse_mesh`` is the CLI entry (``train.py --mesh data=2``): a spec names a
canonical mesh (``host`` | ``production``) or explicit axis sizes
(``data=2`` / ``data=2,model=1``).  Run more than one rank under ``torchrun
--nproc-per-node P``; a process started without it is a world of one.

:func:`init_distributed` starts the default process group when none runs:
from torchrun's environment, or as a single rank over a ``FileStore`` in a
temporary directory, so the sharded code path is the same at world size 1.
The collective backend follows the run's device: ``nccl`` when the run is
on the card and every rank has a card of its own, ``gloo`` when ranks share
one card or run on the CPU (gloo moves CUDA tensors through the host; the
kernels still run on the card).  A mesh built with no group running starts
a ``gloo`` one, which carries CPU and CUDA tensors alike: a run on the card
that wants ``nccl`` calls :func:`init_distributed` with its device first,
as the train CLI does.

Every function here is called explicitly: importing the module starts no
process group.
"""
from __future__ import annotations

import math
import os
import tempfile
import warnings
from typing import Mapping

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _env_world() -> int:
    """The world size of this process: the running group's, else torchrun's
    ``WORLD_SIZE``, else 1."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def init_distributed(device: str | torch.device = "cpu") -> torch.device:
    """Start the default process group if none is running, and return the
    device this rank computes on.

    Under torchrun (``RANK``, ``WORLD_SIZE`` and ``MASTER_ADDR`` set) the
    group starts from those variables; otherwise as rank 0 of a world of one
    over a ``FileStore`` in a fresh temporary directory.  With ``nccl`` rank
    r takes card ``LOCAL_RANK``; with ``gloo`` every rank takes ``device``
    as given (ranks that share one card share it).
    """
    dev = torch.device(device)
    if dist.is_initialized():
        backend = dist.get_backend()
    else:
        # nccl when every rank can have a card of its own
        backend = "nccl" if dev.type == "cuda" and \
            torch.cuda.device_count() >= _env_world() else "gloo"
        if backend == "nccl":
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        if dev.type == "cuda":
            # before the mesh: DeviceMesh would otherwise pick the card from
            # LOCAL_RANK, which ranks sharing one card do not have
            torch.cuda.set_device(dev)
            torch.cuda.init()
        if all(v in os.environ for v in ("RANK", "WORLD_SIZE",
                                         "MASTER_ADDR")):
            dist.init_process_group(backend, init_method="env://")
        else:
            path = os.path.join(tempfile.mkdtemp(prefix="repro-torch-pg-"),
                                "store")
            dist.init_process_group(backend, store=dist.FileStore(path, 1),
                                    rank=0, world_size=1)
    if backend == "nccl":
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _device_type() -> str:
    """The mesh's device type: ``cuda`` under nccl, else ``cpu`` (gloo's
    collectives take CUDA tensors through the host either way)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _build(sizes: Mapping[str, int]) -> DeviceMesh:
    # the data's device is not known here: gloo serves either
    init_distributed("cpu")
    return init_device_mesh(_device_type(), tuple(sizes.values()),
                            mesh_dim_names=tuple(sizes))


def make_host_mesh(model: int = 1) -> DeviceMesh:
    """(world / model, model) mesh over every rank, axes (data, model)."""
    world = _env_world()
    if world % model:
        raise ValueError(f"host mesh: model={model} does not divide the "
                         f"world size {world}")
    return _build({"data": world // model, "model": model})


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """(16, 16) single-pod / (2, 16, 16) two-pod mesh, axes (data, model)
    or (pod, data, model).

    With fewer ranks than the pod shape it falls back to
    :func:`make_host_mesh` with a ``RuntimeWarning``, as the reference
    does, so examples run anywhere; with more it raises.
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    world = _env_world()
    if world < n:
        warnings.warn(
            f"need {n} ranks for production mesh {shape}, have {world}; "
            "falling back to the host mesh (start the full shape with "
            f"torchrun --nproc-per-node {n} or across hosts)",
            RuntimeWarning, stacklevel=2)
        return make_host_mesh()
    if world > n:
        raise ValueError(f"production mesh {shape} takes {n} ranks, the "
                         f"world has {world}")
    return _build(dict(zip(axes, shape)))


def parse_sizes(spec: str) -> dict[str, int]:
    """The axis sizes of an explicit spec (``data=2[,model=1]``), in the
    order given, checked eagerly: a ``data`` axis, integer sizes >= 1, no
    duplicate, and a product equal to the world size."""
    sizes: dict[str, int] = {}
    for part in spec.split(","):
        if "=" not in part:
            raise ValueError(
                f"bad mesh spec {spec!r}: expected 'host', 'production', or "
                "comma-separated axis=N pairs like 'data=8'")
        name, _, val = part.partition("=")
        name = name.strip()
        try:
            size = int(val)
        except ValueError:
            raise ValueError(
                f"bad mesh spec {spec!r}: axis size {val!r} is not an int"
            ) from None
        if size < 1:
            raise ValueError(f"bad mesh spec {spec!r}: {name} must be >= 1")
        if name in sizes:
            raise ValueError(f"bad mesh spec {spec!r}: duplicate axis {name!r}")
        sizes[name] = size
    if "data" not in sizes:
        raise ValueError(f"bad mesh spec {spec!r}: a 'data' axis is required")
    n, world = math.prod(sizes.values()), _env_world()
    if n != world:
        raise ValueError(
            f"mesh {spec!r} needs {n} ranks, the world has {world}; start "
            f"one process per rank (torchrun --nproc-per-node {n})")
    return sizes


def check_spec(spec: str) -> None:
    """Validate a CLI spec without starting a process group (canonical
    names always resolve)."""
    if spec.strip() not in ("host", "production"):
        parse_sizes(spec.strip())


def parse_mesh(spec: str) -> DeviceMesh:
    """Mesh from a CLI spec: ``host`` | ``production`` | ``axis=N[,axis=M]``.

    Explicit specs build a mesh over every rank with the axes in the order
    given.  Validation is eager: an unsatisfiable spec raises ValueError at
    :class:`~repro_torch.core.server.Federation` construction, not mid-run.
    Starts a ``gloo`` process group (:func:`init_distributed`) if none is
    running.
    """
    spec = spec.strip()
    if spec == "host":
        return make_host_mesh()
    if spec == "production":
        return make_production_mesh()
    return _build(parse_sizes(spec))


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a DeviceMesh, or of a plain mapping of
    sizes (the sharding rules take either)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_spec(mesh) -> str:
    """The canonical ``axis=N,...`` string of a mesh (for run metadata)."""
    return ",".join(f"{a}={n}" for a, n in axis_sizes(mesh).items())


def batch_axes(mesh) -> tuple:
    """The mesh axes that jointly shard the global batch."""
    return ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)
