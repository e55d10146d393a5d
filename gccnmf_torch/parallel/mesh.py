"""Process groups and the (data, model) device mesh (counterpart of
``gccnmf_tpu/parallel/mesh.py``).

JAX drives every device of a host from one process and lays a
``jax.sharding.Mesh`` with the axes ``data`` (time shards, utterance
batches) and ``model`` (dictionary atoms) over them. Here each device is
one process (a rank) of a ``torch.distributed`` world, and the mesh is a
2-D :class:`~torch.distributed.device_mesh.DeviceMesh` with the same axis
names: ``mesh.get_group("data")`` and ``mesh.get_group("model")`` are the
process groups the collectives of ``nmf_sharded`` and ``long_audio`` run
over. The backend follows the device and nothing else: NCCL for CUDA
ranks, gloo for CPU ranks. A CUDA rank that cannot start NCCL raises; no
rank drops to gloo or to the CPU.

:class:`LocalMesh` is the other shape JAX's mesh takes: one process over
its host's local devices, the counterpart of ``make_mesh(data=N, model=1,
devices=jax.devices()[:N])``. It joins no process group; the server's slot
sharding (``serving.StreamServer(mesh=)``) runs on it.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from gccnmf_torch.device import resolve_device

logger = logging.getLogger(__name__)

__all__ = [
    "BACKENDS",
    "TIMEOUT_S",
    "init_distributed",
    "init_group",
    "check_mesh",
    "make_mesh",
    "LocalMesh",
    "local_mesh",
    "multihost_mesh",
    "data_parallel_mesh",
    "axis_size",
    "mesh_device",
    "shard_rows",
    "gather",
    "gather_to_host",
]

#: the process-group backend of each device type
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
#: seconds a collective may wait for its peers before it raises
TIMEOUT_S = 600.0


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device=None,
    timeout_s: float = TIMEOUT_S,
) -> int:
    """Join the default process group; returns this process's rank.

    The world comes from the arguments (``coordinator_address`` as
    ``"host:port"``, or a ``tcp://`` or ``file://`` URL) or from torchrun's
    ``MASTER_ADDR``/``MASTER_PORT``/``RANK``/``WORLD_SIZE``, where JAX reads
    ``JAX_COORDINATOR_ADDRESS``. Unconfigured, it is a no-op that returns 0,
    as in JAX; already initialised, it returns the rank. ``device`` (the
    card by default) picks the backend; on CUDA the rank's card
    (``LOCAL_RANK``, else the rank modulo the card count) becomes the
    current device first."""
    if dist.is_initialized():
        return dist.get_rank()
    env = os.environ
    torchrun = "MASTER_ADDR" in env and "MASTER_PORT" in env
    if not (coordinator_address or num_processes or torchrun):
        return 0
    dev = resolve_device(device)
    rank = int(env["RANK"]) if process_id is None else process_id
    world = int(env["WORLD_SIZE"]) if num_processes is None else num_processes
    if dev.type == "cuda":
        dev = torch.device("cuda", int(env.get("LOCAL_RANK", rank % torch.cuda.device_count())))
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    init_group(dev, init_method=init_method, rank=rank, world_size=world, timeout_s=timeout_s)
    logger.info("process group: rank %d of %d over %s", rank, world, BACKENDS[dev.type])
    return rank


def init_group(dev: torch.device, timeout_s: float = TIMEOUT_S, **kwargs) -> None:
    """``init_process_group`` with the backend of ``dev``'s type. A CUDA
    rank makes ``dev`` its current card first and binds its communicators
    to it (``device_id``)."""
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device() if dev.index is None else dev.index)
        torch.cuda.set_device(dev)
        kwargs["device_id"] = dev
    dist.init_process_group(BACKENDS[dev.type], timeout=timedelta(seconds=timeout_s), **kwargs)


def check_mesh(data: int, model: int, n: int) -> None:
    """JAX's bound: a (data, model) mesh needs at most ``n`` devices."""
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} exceeds {n} devices")


def make_mesh(data: int | None = None, model: int = 1, device=None,
              timeout_s: float = TIMEOUT_S) -> DeviceMesh:
    """A (data, model) mesh over the world's ranks, ``model`` innermost (the
    ranks of one dictionary block are consecutive). ``data=None`` takes
    every rank. ``device`` (the card by default) must be the one the
    world's backend serves.

    ``init_device_mesh`` needs a process group. A process that joined none
    becomes rank 0 of a world of one on a private in-memory store, so one
    device needs no launcher; ``torch.distributed.destroy_process_group()``
    ends it."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        init_group(dev, timeout_s, store=dist.HashStore(), rank=0, world_size=1)
    if dist.get_backend() != BACKENDS[dev.type]:
        raise ValueError(f"the process group runs {dist.get_backend()}: a {dev.type} mesh "
                         f"needs {BACKENDS[dev.type]}")
    n = dist.get_world_size()
    if data is None:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    check_mesh(data, model, n)
    if data * model < n:
        # a mesh over part of the world would leave ranks out of every collective
        raise ValueError(f"mesh {data}x{model} leaves {n - data * model} of {n} ranks out")
    return init_device_mesh(dev.type, (data, model), mesh_dim_names=("data", "model"))


@dataclass(frozen=True)
class LocalMesh:
    """A ``data`` axis over devices that one process drives: shard ``i``
    lives on ``devices[i]``. A device may appear more than once; each of
    its shards then keeps its own state and graph on it, which is how one
    card (or the CPU) runs more than one shard."""

    devices: tuple[torch.device, ...]

    @property
    def shape(self) -> dict[str, int]:
        return {"data": len(self.devices)}


def local_mesh(data: int, devices=None) -> LocalMesh:
    """A :class:`LocalMesh` of ``data`` shards over ``devices`` (the first
    ``data`` of them), by default ``cuda:0`` … ``cuda:data-1``. More shards
    than devices raises make_mesh's "exceeds" error; the devices must be of
    one type, and a CUDA device must exist."""
    if data < 1:
        raise ValueError(f"a mesh needs at least one shard, not {data}")
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    check_mesh(data, 1, len(devices))
    devices = tuple(resolve_device(d) for d in list(devices)[:data])
    if len({d.type for d in devices}) > 1:
        raise ValueError(f"a mesh's devices must be of one type: {devices}")
    if devices[0].type == "cuda":
        devices = tuple(torch.device("cuda", d.index or 0) for d in devices)
        n = torch.cuda.device_count()
        if any(d.index >= n for d in devices):
            raise ValueError(f"mesh devices {[str(d) for d in devices]} exceed {n} devices")
    return LocalMesh(devices)


def multihost_mesh(model: int = 1, device=None) -> DeviceMesh:
    """The (data, model) mesh over every rank of the world, with JAX's rule
    that ``model`` divides the ranks of one host (``LOCAL_WORLD_SIZE``, else
    the world): a dictionary block's collectives, every NMF iteration,
    never leave the host."""
    if not dist.is_initialized():
        local = 1
    else:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))
    if model > 1 and local % model:
        raise ValueError(f"model={model} must divide local device count {local} so "
                         "dictionary collectives stay on one host")
    return make_mesh(model=model, device=device)


def data_parallel_mesh(device=None) -> DeviceMesh:
    return make_mesh(model=1, device=device)


def axis_size(mesh: DeviceMesh, name: str) -> int:
    """The number of ranks along the mesh axis ``name``."""
    return mesh.shape[mesh.mesh_dim_names.index(name)]


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device: its current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard_rows(x, mesh: DeviceMesh, axis: int = 0, mesh_dim: str = "data") -> torch.Tensor:
    """This rank's block of the host array ``x`` split evenly along ``axis``
    over the mesh axis ``mesh_dim``, on the rank's device: the counterpart
    of JAX's ``shard_batch``, which places the same block on each device."""
    x = np.asarray(x)
    size = axis_size(mesh, mesh_dim)
    if x.shape[axis] % size:
        raise ValueError(f"dimension {x.shape[axis]} not divisible by {mesh_dim}={size}")
    block = x.shape[axis] // size
    start = mesh.get_local_rank(mesh_dim) * block
    part = np.take(x, np.arange(start, start + block), axis=axis)
    return torch.as_tensor(np.ascontiguousarray(part), device=mesh_device(mesh))


def gather(local: torch.Tensor, mesh: DeviceMesh, axis: int = 0,
           mesh_dim: str = "data") -> torch.Tensor:
    """The global tensor on every rank's device: the ``mesh_dim`` blocks of
    ``local`` all-gathered and joined along ``axis`` in mesh order. Along an
    axis of one rank it is ``local``."""
    size = axis_size(mesh, mesh_dim)
    if size == 1:
        return local
    local = local.contiguous()
    parts = [torch.empty_like(local) for _ in range(size)]
    dist.all_gather(parts, local, group=mesh.get_group(mesh_dim))
    return torch.cat(parts, dim=axis)


def gather_to_host(local: torch.Tensor, mesh: DeviceMesh, axis: int = 0,
                   mesh_dim: str = "data") -> np.ndarray:
    """:func:`gather` as a NumPy array: JAX's ``gather_to_host``."""
    return gather(local, mesh, axis, mesh_dim).cpu().numpy()
