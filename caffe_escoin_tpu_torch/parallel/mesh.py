"""Process groups and the device mesh (port of
``caffe_escoin_tpu/parallel/mesh.py``).

The JAX package builds a ``jax.sharding.Mesh`` over the devices of one
program and lets XLA insert the collectives. Torch runs one process per
rank instead: ``multihost_init`` joins this process to a
``torch.distributed`` process group (NCCL on the card, gloo where the
caller asks for the CPU), and ``make_mesh`` lays the ranks of that group
out as a ``DeviceMesh`` with the same two axes, ``data`` (batch) and
``model`` (output channels or feature-map rows). A rank's coordinate is
that of its device in the JAX mesh: rank ``r`` sits at data ``r // model``,
model ``r % model``. The functions of parallel/ take and return each
rank's local shard; ``axis_group``, ``axis_size`` and ``axis_index`` are
what they read of the mesh.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from caffe_escoin_tpu_torch.utils.benchmark import force_platform

AXES = ("data", "model")
DEFAULT_TIMEOUT_S = 60.0


def multihost_init(init_method: Optional[str] = None,
                   world_size: Optional[int] = None,
                   rank: Optional[int] = None, *, platform: str = "auto",
                   store: Optional[dist.Store] = None,
                   timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join this process to the default process group (the rendezvous of
    the reference's NCCL uid handshake, ``parallel.cpp:125-137``): NCCL on
    the card, gloo with ``platform="cpu"``. ``init_method`` (e.g.
    ``file:///tmp/store`` or ``tcp://localhost:29500``) or ``store`` names
    the rendezvous; ``world_size`` and ``rank`` default to the
    ``WORLD_SIZE`` and ``RANK`` environment variables, else one process.

    A no-op when a group exists already. A world of one process with no
    rendezvous named gets its group from an in-process store. Any other
    failure, a rendezvous that times out included, raises: unlike the JAX
    function, nothing is swallowed."""
    if dist.is_initialized():
        return
    device = force_platform(platform)
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if init_method is None and store is None:
        if world_size != 1:
            raise ValueError(f"multihost_init: a world of {world_size} needs "
                             f"an init_method or a store")
        store = dist.HashStore()
    if device.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo", init_method=init_method,
        store=store, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))


def make_mesh(data: int = -1, model: int = 1) -> DeviceMesh:
    """The initialized world as a (data, model) mesh; data=-1 takes every
    rank the model axis leaves. The group's backend gives the device type
    (NCCL: the card)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "multihost_init first")
    n = dist.get_world_size()
    if data == -1:
        if n % model:
            raise ValueError(f"world {n} is not a multiple of model {model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data} x {model} != world {n}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (data, model), mesh_dim_names=AXES)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh[axis].size()


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate on ``axis``."""
    return mesh.get_local_rank(axis)


def axis_group(mesh: DeviceMesh, axis: str) -> dist.ProcessGroup:
    """The process group of the ranks that share this rank's coordinate on
    the other axis."""
    return mesh.get_group(axis)


def batch_sharding(mesh: DeviceMesh):
    """The placements of a batch, one per mesh dim: split on dim 0 over
    ``data``, whole over ``model`` (the JAX ``P("data")``)."""
    return tuple(Shard(0) if a == "data" else Replicate()
                 for a in mesh.mesh_dim_names)


def replicated(mesh: DeviceMesh):
    """Whole on every rank, one placement per mesh dim (the JAX ``P()``)."""
    return tuple(Replicate() for _ in mesh.mesh_dim_names)


def local_shard(t: torch.Tensor, placements, mesh: DeviceMesh
                ) -> torch.Tensor:
    """This rank's block of ``t`` under ``placements`` (one per mesh dim):
    a ``Shard(d)`` on a mesh dim of n ranks keeps the contiguous n-th of
    dim d at this rank's coordinate, the block a ``NamedSharding`` puts on
    the device at that coordinate."""
    for i, (axis, p) in enumerate(zip(mesh.mesh_dim_names, placements)):
        if not isinstance(p, Shard):
            continue
        n = mesh.size(i)
        if t.shape[p.dim] % n:
            raise ValueError(f"dim {p.dim} of {tuple(t.shape)} is not "
                             f"divisible by the {axis} axis {n}")
        t = t.chunk(n, dim=p.dim)[mesh.get_local_rank(axis)]
    return t.contiguous()
