"""The process group over which the fleet and the data-parallel trainer
combine gradients (counterpart of adaptive_stereo_tpu/parallel/mesh.py).

JAX builds a 1-D device mesh and lets XLA insert the psum from sharding
annotations. Here one process drives one device (a rank of a
torch.distributed process group), holds its own slice of the stream or
batch axis, and the steps combine across ranks with an explicit
all_reduce. A Mesh is that group with the rank's device.

initialize_multihost starts the group (torch.distributed.init_process_group;
backend "nccl" on CUDA, "gloo" on the CPU). make_mesh without a group makes
a one-rank group itself, with the backend that follows from the device, so
the one-card path runs NCCL's all_reduce as a four-card one would.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: str = "nccl") -> None:
    """Start the process group (call once per process, before make_mesh).

    coordinator_address: "host:port" (as JAX takes it) or an init URL
    ("tcp://host:port", "file:///path"); None reads MASTER_ADDR /
    MASTER_PORT from the environment. num_processes and process_id are the
    world size and this process's rank (None: WORLD_SIZE and RANK from the
    environment). backend: "nccl" for CUDA tensors, "gloo" for the CPU (or
    for several ranks on one card, which NCCL refuses)."""
    if coordinator_address is None:
        init = "env://"
    elif "://" in coordinator_address:
        init = coordinator_address
    else:
        init = f"tcp://{coordinator_address}"
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    dist.init_process_group(backend, init_method=init, **kwargs)


@dataclass
class Mesh:
    """A 1-D mesh: the process group, this process's rank in it, the world
    size, the device this rank computes on and the axis name. all_reduces
    counts the all_reduce calls the steps made through it."""

    group: dist.ProcessGroup
    rank: int
    world_size: int
    device: torch.device
    axis_name: str = "data"
    all_reduces: int = 0

    def all_reduce(self, tensor: torch.Tensor) -> torch.Tensor:
        """Sum `tensor` over the ranks, in place; returns it."""
        dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=self.group)
        self.all_reduces += 1
        return tensor


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "data",
              device: DeviceLike = None) -> Mesh:
    """The mesh over every rank of the process group (JAX: the first
    n_devices devices). device: "cuda" (the default; rank r computes on
    card r mod the card count) or "cpu". Without a group, starts a one-rank
    group: NCCL on CUDA, gloo on the CPU. n_devices other than the group's
    size raises ValueError: a mesh spans the whole group."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    rank, world = dist.get_rank(), dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"requested {n_devices} devices, have {world} ranks in the group; a "
                         "mesh spans the whole group: start the group with that many ranks")
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)  # NCCL's object collectives use the current device
    return Mesh(dist.group.WORLD, rank, world, dev, axis_name)


def local_data_slice(global_arrays, mesh: Mesh):
    """The rank's rows of the leading (stream) axis of an array, tensor or
    list, or of each in a dict (host-sharded streams: each rank loads only
    its own cameras' frames): rows [rank * n / world, (rank + 1) * n /
    world)."""

    def slc(x):
        per = len(x) // mesh.world_size
        return x[mesh.rank * per:(mesh.rank + 1) * per]

    if isinstance(global_arrays, dict):
        return {key: slc(v) for key, v in global_arrays.items()}
    return slc(global_arrays)


def data_sharding(mesh: Mesh):
    """shard(x) -> the rank's rows of x's leading (stream or batch) axis as
    a tensor on the mesh's device (x a numpy array or tensor holding every
    rank's rows). The axis must divide evenly over the ranks, as JAX's
    sharding requires."""

    def shard(x) -> torch.Tensor:
        x = torch.as_tensor(x)
        if x.shape[0] % mesh.world_size:
            raise ValueError(f"leading axis {x.shape[0]} does not divide over "
                             f"{mesh.world_size} ranks")
        per = x.shape[0] // mesh.world_size
        return x[mesh.rank * per:(mesh.rank + 1) * per].contiguous().to(mesh.device)

    return shard


def replicated_sharding(mesh: Mesh):
    """replicate(state) -> state, with every parameter, BatchNorm statistic,
    Adam moment and counter of a TrainState (engine/state.py) overwritten in
    place by rank 0's: every rank then starts from the same bits."""

    @torch.no_grad()
    def replicate(state):
        for t in [*state.params, *state.buffers, *state.m, *state.v, state.count, state.step,
                  state.lr]:
            dist.broadcast(t, src=0, group=mesh.group)
        return state

    return replicate
