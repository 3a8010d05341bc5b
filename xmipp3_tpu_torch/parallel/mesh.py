"""Mesh construction, sharding helpers and the collectives of the mesh paths.

A JAX mesh is single-controller: one process sees every device, and the
reference shards arrays over them (xmipp3_tpu/parallel/mesh.py). Here one
rank of a torch.distributed process group takes the place of one JAX device:
every rank runs the same program, holds its own shard and meets the others
in collectives. `psum` becomes `all_reduce(SUM)`, `pmax` becomes
`all_reduce(MAX)`, and what the reference fetches sharded is gathered
(`all_gather`). Without a process group the world is one rank and every
collective is the identity.

A `Mesh` names its axes with their sizes, row-major over the ranks (the
last axis varies fastest, as `Mesh(devices.reshape(n // 2, 2), ("data",
"z"))` does in JAX), and holds this rank's device and its subgroup along
each axis. Under gloo, tensors on the card are staged through host memory
for the collective; NCCL takes them where they are.
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.distributed as dist

from xmipp3_tpu_torch.device import as_tensor, resolve_device


def world() -> tuple[int, int]:
    """(world size, rank) of the process group; (1, 0) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def rank_device(device=None, local_rank: int | None = None) -> torch.device:
    """This rank's device: cuda:{local rank % cards} for None, "default" or
    "cuda"; anything else as resolve_device gives it (raises without a
    card unless the CPU is asked for). The local rank is LOCAL_RANK (set by
    torchrun) or the rank."""
    if device is None or device in ("default", "cuda"):
        resolve_device("cuda")
        if local_rank is None:
            local_rank = int(os.environ.get("LOCAL_RANK", world()[1]))
        return torch.device("cuda", local_rank % torch.cuda.device_count())
    return resolve_device(device)


class Mesh:
    """Named axes over the ranks of the process group, this rank's device,
    and this rank's subgroup along each axis. `shape[axis]` is the axis's
    size, as for a JAX mesh."""

    def __init__(self, axes: dict[str, int], device: torch.device):
        self.shape = dict(axes)
        self.size = math.prod(self.shape.values())
        n, self.rank = world()
        if self.size != n:
            raise RuntimeError(f"a mesh of shape {self.shape} needs "
                               f"{self.size} ranks, the process group has {n}")
        self.device = device
        self.coords, self.groups = {}, {}
        names, sizes = list(self.shape), list(self.shape.values())
        idx = np.arange(n).reshape(sizes)
        here = np.unravel_index(self.rank, sizes)
        for k, name in enumerate(names):
            self.coords[name] = int(here[k])
            if len(names) == 1 or n == 1:
                self.groups[name] = None          # the whole process group
                continue
            # every line of ranks along this axis gets a group, created in
            # the same order on every rank (new_group is collective)
            lines = np.moveaxis(idx, k, -1).reshape(-1, sizes[k])
            for line in lines:
                g = dist.new_group([int(r) for r in line])
                if self.rank in line:
                    self.groups[name] = g


def backend() -> str:
    return dist.get_backend() if world()[0] > 1 else "none"


def data_mesh(n_devices: int | None = None, axis_name: str = "data",
              device=None) -> Mesh:
    """1-D mesh over the particle (data) axis: every rank of the process
    group. Raises if fewer than n_devices ranks exist, as the reference
    does for devices, and if more do (every rank belongs to the mesh)."""
    n = world()[0]
    if n_devices is not None and n_devices != n:
        raise RuntimeError(
            f"data_mesh({n_devices}) requested but the process group has {n} "
            "rank(s); start one rank per mesh device (--dist_nprocs, or "
            "torchrun --nproc_per_node)")
    return Mesh({axis_name: n}, rank_device(device))


def shard_rows(n_rows: int, mesh: Mesh, axis_name: str = "data") -> slice:
    """The rows of this rank's contiguous shard of n_rows (a multiple of
    the axis size)."""
    per = local_batch_size(n_rows, mesh, axis_name)
    i = mesh.coords[axis_name]
    return slice(i * per, (i + 1) * per)


def shard_particles(arr, mesh: Mesh, axis_name: str = "data"):
    """This rank's contiguous shard of an (N, ...) stack (array or tensor)
    along the mesh axis, as a float32 tensor on the rank's device (N must
    be a multiple of the axis size: pad first)."""
    return as_tensor(arr[shard_rows(len(arr), mesh, axis_name)], mesh.device)


def replicate(arr, mesh: Mesh):
    """The whole array or tensor, float32, on this rank's device
    (references, volumes)."""
    return as_tensor(arr, mesh.device)


def local_batch_size(total: int, mesh: Mesh, axis_name: str = "data") -> int:
    n = mesh.shape[axis_name]
    if total % n:
        raise ValueError(f"batch {total} not divisible by mesh size {n}; "
                         f"pad the stack (static shapes)")
    return total // n


def pad_to_multiple(arr, multiple: int, axis: int = 0, fill=0.0):
    """Pad the particle axis so it divides the mesh evenly; returns
    (padded, n_valid)."""
    n = arr.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return arr, n
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, rem)
    return np.pad(np.asarray(arr), pad, constant_values=fill), n


def _staged(t: torch.Tensor) -> torch.Tensor:
    """t as the backend takes it: on the card for NCCL, in host memory for
    gloo; bool travels as uint8."""
    t = t.contiguous()
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    return t if backend() == "nccl" else t.cpu()


def all_reduce(t: torch.Tensor, mesh: Mesh, axis_name: str,
               op: str = "sum") -> torch.Tensor:
    """Reduce t in place over the ranks of the mesh axis (sum or max) and
    return it."""
    if mesh.shape[axis_name] == 1:
        return t
    buf = _staged(t)
    dist.all_reduce(buf, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM, group=mesh.groups[axis_name])
    if buf is not t:
        t.copy_(buf)
    return t


def all_gather(t: torch.Tensor, mesh: Mesh, axis_name: str) -> torch.Tensor:
    """Every rank's t along the mesh axis, concatenated on dim 0 in axis
    order, on t's device."""
    if mesh.shape[axis_name] == 1:
        return t
    buf = _staged(t)
    parts = [torch.empty_like(buf) for _ in range(mesh.shape[axis_name])]
    dist.all_gather(parts, buf, group=mesh.groups[axis_name])
    return torch.cat(parts).to(t.device, t.dtype)
