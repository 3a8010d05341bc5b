"""CLI surface for mesh parallelism — the `--mesh` flag and the rendezvous.

The reference scales out through the same endpoints with a `--mesh` flag
(default auto) over the visible jax devices (xmipp3_tpu/parallel/cli.py).
Here the mesh is the ranks of a torch.distributed process group, one rank
per mesh device:

  auto  : dp when the group has more than one rank, serial otherwise;
  dp    : particle/data axis sharded over the ranks (parallel_match_full /
          parallel_reconstruct, all_reduce of the volume);
  tp    : the gallery sharded over the ranks (parallel_match_refsharded's
          winner reduction), axis "model";
  slab  : kz-slab sharding of the Fourier cube (slab_reconstruct);
  slab2d: data x z mesh of an even number >= 4 of ranks, z = 2
          (slab_reconstruct_2d);
  none  : force the serial path.

Every rank runs the same command. The group starts from --dist_coordinator
host:port, --dist_nprocs and --dist_procid, or from the environment that
torchrun sets (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK). Each
rank runs on cuda:{local rank % cards} unless --device says otherwise. The
backend is NCCL when each rank of the host has a card of its own, and gloo
otherwise (on the CPU, or several ranks sharing one card).
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from xmipp3_tpu_torch.core.program import XmippProgram
from xmipp3_tpu_torch.device import resolve_device
from xmipp3_tpu_torch.parallel.mesh import (Mesh, backend, data_mesh,
                                            rank_device, world)

MESH_MODES = ("auto", "dp", "tp", "slab", "slab2d", "none", "serial")


def add_mesh_params(prog, modes: str = "auto dp tp slab slab2d none serial"):
    """Add the --mesh parameter to a program's grammar."""
    prog.addParamsLine(
        f"  [--mesh <mode=auto>] : Device-mesh parallel mode ({modes}); "
        f"auto = dp when the process group has >1 rank")
    prog.addParamsLine(
        "  [--dist_coordinator <addr=\"\">] : torch.distributed rendezvous "
        "address host:port (one process per rank)")
    prog.addParamsLine(
        "  [--dist_nprocs <n=-1>]   : number of processes (ranks) in the run")
    prog.addParamsLine(
        "  [--dist_procid <i=-1>]   : this process' rank in the run")


def read_mesh_params(prog):
    """Read --mesh/--dist_* back; call from readParams."""
    prog.mesh_mode = prog.getParam("--mesh") if prog.checkParam("--mesh") \
        else "auto"
    prog.dist_coordinator = prog.getParam("--dist_coordinator") \
        if prog.checkParam("--dist_coordinator") else ""
    prog.dist_nprocs = prog.getIntParam("--dist_nprocs") \
        if prog.checkParam("--dist_nprocs") else -1
    prog.dist_procid = prog.getIntParam("--dist_procid") \
        if prog.checkParam("--dist_procid") else -1


def choose_backend(device: torch.device, world_size: int) -> str:
    """NCCL when every rank on this host has a card of its own, else gloo."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    if device.type == "cuda" and dist.is_nccl_available() and \
            local <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def maybe_init_distributed(prog) -> bool:
    """Start the process group when the command line or torchrun asks for
    one; returns True if this call started it (the caller then destroys
    it). A group that already exists is used as it is."""
    if dist.is_initialized():
        return False
    addr = getattr(prog, "dist_coordinator", "")
    n = getattr(prog, "dist_nprocs", -1)
    rank = getattr(prog, "dist_procid", -1)
    env = os.environ
    if addr:
        init = f"tcp://{addr}"
        n = n if n >= 0 else int(env.get("WORLD_SIZE", "1"))
        rank = rank if rank >= 0 else int(env.get("RANK", "0"))
    elif "MASTER_ADDR" in env and "WORLD_SIZE" in env:
        init = "env://"
        n, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
    else:
        return False
    device = rank_device(getattr(prog, "device_arg", None),
                         int(env.get("LOCAL_RANK", rank)))
    backend = choose_backend(device, n)
    if backend == "nccl":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init, world_size=n,
                            rank=rank)
    return True


def resolve_mesh(mode: str = "auto", min_devices: int = 2,
                 axis_name: str = "data", device=None):
    """Resolve a --mesh flag value into (Mesh | None, effective_mode).

    Returns (None, "none") for the serial path. The mesh spans every rank
    of the process group; `device` is the program's --device."""
    if mode not in MESH_MODES:
        raise ValueError(f"--mesh {mode!r}: expected one of {MESH_MODES}")
    if mode in ("none", "serial"):
        return None, "none"
    n = world()[0]
    if n < min_devices:
        if mode == "auto":
            return None, "none"
        raise RuntimeError(
            f"--mesh {mode} needs >= {min_devices} devices, found {n} (one "
            "per torch.distributed rank: start the ranks with "
            "--dist_coordinator/--dist_nprocs/--dist_procid or torchrun)")
    if mode == "auto":
        mode = "dp"
    dev = rank_device(device)
    if mode == "slab2d":
        # dp x slab 2-D mesh: ranks as (data, z) with z = 2
        if n < 4 or n % 2:
            raise RuntimeError(f"--mesh slab2d needs an even device count "
                               f">= 4, found {n}")
        return Mesh({"data": n // 2, "z": 2}, dev), mode
    axis = "model" if mode == "tp" else axis_name
    return data_mesh(n, axis_name=axis, device=dev), mode


class MeshProgram(XmippProgram):
    """The device, the process group and the mesh of a program with
    --mesh: readParams sets device_arg and mesh_mode (read_mesh_params);
    run() resolves the device, starts the group when asked to, calls
    _run(mesh) (mesh None on the serial path; self.device is then the
    mesh's device) with self.writer True on rank 0 only, and stops the
    group it started."""

    def run(self):
        self.device = resolve_device(self.device_arg)
        started = maybe_init_distributed(self)
        try:
            mesh, mode = resolve_mesh(self.mesh_mode, device=self.device_arg)
            if mesh is not None:
                self.device = mesh.device
                if self.verbose:
                    print(f"mesh: {mode} {mesh.shape} over {mesh.size} "
                          f"ranks, rank {mesh.rank} on {self.device}, "
                          f"backend {backend()}")
            # full float32 products: lower precision flips argmax winners
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            self.writer = world()[1] == 0
            self._run(mesh)
        finally:
            if started:
                torch.distributed.destroy_process_group()
