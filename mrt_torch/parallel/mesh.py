"""The (tile, spp) mesh over ``torch.distributed`` ranks, and the
distributed runtime's start (mirrors ``mrt.parallel.mesh``).

  axis "tile": image rows are statically sharded;
  axis "spp":  samples are strided across ranks.

Rank r sits at tile index r // spp and spp index r % spp.  The only
collectives are a sum over the spp axis once a pass
(``parallel.render``) and the gather of the row tiles over the tile axis
where the film is read (``gather_film``).  With no process group the
world is this one process and the collectives are identities; once a
group exists they always run, on an axis of size 1 too.

NCCL carries CUDA tensors; gloo carries CPU tensors and, through host
copies of its own, CUDA tensors too (several ranks on one card, which
NCCL refuses).
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from ..core.device import resolve
from ..utils import profiling

TILE_AXIS = "tile"
SPP_AXIS = "spp"


class Mesh:
    """A (tile, spp) mesh: this rank's place in it, its device, and the
    process groups of its two axes (None without a process group)."""

    def __init__(self, tile, spp, device, rank=0, groups=None):
        self.shape = {TILE_AXIS: tile, SPP_AXIS: spp}
        self.device = device
        self.rank = rank
        self.tile_index, self.spp_index = divmod(rank, spp)
        self.groups = groups or {TILE_AXIS: None, SPP_AXIS: None}

    @profiling.spanned("all_reduce")
    def all_reduce(self, x, axis=SPP_AXIS):
        """The sum of x over the ranks of this rank's `axis` (a new
        tensor)."""
        group = self.groups[axis]
        if group is None:
            return x
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    def all_gather(self, x, axis=TILE_AXIS):
        """The x of every rank of this rank's `axis`, concatenated along
        dim 0 in the axis' order."""
        group = self.groups[axis]
        if group is None:
            return x
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.shape[axis])]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts)


def make_mesh(tile=None, spp=1, device=None):
    """Build a (tile, spp) mesh over the ranks of the process group (one
    process without one), on `device` (None: the CUDA card; raises
    without one).

    Defaults to every rank on the tile axis.  Every rank must call it
    with the same shape: each creates every axis group, in one order.
    """
    device = resolve(device)
    n = dist.get_world_size() if dist.is_initialized() else 1
    if tile is None:
        tile = n // spp
    if tile * spp != n:
        raise ValueError(f"mesh {tile}x{spp} != {n} devices")
    if not dist.is_initialized():
        return Mesh(tile, spp, device)
    rank = dist.get_rank()
    groups = {}
    for t in range(tile):
        g = dist.new_group([t * spp + s for s in range(spp)])
        if rank // spp == t:
            groups[SPP_AXIS] = g
    for s in range(spp):
        g = dist.new_group([t * spp + s for t in range(tile)])
        if rank % spp == s:
            groups[TILE_AXIS] = g
    return Mesh(tile, spp, device, rank, groups)


def render_mesh(n_devices=None, device=None):
    """Convenience: an all-tile mesh (spp axis size 1) of `n_devices`
    ranks (None: all of them)."""
    return make_mesh(tile=n_devices, device=device)


def init_distributed(coordinator=None, num_processes=None, process_id=None,
                     backend=None, device=None, timeout=None):
    """Join a process group of `num_processes` (a no-op for one).

    coordinator: "host:port" (TCP) or an init URL ("tcp://...",
    "file://...", "env://"); backend: NCCL for a CUDA device, gloo for
    the CPU, unless given; device: this rank's (None: the current CUDA
    card; raises without one); timeout: seconds for the collectives.
    """
    if num_processes is None or num_processes <= 1:
        return
    device = resolve(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    kw = {} if timeout is None else dict(
        timeout=datetime.timedelta(seconds=timeout))
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id, **kw)


def init_from_launcher(device=None):
    """Join the group a launcher describes in the environment (torchrun:
    WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR, MASTER_PORT), rank r on
    card LOCAL_RANK; a no-op for one process.  Returns this rank's
    device (None: as ``resolve`` gives it)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or dist.is_initialized():
        return resolve(device)
    if device is None and torch.cuda.is_available():
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    device = resolve(device)
    init_distributed("env://", world, int(os.environ["RANK"]), device=device)
    return device


def is_leader():
    """True on rank 0, or without a process group: the rank that writes
    files."""
    return not dist.is_initialized() or dist.get_rank() == 0
