"""The device mesh over torch.distributed ranks (counterpart of
adgs_tpu/parallel/mesh.py).

JAX's mesh is single-controller: one program sees every device. The port
runs one process ("rank") per device, as PyTorch users train. A mesh axis
becomes a process group, and each rank knows its coordinate on each axis.
Ranks are data-major, as JAX's `devices.reshape(sizes)` orders them: on a
{"data": B, "tile": D} mesh, rank = b * D + d.

Backends are the caller's choice and never a silent fallback: "nccl" where
each rank has a card of its own, "gloo" for CPU ranks and for several
ranks that share one card (NCCL refuses two ranks on one GPU).
"""

from __future__ import annotations

import dataclasses
import itertools
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve_device

# the launcher's rendezvous (launch.py): a file:// init method for ranks
# that it spawns itself; torchrun sets MASTER_ADDR/PORT instead (env://)
INIT_ENV = "ADGS_DIST_INIT"


def initialize_multihost(backend: str, init_method: Optional[str] = None,
                         world_size: Optional[int] = None,
                         rank: Optional[int] = None) -> None:
    """Join the process group (counterpart of jax.distributed.initialize):
    from the arguments, else from the launcher's environment (RANK,
    WORLD_SIZE and ADGS_DIST_INIT from launch.py, or torchrun's env://).
    Call on every rank before make_mesh. No-op if already joined."""
    if dist.is_initialized():
        return
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r} (nccl or gloo)")
    init_method = init_method or os.environ.get(INIT_ENV, "env://")
    world_size = int(os.environ["WORLD_SIZE"] if world_size is None
                     else world_size)
    rank = int(os.environ["RANK"] if rank is None else rank)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()))


def rank_device(device=None) -> torch.device:
    """This rank's device: the CPU when asked for, else
    cuda:(local rank % visible cards), so that ranks may share a card."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank() % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


@dataclasses.dataclass
class Mesh:
    """shape: {axis: size} in mesh order; coords: this rank's index on each
    axis; groups: each axis's process group holding this rank; rank: its
    rank in the default group."""

    shape: dict
    coords: dict
    groups: dict
    device: torch.device
    rank: int

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))

    def group(self, axis: str):
        return self.groups[axis]


def make_mesh(axis_sizes: Optional[dict] = None, device=None) -> Mesh:
    """A mesh over every rank of the default group. Default: one axis
    "tile" (image-tile sharding). {"data": 2, "tile": 4} composes camera
    batches with tile sharding. Every rank must call this, with the same
    sizes: each creates every axis group (new_group), in the same order."""
    world = dist.get_world_size()
    if axis_sizes is None:
        axis_sizes = {"tile": world}
    names = tuple(axis_sizes)
    sizes = tuple(int(s) for s in axis_sizes.values())
    if int(np.prod(sizes)) != world:
        raise ValueError(f"mesh {axis_sizes} != {world} ranks")
    grid = np.arange(world).reshape(sizes)
    me = tuple(int(c) for c in np.argwhere(grid == dist.get_rank())[0])
    groups = {}
    for a, name in enumerate(names):
        if sizes[a] == world:
            groups[name] = dist.group.WORLD
            continue
        others = [range(s) for i, s in enumerate(sizes) if i != a]
        for rest in itertools.product(*others):
            idx = list(rest)
            idx.insert(a, slice(None))
            ranks = [int(r) for r in grid[tuple(idx)]]
            g = dist.new_group(ranks)
            if dist.get_rank() in ranks:
                groups[name] = g
    return Mesh(shape=dict(zip(names, sizes)), coords=dict(zip(names, me)),
                groups=groups, device=rank_device(device),
                rank=dist.get_rank())


def _fingerprint(t: torch.Tensor) -> torch.Tensor:
    """int64 sums of a tensor's 32-bit words (all, and those at odd
    positions): copies that differ in a bit differ here."""
    b = t.detach().contiguous().reshape(-1)
    w = b.view(torch.int32) if b.element_size() == 4 else b.view(torch.uint8)
    return torch.stack([w.sum(dtype=torch.int64),
                        w[1::2].sum(dtype=torch.int64)])


def check_replicas(tensors: list, what: str) -> None:
    """Every rank must hold bitwise the same `tensors`: their fingerprints
    are gathered and compared; raises where a rank's differ."""
    fp = torch.stack([_fingerprint(t) for t in tensors])
    every = [torch.empty_like(fp) for _ in range(dist.get_world_size())]
    dist.all_gather(every, fp)
    bad = [r for r, x in enumerate(every) if not torch.equal(x, fp)]
    if bad:
        raise RuntimeError(f"{what}: the replicas of ranks {bad} differ from "
                           f"rank {dist.get_rank()}'s")
