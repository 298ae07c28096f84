"""Differentiable collectives over a process group: the torch.distributed
counterparts of the shard_map collectives of adgs_tpu/parallel/shard.py,
each with the transpose that JAX derives for its own:

  all_gather    (lax.all_gather)  backward: reduce-scatter (the sum of the
                                  ranks' cotangents, each keeping its block)
  psum          (lax.psum)        backward: all-reduce of the cotangents
  all_to_all    (lax.all_to_all)  backward: the reverse all-to-all
  halo_rows     (lax.ppermute)    backward: the reverse permute
  pmax          (lax.pmax)        integer plumbing, no gradient

The seed rule that makes these transposes exact: JAX's sharded loss is
ONE scalar replicated over the mesh, and shard_map's transpose divides
its cotangent by the number of devices that hold it before the psums'
transposes sum it back. Every rank here computes that scalar and seeds
its backward with 1 / (ranks), so that the all-reduced parameter
gradients equal the single-device gradient. With an identity backward
for psum instead, the depth alignment of the slab losses (whose second
round of sums depends on the first, parallel/shard.py) would lose its
cross-rank terms; with an all-reduce and a seed of 1, every gradient
would come out (ranks) times too large.

Gloo has no CUDA path for point-to-point sends (checked with torch 2.11:
batch_isend_irecv of CUDA tensors fails in the TCP transport); the halo
exchange stages them through host buffers there. Every other collective
here runs on CUDA tensors under both gloo and NCCL.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# torch >= 2.13 names the tensor forms *_single and deprecates the others
_gather_into = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


@torch.no_grad()
def gather_nograd(x: torch.Tensor, group) -> torch.Tensor:
    """[n, ...] per rank -> [D, n, ...] (bool travels as uint8)."""
    D = dist.get_world_size(group)
    src = x.to(torch.uint8) if x.dtype == torch.bool else x
    out = src.new_empty((D * x.shape[0],) + tuple(x.shape[1:]))
    _gather_into(out, src.contiguous(), group=group)
    out = out.view((D,) + tuple(x.shape))
    return out.bool() if x.dtype == torch.bool else out


@torch.no_grad()
def pmax(x: torch.Tensor, group) -> torch.Tensor:
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return gather_nograd(x, group)

    @staticmethod
    def backward(ctx, g):
        out = g.new_empty(g.shape[1:])
        _reduce_scatter(out, g.contiguous().view((-1,) + tuple(g.shape[2:])),
                        op=dist.ReduceOp.SUM, group=ctx.group)
        return out, None


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """[n, ...] per rank -> [D, n, ...], in group order."""
    return _AllGather.apply(x, group)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = g.clone()
        dist.all_reduce(out, group=ctx.group)
        return out, None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    return _Psum.apply(x, group)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g.contiguous(), group=ctx.group)
        return out, None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """[D * c, ...]: block e goes to rank e of the group; block e of the
    result came from rank e (lax.all_to_all, tiled, split = concat = 0)."""
    return _AllToAll.apply(x, group)


def _shift(to_next: torch.Tensor, to_prev: torch.Tensor, group):
    """Send `to_next` to the group's next rank and `to_prev` to the
    previous one; returns (from_prev, from_next), zeros at the ends."""
    D = dist.get_world_size(group)
    d = dist.get_group_rank(group, dist.get_rank())
    staged = (to_next.is_cuda
              and dist.get_backend(group) == dist.Backend.GLOO)
    dev = to_next.device
    if staged:
        to_next, to_prev = to_next.cpu(), to_prev.cpu()
    to_next, to_prev = to_next.contiguous(), to_prev.contiguous()
    from_prev = torch.zeros_like(to_next)
    from_next = torch.zeros_like(to_prev)
    ops = []
    if d + 1 < D:
        peer = dist.get_global_rank(group, d + 1)
        ops += [dist.P2POp(dist.isend, to_next, peer, group),
                dist.P2POp(dist.irecv, from_next, peer, group)]
    if d > 0:
        peer = dist.get_global_rank(group, d - 1)
        ops += [dist.P2POp(dist.isend, to_prev, peer, group),
                dist.P2POp(dist.irecv, from_prev, peer, group)]
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    if staged:
        from_prev, from_next = from_prev.to(dev), from_next.to(dev)
    return from_prev, from_next


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, bottom, top, group):
        ctx.group = group
        return _shift(bottom, top, group)

    @staticmethod
    def backward(ctx, g_prev, g_next):
        # my bottom rows went to the next rank as its from_prev, my top
        # rows to the previous rank as its from_next
        g_top, g_bottom = _shift(g_next, g_prev, ctx.group)
        return g_bottom, g_top, None


def halo_rows(x: torch.Tensor, halo: int, group, row_axis: int):
    """Extend this rank's slab with `halo` boundary rows from each
    neighbour along `row_axis` (the lax.ppermute of _halo_rows in
    adgs_tpu/parallel/shard.py). The end ranks receive zeros: the full
    image's zero padding."""
    bottom = x.narrow(row_axis, x.shape[row_axis] - halo, halo)
    top = x.narrow(row_axis, 0, halo)
    prev_bot, next_top = _Halo.apply(bottom, top, group)
    return torch.cat([prev_bot, x, next_top], dim=row_axis)
