"""Tile binning: instance expansion, (tile, depth) sort, tile ranges
(counterpart of adgs_tpu/raster/binning.py).

  - live-first compaction: kernel B2 (csrc/compact.cu) packs the
    Gaussians that touch a tile into the first rows of an int32 expansion
    table; `compact_live_torch` is its plain twin (a stable argsort);
  - expansion: kernel B1 (csrc/expand.cu) writes each live row's instances
    from its exclusive prefix-sum start; `expand_torch` is its plain twin
    (slot -> owner by searchsorted on the table's inclusive column);
  - one stable sort on the packed key (tile << d_bits) | depth_q, carried
    in int64 with the JAX uint32 key's bits, so ties resolve in presort
    (Gaussian-major) order; the sort indices are `slot_sorted`;
  - tile ranges by searchsorted on the sorted tile ids.

The static capacity bounds the instances; overflow is reported in the
Binning, never hidden. Nothing here waits for the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _kernels
from .preprocess import Preprocessed
from .types import RasterSettings

INSTANCE_ALIGN = 256  # capacity rounds up to a multiple of this


class Binning(NamedTuple):
    gauss_id: torch.Tensor      # [R] int32 sorted by (tile, depth); padding 0
    tile_id: torch.Tensor       # [R] int32; padding holds num_tiles
    valid: torch.Tensor         # [R] bool
    tile_start: torch.Tensor    # [T] int32 first sorted instance per tile
    tile_count: torch.Tensor    # [T] int32 instances per tile
    num_rendered: torch.Tensor  # 0-d int32 (true count, may exceed R)
    overflow: torch.Tensor      # 0-d bool
    slot_sorted: torch.Tensor   # [R] int32 presort slot per sorted instance;
    #                             padding holds R. The valid instances are
    #                             the first total = tile_start[T-1] +
    #                             tile_count[T-1] sorted ones and own exactly
    #                             the presort slots 0 .. total-1 (B4 zeroes
    #                             the gradient rows past them on that rule)
    gauss_start: torch.Tensor   # [N] int32 exclusive prefix sum of tiles


def depth_bits_for(num_tiles: int) -> int:
    """Bits of the IEEE-f32 depth kept in the packed sort key."""
    return 32 - max(int(num_tiles + 1).bit_length(), 1)


def quantize_depth(depth: torch.Tensor, num_tiles: int) -> torch.Tensor:
    """Top d_bits of the f32 bit pattern as int32 (monotonic for depth > 0)."""
    raw = depth.to(torch.float32).contiguous().view(torch.int32)
    raw = raw.to(torch.int64) & 0xFFFFFFFF
    return (raw >> (32 - depth_bits_for(num_tiles))).to(torch.int32)


def compact_live_torch(starts, tiles, rect_min, rect_max, depth_q,
                       num_rendered):
    """Plain twin of kernel B2: (table int32 [N, 8], n_live int32 [1]).

    Rows (excl, incl, rmin_x, rmin_y, rect_w, depth_q, gid, 0): the live
    Gaussians (tiles > 0) first in Gaussian order, then the dead ones as
    empty spans at num_rendered (total, total, 0, ...), so the incl column
    is non-decreasing."""
    n = tiles.shape[0]
    dev = tiles.device
    live = tiles > 0
    order = torch.argsort((~live).to(torch.int8), stable=True)
    rect_w = torch.clamp(rect_max[:, 0] - rect_min[:, 0], min=1)
    gid = torch.arange(n, dtype=torch.int32, device=dev)
    rows = torch.stack([starts, starts + tiles, rect_min[:, 0],
                        rect_min[:, 1], rect_w, depth_q, gid,
                        torch.zeros_like(gid)], dim=-1)[order]
    n_live = live.sum(dtype=torch.int32).reshape(1)
    dead = gid >= n_live
    col = torch.arange(8, device=dev)
    filler = torch.where(col < 2, num_rendered, 0).to(torch.int32)
    table = torch.where(dead[:, None], filler[None, :], rows)
    return table.contiguous(), n_live


def compact_live(starts, tiles, rect_min, rect_max, depth_q, num_rendered):
    """Kernel B2, or its plain twin where `_kernels.use` says so."""
    if not _kernels.use(tiles):
        return compact_live_torch(starts, tiles, rect_min, rect_max, depth_q,
                                  num_rendered)
    n = tiles.shape[0]
    for name, t, shape in (("starts", starts, (n,)), ("tiles", tiles, (n,)),
                           ("rect_min", rect_min, (n, 2)),
                           ("rect_max", rect_max, (n, 2)),
                           ("depth_q", depth_q, (n,)),
                           ("num_rendered", num_rendered, ())):
        _kernels.require(t, name, torch.int32, shape)
    if n == 0:
        raise ValueError("compact_live: no Gaussians")
    dev = tiles.device
    block_live = torch.empty(-(-n // 1024), dtype=torch.int32, device=dev)
    n_live = torch.empty(1, dtype=torch.int32, device=dev)
    table = torch.empty((n, 8), dtype=torch.int32, device=dev)
    fn = _kernels.entry("compact_live", "adgs_compact_live", "ppppppipppp")
    err = fn(starts.data_ptr(), tiles.data_ptr(), rect_min.data_ptr(),
             rect_max.data_ptr(), depth_q.data_ptr(), num_rendered.data_ptr(),
             n, block_live.data_ptr(), n_live.data_ptr(), table.data_ptr(),
             _kernels.stream(tiles))
    _kernels.check(err, "compact_live")
    _kernels.launches["compact_live"] += 1
    return table, n_live


def expand_torch(table, n_live, num_rendered, capacity: int, grid_x: int,
                 d_bits: int, num_tiles: int):
    """Plain twin of kernel B1: (key int64 [R], gid int32 [R])."""
    del n_live  # the dead rows are empty spans: no slot falls in them
    n = table.shape[0]
    slot = torch.arange(capacity, dtype=torch.int32, device=table.device)
    # the owner of slot s is the first row whose inclusive end exceeds s
    row = torch.searchsorted(table[:, 1].contiguous(), slot, right=True)
    valid = slot < num_rendered
    r = table[torch.clamp(row, 0, max(n - 1, 0))]
    local = slot - r[:, 0]
    rect_w = torch.clamp(r[:, 4], min=1)    # dead rows hold 0
    ly = torch.div(local, rect_w, rounding_mode="floor")
    lx = local - ly * rect_w
    tile = (r[:, 3] + ly).long() * grid_x + (r[:, 2] + lx)
    key = (tile << d_bits) | (r[:, 5].long() & 0xFFFFFFFF)
    key = torch.where(valid, key, torch.full_like(key, num_tiles << d_bits))
    gid = torch.where(valid, r[:, 6], torch.zeros_like(r[:, 6]))
    return key, gid


def expand(table, n_live, num_rendered, capacity: int, grid_x: int,
           d_bits: int, num_tiles: int):
    """Kernel B1, or its plain twin where `_kernels.use` says so."""
    if not _kernels.use(table):
        return expand_torch(table, n_live, num_rendered, capacity, grid_x,
                            d_bits, num_tiles)
    n = table.shape[0]
    _kernels.require(table, "table", torch.int32, (n, 8))
    _kernels.require(n_live, "n_live", torch.int32, (1,))
    _kernels.require(num_rendered, "num_rendered", torch.int32, ())
    if n == 0:
        raise ValueError("expand: no Gaussians")
    key = torch.empty(capacity, dtype=torch.int64, device=table.device)
    gid = torch.empty(capacity, dtype=torch.int32, device=table.device)
    fn = _kernels.entry("expand", "adgs_expand", "pppiiiiippp")
    err = fn(table.data_ptr(), n_live.data_ptr(), num_rendered.data_ptr(), n,
             capacity, grid_x, d_bits, num_tiles, key.data_ptr(),
             gid.data_ptr(), _kernels.stream(table))
    _kernels.check(err, "expand")
    _kernels.launches["expand"] += 1
    return key, gid


def bin_gaussians(prep: Preprocessed, settings: RasterSettings,
                  capacity: int) -> Binning:
    """Kernels B2 and B1 (`compact_live`, `expand`) between the eager
    steps."""
    capacity = -(-capacity // INSTANCE_ALIGN) * INSTANCE_ALIGN
    tiles = prep.tiles_touched
    dev = tiles.device
    N = tiles.shape[0]
    num_tiles = settings.num_tiles
    if N == 0:
        zero_t = torch.zeros(num_tiles, dtype=torch.int32, device=dev)
        return Binning(
            gauss_id=torch.zeros(capacity, dtype=torch.int32, device=dev),
            tile_id=torch.full((capacity,), num_tiles, dtype=torch.int32,
                               device=dev),
            valid=torch.zeros(capacity, dtype=torch.bool, device=dev),
            tile_start=zero_t, tile_count=zero_t.clone(),
            num_rendered=torch.zeros((), dtype=torch.int32, device=dev),
            overflow=torch.zeros((), dtype=torch.bool, device=dev),
            slot_sorted=torch.full((capacity,), capacity, dtype=torch.int32,
                                   device=dev),
            gauss_start=torch.zeros(0, dtype=torch.int32, device=dev))

    offsets = torch.cumsum(tiles, dim=0, dtype=torch.int32)  # inclusive
    num_rendered = offsets[-1]
    starts = offsets - tiles                                  # exclusive
    d_bits = depth_bits_for(num_tiles)
    depth_q = quantize_depth(prep.depth, num_tiles)
    table, n_live = compact_live(starts, tiles, prep.rect_min.contiguous(),
                                 prep.rect_max.contiguous(), depth_q,
                                 num_rendered)
    key, gid = expand(table, n_live, num_rendered, capacity, settings.grid_x,
                      d_bits, num_tiles)

    key_s, slot_s = torch.sort(key, stable=True)
    gid_s = gid[slot_s]
    tile_s = (key_s >> d_bits).to(torch.int32)
    valid_s = tile_s < num_tiles

    t_idx = torch.arange(num_tiles, dtype=torch.int32, device=dev)
    tile_start = torch.searchsorted(tile_s, t_idx, right=False).to(torch.int32)
    tile_end = torch.searchsorted(tile_s, t_idx, right=True).to(torch.int32)
    slot_s = slot_s.to(torch.int32)
    return Binning(
        gauss_id=torch.where(valid_s, gid_s, torch.zeros_like(gid_s)),
        tile_id=tile_s, valid=valid_s, tile_start=tile_start,
        tile_count=tile_end - tile_start, num_rendered=num_rendered,
        overflow=num_rendered > capacity,
        slot_sorted=torch.where(valid_s, slot_s,
                                torch.full_like(slot_s, capacity)),
        gauss_start=starts)
