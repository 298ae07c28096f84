// The order in which a compositing kernel's blocks take the tiles:
// longest first, so that the longest tiles do not set the launch's tail.
// Shared by B3 (composite.cu) and B4 (composite_bwd.cu); each tile's
// output is the same in any order.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace adgs {

// blocks of 256 threads for rank_tiles over num_tiles tiles
inline int rank_blocks(int num_tiles) { return (num_tiles + 7) / 8; }

// Warp t of a grid of rank_blocks(num_tiles) blocks of 256 threads ranks
// tile t: its position in the tiles by descending instance count, ties in
// tile order, is the number of tiles u with count[u] > count[t], or
// count[u] == count[t] and u < t (a stable sort by descending count), and
// order[rank] = t. Every lane of the block calls it.
__device__ __forceinline__ void rank_tiles(
    const int32_t* __restrict__ tile_count, int num_tiles,
    int32_t* __restrict__ order) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (t >= num_tiles) return;   // warp-uniform
  const int ct = tile_count[t];
  unsigned ahead = 0;
  for (int u = lane; u < num_tiles; u += 32) {
    const int cu = tile_count[u];
    ahead += cu > ct || (cu == ct && u < t);
  }
  const unsigned rank = __reduce_add_sync(0xffffffffu, ahead);
  if (lane == 0) order[rank] = t;
}

}  // namespace adgs
