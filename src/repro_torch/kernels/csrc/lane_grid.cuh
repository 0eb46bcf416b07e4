// The flat grid of the fused multi-session kernels K6a and K6b
// (csrc/a2_count.cu, csrc/a1_count.cu).
//
// A lane is one counter's batch: its own tensors, M episodes and n_events
// events. The wrapper lists the lanes heaviest first (n_events x M,
// descending) in a device table of int64 descriptors and writes into each
// the index of its first 128-episode tile, so the tiles of all lanes are
// numbered 0 .. sum(ceil(M_l / 128)) - 1 in that order and blockIdx.x is a
// tile. A block finds its lane as the last one whose first tile is at most
// its own: the lanes' first tiles never decrease along the table.

#pragma once

#include <cuda_runtime.h>

namespace lane_grid {

// The lane of tile ``tile``. Every warp of the block computes it on its
// own, 32 descriptors a step: lane k of the warp reads the first tile of
// descriptor base + k, and the ballot of "at most ``tile``" is a run of
// ones from bit 0, whose length says how many of those lanes start at or
// before the tile. Every thread of the warp must call it.
__device__ __forceinline__ int find_lane(const long long* __restrict__ lanes,
                                         int n_lanes, int words,
                                         int tile0_word, int tile) {
  const int k = threadIdx.x % 32;
  int found = 0;
  for (int base = 0; base < n_lanes; base += 32) {
    const int i = base + k;
    const bool starts_before =
        i < n_lanes && lanes[static_cast<size_t>(i) * words + tile0_word] <=
                           static_cast<long long>(tile);
    const unsigned run = __ballot_sync(0xffffffffu, starts_before);
    found = base + __popc(run) - 1;
    if (run != 0xffffffffu) break;
  }
  return found;
}

}  // namespace lane_grid
