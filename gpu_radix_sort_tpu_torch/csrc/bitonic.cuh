// The in-shared-memory bitonic network of the block sorts (csrc/block_sort.cu,
// B1 and B3): the counterpart of the JAX package's in-VMEM network,
// gpu_radix_sort_tpu/ops/pallas_sort.py:68-177 `_bitonic_body`, keys only.
// The stable digit sorts (B4, B7) rank with csrc/block_rank.cuh instead.
//
// Every kernel that runs it launches kNetworkThreads threads a block.

#pragma once

#include <stdint.h>

namespace grs {

constexpr int kNetworkThreads = 1024;

// The bitonic network over s[0, size), size a power of two, ascending.
__device__ inline void bitonic_network(uint32_t* s, int size) {
  const int half = size >> 1;
  for (int k = 2; k <= size; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < half; i += kNetworkThreads) {
        // i-th pair of this stage: lo has bit j clear, hi = lo | j.
        const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
        const int hi = lo | j;
        const uint32_t a = s[lo];
        const uint32_t b = s[hi];
        const bool ascending = (lo & k) == 0;
        if ((a > b) == ascending) {
          s[lo] = b;
          s[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

}  // namespace grs
