// A block-local stable counting sort by a digit of at most 8 bits, shared by
// the one-block digit sort (digit_sort_kernel in csrc/block_sort.cu, B4) and
// the group sort of the overlapped exchange (group_sort_send_kernel in
// csrc/exchange.cu, B7).
//
// The TPU kernels (gpu_radix_sort_tpu/ops/pallas_sort.py:185 `_sort_kv_kernel`
// and parallel/rdma_overlap.py:116 `_xchg_overlap_kernel`) sorted unique
// composites digit << pos_bits | i with a bitonic network carrying the key,
// because Mosaic has no scatter inside a kernel.  Hopper has one, so a block
// here ranks its keys and scatters them into shared memory:
//   * layout: kRankThreads threads, K <= 16 keys a thread, held in registers
//     warp-striped: keys[k] of lane l in warp w is slot w*32K + k*32 + l;
//   * count: each key adds one to its warp's counter of its digit (a
//     shared-memory atomic; only the totals matter here);
//   * scan: an exclusive scan over the (digit, warp) counters, digit-major
//     and warp-minor, gives each (digit, warp) the first sorted position of
//     its keys;
//   * place: for each k in order, the lanes of a warp whose keys share a
//     digit (its peers: one ballot a bit of the digit, the lane set
//     __match_any_sync gives) take their places from the warp's counter of
//     that digit, which the lowest peer advances by their number; a key goes
//     to the counter before the advance plus its peers in lower lanes.
// Slots are visited in input order (warp, then k, then lane), so keys with
// equal digits keep their input order: the sort is stable with no composite.
//
// Shared memory: the 1024K sorted slots (64 KB at 2^14 keys), 33 << width
// counter words (each digit's row of 32 warps padded to 33 words, so the
// lowest peers of distinct digits in one warp hit distinct banks; 33 KB at
// width 8) and 32 words for the scan: ~97 KB at 2^14 keys and 8 bits, so two
// blocks fit an SM's 228 KB.
//
// Bound: a key is read once from device memory and written once; in between
// it costs a shared atomic, 8 ballots, a shared-memory store and four
// barriers a pass, so device memory sees 8 bytes a key and the rest is
// instruction throughput and barrier latency.  tools/rank_variants.py times
// the alternatives on the card (ballots only for the digit's width,
// __match_any_sync for the peers, peers and one add a run in the count, an
// atomic add for the place); none made B7 faster on an H100 (PERF.md,
// Findings).

#pragma once

#include <stdint.h>

namespace grs {

constexpr int kRankThreads = 1024;
constexpr int kRankWarps = kRankThreads / 32;
constexpr int kMaxKeysPerThread = 16;  // 2^14 slots a block
constexpr int kMaxRankWidth = 8;       // bits one counting pass sorts by

// Keys a thread holds for n slots (the block holds 1024K slots; those past
// the caller's keys are pads).
__host__ __device__ constexpr int rank_keys_per_thread(long long n) {
  return n <= kRankThreads ? 1 : (int)((n + kRankThreads - 1) / kRankThreads);
}

// Words of shared memory rank_scatter needs beside the slots.
__host__ __device__ constexpr int rank_scratch_words(int width) {
  return (33 << width) + kRankWarps;
}

// The slot keys[k] of the calling thread holds.
__device__ __forceinline__ int rank_slot(int k, int K) {
  return (threadIdx.x >> 5) * 32 * K + k * 32 + (threadIdx.x & 31);
}

// The lanes of the warp whose digit (< 2^8) equals this lane's; all lanes
// call it.  Bits above a narrower digit's width are 0 in every lane, so they
// leave the peers as they are.
__device__ __forceinline__ unsigned warp_peers(uint32_t digit) {
  unsigned peers = 0xFFFFFFFFu;
#pragma unroll
  for (int b = 0; b < kMaxRankWidth; ++b) {
    const bool bit = (digit >> b) & 1u;
    const unsigned set = __ballot_sync(0xFFFFFFFFu, bit);
    peers &= bit ? set : ~set;
  }
  return peers;
}

// In place, the exclusive scan of the 32 << width counters in digit-major
// order: entry j = d * 32 + w lives at word j + j / 32 (= d * 33 + w).
__device__ __forceinline__ void scan_counters(uint32_t* cnt, uint32_t* sums,
                                              int width) {
  const int entries = 32 << width;
  const int per = entries > kRankThreads ? entries / kRankThreads : 1;
  const int first = threadIdx.x * per;
  const int end = min(first + per, entries);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t total = 0;
  for (int j = first; j < end; ++j) total += cnt[j + (j >> 5)];
  uint32_t incl = total;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t up = __shfl_up_sync(0xFFFFFFFFu, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const uint32_t mine = sums[lane];
    uint32_t x = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t up = __shfl_up_sync(0xFFFFFFFFu, x, d);
      if (lane >= d) x += up;
    }
    sums[lane] = x - mine;
  }
  __syncthreads();
  uint32_t run = sums[warp] + incl - total;
  for (int j = first; j < end; ++j) {
    const uint32_t c = cnt[j + (j >> 5)];
    cnt[j + (j >> 5)] = run;
    run += c;
  }
  __syncthreads();
}

// Sorts the block's 1024K slots stably by bits [shift, shift + width) of
// each key, width in [1, 8], into out[0, 1024K): keys[k] of each thread holds
// slot rank_slot(k, K).  scratch holds rank_scratch_words(width) words.  All
// threads of the block call it.  It starts and ends with a barrier, so the
// caller may read out (and reuse out and scratch) around it.
__device__ __forceinline__ void rank_scatter(
    const uint32_t (&keys)[kMaxKeysPerThread], int K, int shift, int width,
    uint32_t* out, uint32_t* scratch) {
  uint32_t* cnt = scratch;
  uint32_t* sums = scratch + (33 << width);
  const uint32_t mask = (1u << width) - 1u;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;

  for (int j = threadIdx.x; j < (33 << width); j += kRankThreads) cnt[j] = 0;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kMaxKeysPerThread; ++k) {
    if (k < K) atomicAdd(&cnt[((keys[k] >> shift) & mask) * 33 + warp], 1u);
  }
  __syncthreads();
  scan_counters(cnt, sums, width);
#pragma unroll
  for (int k = 0; k < kMaxKeysPerThread; ++k) {
    if (k < K) {
      const uint32_t d = (keys[k] >> shift) & mask;
      const unsigned peers = warp_peers(d);
      const int leader = __ffs(peers) - 1;
      uint32_t base = 0;
      if (lane == leader) {
        base = cnt[d * 33 + warp];
        cnt[d * 33 + warp] = base + __popc(peers);
      }
      base = __shfl_sync(0xFFFFFFFFu, base, leader);
      out[base + __popc(peers & below)] = keys[k];
      __syncwarp();  // this k's counters before the next k reads them
    }
  }
  __syncthreads();
}

}  // namespace grs
