// The bitonic network with the keys in registers, for the one-block sort
// (single_block_sort_kernel in csrc/block_sort.cu, B3).  The counterpart of
// the JAX package's in-VMEM network, gpu_radix_sort_tpu/ops/pallas_sort.py:
// 68-177 `_bitonic_body`, keys only.  bitonic.cuh's network (B1's tile pass)
// runs every stage in shared memory; this one moves keys through shared
// memory only where the two keys of a compare-exchange live in different
// warps.
//
// Layout: 2^LOG slots held by 2^(LOG-R) threads, 2^R a thread: slot
// s = 2^R t + r is keys[r] of thread t.  So bits [0, R) of a slot are the
// register, the next 5 the lane and the rest the warp.  A stage of stride
// 2^j is
//   * j < R:     a compare-exchange of two registers of one thread;
//   * j < R + 5: a __shfl_xor_sync of each register with lane ^ 2^(j-R);
//   * otherwise: through shared memory: each thread stores its keys as
//     16-byte vectors (vector q of thread t at q * threads + t, so a warp's
//     stores and loads are conflict-free), one barrier, then loads those of
//     thread t ^ 2^(j-R) one vector at a time.  Two buffers alternate, so a
//     stage needs one barrier: every load of one stage ends before its
//     thread reaches the next stage's barrier, and a buffer is written
//     again only after that.
// Every stage outside the registers moves all 2^LOG keys through the SM's
// shuffle or shared-memory path, which is what bounds the network; more
// keys a thread keep more stages in registers.  At 2^14 keys and R = 4
// that is 50 register, 40 shuffle and 15 shared-memory stages of 105; at
// R = 6, 69, 30 and 6.
//
// Direction.  Slot s sorts descending in phase p (runs of 2^p) where bit p of
// s is set.  The keys of such slots are held complemented (~x reverses
// uint32 order), so every compare-exchange keeps the minimum at the lower
// slot: one min and one max.  Before phase p the complement moves from bit
// p - 1 to bit p of the slot; after the last phase (bit LOG, clear on every
// slot) no key is complemented.
//
// ops/single_block.py's network_emulated repeats this schedule in torch for
// the CPU tests.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace grs {

constexpr int kLaneLog = 5;  // slot bits of the lanes of a warp

// Bit b of slot 2^R threadIdx.x + r (r is a constant once unrolled).
template <int R>
__device__ __forceinline__ uint32_t slot_bit(int r, int b) {
  return b < R ? (uint32_t)(r >> b) & 1u : (threadIdx.x >> (b - R)) & 1u;
}

// Before phase P: complement by bit P of the slot instead of bit P - 1.
template <int R, int P>
__device__ __forceinline__ void fold_direction(uint32_t (&keys)[1 << R]) {
#pragma unroll
  for (int r = 0; r < (1 << R); ++r) {
    const uint32_t was = P > 1 ? slot_bit<R>(r, P - 1) : 0u;
    keys[r] ^= 0u - (was ^ slot_bit<R>(r, P));
  }
}

// One stage of stride 2^J over the block's 2^LOG keys.
template <int LOG, int R, int J>
__device__ __forceinline__ void network_stage(uint32_t (&keys)[1 << R], uint4* buf,
                                              int& parity) {
  constexpr int kThreads = 1 << (LOG - R);
  constexpr int kVectors = (1 << R) / 4;
  if constexpr (J < R) {
#pragma unroll
    for (int r = 0; r < (1 << R); ++r) {
      if ((r & (1 << J)) == 0) {
        const uint32_t a = keys[r], b = keys[r | (1 << J)];
        keys[r] = min(a, b);
        keys[r | (1 << J)] = max(a, b);
      }
    }
  } else if constexpr (J < R + kLaneLog) {
    const int m = 1 << (J - R);
    const bool lower = (threadIdx.x & m) == 0;
#pragma unroll
    for (int r = 0; r < (1 << R); ++r) {
      const uint32_t y = __shfl_xor_sync(0xFFFFFFFFu, keys[r], m);
      keys[r] = lower ? min(keys[r], y) : max(keys[r], y);
    }
  } else {
    const int m = 1 << (J - R);
    const bool lower = (threadIdx.x & m) == 0;
    uint4* b = buf + parity * kVectors * kThreads;
    parity ^= 1;
#pragma unroll
    for (int q = 0; q < kVectors; ++q) {
      b[q * kThreads + threadIdx.x] = make_uint4(keys[4 * q], keys[4 * q + 1],
                                                 keys[4 * q + 2], keys[4 * q + 3]);
    }
    __syncthreads();
    const int partner = threadIdx.x ^ m;
#pragma unroll
    for (int q = 0; q < kVectors; ++q) {
      const uint4 y = b[q * kThreads + partner];
      const uint32_t ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint32_t& x = keys[4 * q + e];
        x = lower ? min(x, ys[e]) : max(x, ys[e]);
      }
    }
  }
}

// Strides 2^J, 2^(J-1), ..., 1 of one phase.
template <int LOG, int R, int J>
__device__ __forceinline__ void network_strides(uint32_t (&keys)[1 << R], uint4* buf,
                                                int& parity) {
  if constexpr (J >= 0) {
    network_stage<LOG, R, J>(keys, buf, parity);
    network_strides<LOG, R, J - 1>(keys, buf, parity);
  }
}

// Phases P..LOG of the network.
template <int LOG, int R, int P>
__device__ __forceinline__ void network_phases(uint32_t (&keys)[1 << R], uint4* buf,
                                               int& parity) {
  if constexpr (P <= LOG) {
    fold_direction<R, P>(keys);
    network_strides<LOG, R, P - 1>(keys, buf, parity);
    network_phases<LOG, R, P + 1>(keys, buf, parity);
  }
}

// Sorts the block's 2^LOG keys ascending: after it, keys[r] of thread t
// holds slot 2^R t + r.  Every thread of the block (2^(LOG-R) of them)
// calls it; buf is 2^(LOG+1) words of shared memory, 16-byte aligned
// (unused when one warp holds every key).
template <int LOG, int R>
__device__ __forceinline__ void register_bitonic_sort(uint32_t (&keys)[1 << R], uint4* buf) {
  static_assert(R >= 2 && LOG >= R + kLaneLog, "whole warps of 16-byte vectors");
  int parity = 0;
  network_phases<LOG, R, 1>(keys, buf, parity);
}

}  // namespace grs
