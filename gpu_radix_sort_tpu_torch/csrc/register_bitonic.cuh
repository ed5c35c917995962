// The bitonic network with the keys in registers, for the one-block sort
// (single_block_sort_kernel in csrc/block_sort.cu, B3) and, in its windowed
// form below, the tile pass (block_sort_kernel, B1).  The counterpart of
// the JAX package's in-VMEM network, gpu_radix_sort_tpu/ops/pallas_sort.py:
// 68-177 `_bitonic_body`, keys only.  Keys move through shared memory only
// where the two keys of a compare-exchange live in different warps.
//
// Layout: a block's 2^LOG slots held by 2^(LOG-R) threads, 2^R a thread:
// slot s = 2^LOG blockIdx.x + 2^R t + r is keys[r] of thread t.  So bits
// [0, R) of a slot are the register, the next 5 the lane, the next LOG-R-5
// the warp and the rest the block.  A stage of stride 2^j is
//   * j < R:     a compare-exchange of two registers of one thread;
//   * j < R + 5: a __shfl_xor_sync of each register with lane ^ 2^(j-R);
//   * otherwise: through shared memory: each thread stores its keys as
//     16-byte vectors (vector q of thread t at q * threads + t, so a warp's
//     stores and loads are conflict-free), one barrier, then loads those of
//     thread t ^ 2^(j-R) one vector at a time.  Two buffers alternate, so
//     a stage needs one barrier: every load of one stage ends before its
//     thread reaches the next stage's barrier, and a buffer is written
//     again only after that.
// Every stage outside the registers moves all 2^LOG keys through the SM's
// shuffle or shared-memory path, which is what bounds the network; more
// keys a thread keep more stages in registers.  At 2^14 keys and R = 4
// that is 50 register, 40 shuffle and 15 shared-memory stages of 105; at
// R = 5, 60, 35 and 10.
//
// Phases.  Phase p merges runs of 2^p slots.  The network runs phases
// 1..`phases`: all LOG of them sort the block, fewer sort each run of
// 2^phases slots on its own (the tile pass at tiles below the block).
//
// Direction.  In phase p < `phases`, slot s sorts descending where bit p
// of s is set; in the last phase, where bit `phases` is set if
// `alternate`, else nowhere.  So with `alternate` the runs of 2^phases
// slots alternate in direction by global run index (bit `phases` of the
// slot may be a block bit).  The keys of descending slots are held
// complemented (~x reverses uint32 order), so every compare-exchange keeps
// the minimum at the lower slot: one min and one max.  Before phase p the
// complement moves from the direction of phase p - 1 to that of phase p;
// after the last phase it is taken off.
//
// ops/block_sort.py's tile_network_emulated (and single_block.py's
// network_emulated) repeat this schedule in torch for the CPU tests,
// windowed_network_emulated the windowed one.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace grs {

constexpr int kLaneLog = 5;  // slot bits of the lanes of a warp

// Bit b of slot 2^LOG blockIdx.x + 2^R threadIdx.x + r (r is a constant
// once unrolled).
template <int LOG, int R>
__device__ __forceinline__ uint32_t slot_bit(int r, int b) {
  return b < R ? (uint32_t)(r >> b) & 1u
       : b < LOG ? (threadIdx.x >> (b - R)) & 1u
                 : (blockIdx.x >> (b - LOG)) & 1u;
}

// 1 where slot (r, threadIdx.x) sorts descending in phase p of a network
// of `phases` phases (0 before the first phase).
template <int LOG, int R>
__device__ __forceinline__ uint32_t descending(int r, int p, int phases, bool alternate) {
  return p > 0 && (p < phases || alternate) ? slot_bit<LOG, R>(r, p) : 0u;
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

// Phases P..phases of the network (`phases` is the same in every thread
// of the block, so a barrier is reached by all or none).
template <int LOG, int R, int P>
__device__ __forceinline__ void network_phases(uint32_t (&keys)[1 << R], uint4* buf,
                                               int& parity, int phases, bool alternate) {
  if constexpr (P <= LOG) {
    if (P > phases) return;
#pragma unroll
    for (int r = 0; r < (1 << R); ++r) {
      keys[r] ^= 0u - (descending<LOG, R>(r, P - 1, phases, alternate) ^
                       descending<LOG, R>(r, P, phases, alternate));
    }
    network_strides<LOG, R, P - 1>(keys, buf, parity);
    network_phases<LOG, R, P + 1>(keys, buf, parity, phases, alternate);
  }
}

// The key a slot past the end holds so that it sorts last in its run's
// final direction: 0xFFFFFFFF where the run ascends, 0 where it descends.
template <int LOG, int R>
__device__ __forceinline__ uint32_t pad_key(int r, int phases, bool alternate) {
  return ~(0u - descending<LOG, R>(r, phases, phases, alternate));
}

// Sorts each run of 2^phases slots of the block (0 <= phases <= LOG),
// ascending, or with `alternate` descending where bit `phases` of the slot
// is set: after it, keys[r] of thread t holds slot 2^R t + r.  Every
// thread of the block (2^(LOG-R) of them) calls it; buf is 2 * 2^LOG
// words of shared memory, 16-byte aligned (unused when one warp spans a
// run).
template <int LOG, int R>
__device__ __forceinline__ void register_bitonic_sort(uint32_t (&keys)[1 << R], uint4* buf,
                                                      int phases, bool alternate) {
  static_assert(R >= 2 && LOG >= R + kLaneLog, "whole warps of 16-byte vectors");
  int parity = 0;
  network_phases<LOG, R, 1>(keys, buf, parity, phases, alternate);
#pragma unroll
  for (int r = 0; r < (1 << R); ++r) {
    keys[r] ^= 0u - descending<LOG, R>(r, phases, phases, alternate);
  }
}

// ---------------------------------------------------------------------------
// The windowed network: the same compare-exchanges, fewer instructions.
// With R = 5, window K is the layout whose register bits are slot bits
// [K, K + 5); the other slot bits, in order, are the thread's (so the lanes
// are the lowest five of them).  Window 0 is the layout above.  A round
// trip from window K1 to K2 stores every key to shared memory at word
// s + (s >> 5) of its slot s (a pad word every 32: the 32 lanes of a warp
// hit 32 banks for every register in every window, and the word of
// register r is the thread's base word plus a constant, an immediate
// offset), one barrier, loads the keys of window K2, one more barrier.
// The compare-exchanges of a stride inside the window are a min and a max
// of two registers, one instruction a key, where a stride across lanes
// takes a shuffle, a min, a max and a select a key.  Phase p:
//   p <= 5: window 0, all strides in registers;
//   p == 6: window 0, stride 2^5 by shuffles;
//   p >= 7: round trips to windows p - 5, p - 10, ... (while above 0), then
//     to window 0; each runs the phase's next strides in registers.
// At 2^14 keys that is 20 round trips and one shuffle stage a block,
// against 10 shared-memory and 35 shuffle stages all across lanes.
// ---------------------------------------------------------------------------

// The padded word of slot s.
__host__ __device__ constexpr int padded_word(int s) { return s + (s >> 5); }

// The word of register 0 of thread t in window K (the slot's bits outside
// [K, K + R) are t's), and of register r relative to it: the two parts of
// the slot have no bit in common, so their words add.
template <int R, int K>
__device__ __forceinline__ int window_base(int t) {
  return padded_word((t & ((1 << K) - 1)) | ((t >> K) << (K + R)));
}

template <int K>
__host__ __device__ constexpr int register_word(int r) {
  return padded_word(r << K);
}

template <int R, int K1, int K2>
__device__ __forceinline__ void round_trip(uint32_t (&keys)[1 << R], uint32_t* buf) {
  uint32_t* b1 = buf + window_base<R, K1>(threadIdx.x);
#pragma unroll
  for (int r = 0; r < (1 << R); ++r) b1[register_word<K1>(r)] = keys[r];
  __syncthreads();
  const uint32_t* b2 = buf + window_base<R, K2>(threadIdx.x);
#pragma unroll
  for (int r = 0; r < (1 << R); ++r) keys[r] = b2[register_word<K2>(r)];
  __syncthreads();
}

// Strides 2^J down to 2^K in window K: registers only.
template <int R, int K, int J>
__device__ __forceinline__ void window_strides(uint32_t (&keys)[1 << R]) {
  if constexpr (J >= K) {
#pragma unroll
    for (int r = 0; r < (1 << R); ++r) {
      if ((r & (1 << (J - K))) == 0) {
        const uint32_t a = keys[r], b = keys[r | (1 << (J - K))];
        keys[r] = min(a, b);
        keys[r | (1 << (J - K))] = max(a, b);
      }
    }
    window_strides<R, K, J - 1>(keys);
  }
}

// From window CUR, a round trip to window K and strides 2^TOP..2^K there;
// then the next window down, until window 0 has run stride 1.
template <int R, int CUR, int K, int TOP>
__device__ __forceinline__ void window_chunks(uint32_t (&keys)[1 << R], uint32_t* buf) {
  round_trip<R, CUR, K>(keys, buf);
  window_strides<R, K, TOP>(keys);
  if constexpr (K > 0) {
    window_chunks<R, K, (K > R ? K - R : 0), K - 1>(keys, buf);
  }
}

template <int LOG, int R, int P>
__device__ __forceinline__ void windowed_phases(uint32_t (&keys)[1 << R], uint32_t* buf,
                                                int phases, bool alternate) {
  if constexpr (P <= LOG) {
    if (P > phases) return;
#pragma unroll
    for (int r = 0; r < (1 << R); ++r) {
      keys[r] ^= 0u - (descending<LOG, R>(r, P - 1, phases, alternate) ^
                       descending<LOG, R>(r, P, phases, alternate));
    }
    if constexpr (P <= R + 1) {
      int parity = 0;  // unused: no stage here crosses warps
      network_strides<LOG, R, P - 1>(keys, reinterpret_cast<uint4*>(buf), parity);
    } else {
      window_chunks<R, 0, P - R, P - 1>(keys, buf);
    }
    windowed_phases<LOG, R, P + 1>(keys, buf, phases, alternate);
  }
}

// Words of shared memory the windowed network takes for 2^LOG slots.
constexpr int windowed_words(int log) { return padded_word((1 << log) - 1) + 1; }

// register_bitonic_sort's result by the windowed network: R = 5, buf is
// windowed_words(LOG) words of shared memory.
template <int LOG, int R>
__device__ __forceinline__ void windowed_bitonic_sort(uint32_t (&keys)[1 << R], uint32_t* buf,
                                                      int phases, bool alternate) {
  static_assert(R == kLaneLog && LOG >= R + kLaneLog, "five register bits, whole warps");
  windowed_phases<LOG, R, 1>(keys, buf, phases, alternate);
#pragma unroll
  for (int r = 0; r < (1 << R); ++r) {
    keys[r] ^= 0u - descending<LOG, R>(r, phases, phases, alternate);
  }
}

}  // namespace grs
