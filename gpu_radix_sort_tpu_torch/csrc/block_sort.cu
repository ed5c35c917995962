// Bitonic sort of one tile of uint32 keys per CUDA block, in shared memory,
// and the one-block stable digit sort.
//
// Replaces three Pallas kernels of the JAX package:
//   * gpu_radix_sort_tpu/ops/pallas_merge.py:131 `_tile_sort_kernel` (B1): a
//     grid over tiles, odd tiles sorted descending under `alternate`, so that
//     the merge levels see [ascending; descending] pairs;
//   * gpu_radix_sort_tpu/ops/pallas_sort.py:180 `_sort_kernel` (B3): the whole
//     array in one program, padded to a power of two with 0xFFFFFFFF.  Here
//     that is a grid of one block with `alternate` off;
//   * gpu_radix_sort_tpu/ops/pallas_sort.py:185 `_sort_kv_kernel` (B4): the
//     stable digit sort of n <= 2^14 keys in one block (`digit_sort_kernel`
//     below), LSD counting passes of block_rank.cuh.
//
// Tile size.  A TPU tile was 2^17 keys (512 KiB of VMEM); a Hopper block has
// at most 227 KB of shared memory.  The tile is at most 2^14 keys = 64 KB, so
// two blocks of 1024 threads fill an SM's 2048 thread slots with 128 KB of
// its shared memory; 2^15 keys would leave room for one block (half the
// threads), 2^13 would add a merge level at 64M keys.  64 KB is above the
// 48 KB static limit, so the launch raises the block's dynamic limit first.
//
// Bound on this card: the network does log2(T)(log2(T)+1)/2 compare-exchange
// stages over the tile (105 at T = 2^14), each a shared-memory read and
// write of every key and one __syncthreads; device memory is touched once
// (4 bytes read and 4 written per key).  So it is bound by shared-memory
// bandwidth and barrier latency, not by HBM.  Design: keep it simple and
// right -- every stage in shared memory; register and warp-shuffle stages
// for small strides are later work.
//
// Ragged tiles: slots past the last key are padded with 0xFFFFFFFF in the
// sort domain (after the complement of a descending tile), so they sort last
// and are never written.  Descending tiles complement keys in and out:
// ~x reverses uint32 order exactly.  `out` must not alias `x`.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bitonic.cuh"
#include "block_rank.cuh"

namespace {

using grs::bitonic_network;

constexpr int kThreads = grs::kNetworkThreads;
constexpr int kMaxTile = 1 << 14;

__global__ void __launch_bounds__(kThreads)
block_sort_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                  long long n, int tile, int alternate) {
  extern __shared__ uint32_t s[];
  const long long start = (long long)blockIdx.x * tile;
  const int m = (int)min((long long)tile, n - start);
  const uint32_t flip = (alternate && (blockIdx.x & 1)) ? 0xFFFFFFFFu : 0u;

  for (int i = threadIdx.x; i < tile; i += kThreads) {
    s[i] = i < m ? (x[start + i] ^ flip) : 0xFFFFFFFFu;
  }
  __syncthreads();

  bitonic_network(s, tile);

  for (int i = threadIdx.x; i < m; i += kThreads) {
    out[start + i] = s[i] ^ flip;
  }
}

// B4.  ceil(width / 8) LSD counting passes of block_rank.cuh over the n
// keys, 8 bits a pass, the last one narrower; between passes the sorted
// slots go from shared memory back into registers.  Slots [n, 1024K) hold
// 0xFFFFFFFF: every digit of such a pad is the largest and the pads come
// last in input order, so the stable passes keep them last, and they are
// never written.  Any width up to 32 works.  Bound: one block on one SM, a
// few microseconds of passes and barriers against 8 bytes a key of device
// memory, so launch latency bounds it; it is the route for small n only.
__global__ void __launch_bounds__(grs::kRankThreads)
digit_sort_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                  int n, int offset, int width) {
  extern __shared__ __align__(16) uint32_t slots[];
  const int K = grs::rank_keys_per_thread(n);
  uint32_t* scratch = slots + K * grs::kRankThreads;
  uint32_t keys[grs::kMaxKeysPerThread];
#pragma unroll
  for (int k = 0; k < grs::kMaxKeysPerThread; ++k) {
    if (k < K) {
      const int i = grs::rank_slot(k, K);
      keys[k] = i < n ? x[i] : 0xFFFFFFFFu;
    }
  }
  for (int done = 0; done < width; done += grs::kMaxRankWidth) {
    if (done > 0) {
#pragma unroll
      for (int k = 0; k < grs::kMaxKeysPerThread; ++k) {
        if (k < K) keys[k] = slots[grs::rank_slot(k, K)];
      }
    }
    grs::rank_scatter(keys, K, offset + done,
                      min(grs::kMaxRankWidth, width - done), slots, scratch);
  }
  for (int i = threadIdx.x; i < n; i += grs::kRankThreads) {
    out[i] = slots[i];
  }
}

int digit_sort_smem(long long n, int width) {
  return (grs::rank_keys_per_thread(n) * grs::kRankThreads +
          grs::rank_scratch_words(width < grs::kMaxRankWidth ? width
                                                        : grs::kMaxRankWidth)) *
         (int)sizeof(uint32_t);
}

}  // namespace

// Sorts each consecutive `tile` keys of x[0, n) into out (the last tile may be
// short).  `tile` is a power of two <= 2^14.  With `alternate`, odd tiles are
// written descending.  Launches on `stream`; returns cudaGetLastError().
extern "C" int grs_block_sort_u32(const uint32_t* x, uint32_t* out,
                                  long long n, int tile, int alternate,
                                  cudaStream_t stream) {
  if (n <= 0 || tile <= 0 || tile > kMaxTile || (tile & (tile - 1)) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = tile * (int)sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      block_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long grid = (n + tile - 1) / tile;
  block_sort_kernel<<<(unsigned)grid, kThreads, smem, stream>>>(
      x, out, n, tile, alternate);
  return (int)cudaGetLastError();
}

// Stable sort of x[0, n) by bits [offset, offset + width) into out, in one
// block: n <= 2^14 (the sorted slots and the counters take ~97 KB of shared
// memory at 2^14).  Launches on `stream`; returns cudaGetLastError().  `out`
// must not alias `x`.
extern "C" int grs_digit_sort_u32(const uint32_t* x, uint32_t* out,
                                  long long n, int offset, int width,
                                  cudaStream_t stream) {
  if (n <= 0 || n > kMaxTile || width < 1 || offset < 0 ||
      offset + width > 32) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = digit_sort_smem(n, width);
  cudaError_t err = cudaFuncSetAttribute(
      digit_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  digit_sort_kernel<<<1, grs::kRankThreads, smem, stream>>>(
      x, out, (int)n, offset, width);
  return (int)cudaGetLastError();
}

// The dynamic shared memory of digit_sort_kernel at n keys and `width` bits
// into *smem, and the blocks that fit one SM with it
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) into *blocks.
extern "C" int grs_digit_sort_blocks_per_sm(long long n, int width, int* blocks,
                                            int* smem_bytes) {
  if (n <= 0 || n > kMaxTile || width < 1 || width > 32 || blocks == nullptr ||
      smem_bytes == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = digit_sort_smem(n, width);
  *smem_bytes = smem;
  cudaError_t err = cudaFuncSetAttribute(
      digit_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, digit_sort_kernel, grs::kRankThreads, smem);
}

// The CUDA runtime's text for an error code returned by the entry points.
extern "C" const char* grs_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
