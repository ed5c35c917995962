// The block sorts of uint32 keys: the tile pass and the one-block sort on
// the bitonic network with the keys in registers (register_bitonic.cuh),
// and the one-block stable digit sort.
//
// Replaces three Pallas kernels of the JAX package:
//   * gpu_radix_sort_tpu/ops/pallas_merge.py:131 `_tile_sort_kernel` (B1): a
//     grid over tiles, odd tiles sorted descending under `alternate`, so that
//     the merge levels see [ascending; descending] pairs (`block_sort_kernel`
//     below);
//   * gpu_radix_sort_tpu/ops/pallas_sort.py:180 `_sort_kernel` (B3): the whole
//     array in one program, padded to a power of two with 0xFFFFFFFF
//     (`single_block_sort_kernel` below);
//   * gpu_radix_sort_tpu/ops/pallas_sort.py:185 `_sort_kv_kernel` (B4): the
//     stable digit sort of n <= 2^14 keys in one block (`digit_sort_kernel`
//     below), LSD counting passes of block_rank.cuh.
//
// B1, the tile pass.  A TPU tile was 2^17 keys (512 KiB of VMEM); a Hopper
// block has at most 227 KB of shared memory.  Every block spans 2^14 slots
// (kTileLog: 64 KB, one tile of the largest size, or 2^(14 - log2 tile)
// smaller tiles) and runs phases 1..log2(tile) of the register network, so
// one kernel takes every power-of-two tile from 1 to 2^14; block starts are
// whole tiles, so bit log2(tile) of a slot is its tile's parity, which is
// the last phase's direction under `alternate`.  Bound on this card: the
// network's 105 compare-exchange stages at 2^14 keys, a min or a max a key
// each, against 8 bytes a key of device memory; so the SM's integer pipe
// and its shuffle/shared-memory pipe bound it, not HBM.  The design keeps
// 32 keys a thread in registers and runs the windowed network of
// register_bitonic.cuh (20 round trips through shared memory and one
// shuffle stage a block, where the same network with every lane stride by
// shuffles takes 10 shared-memory and 35 shuffle stages and half again the
// integer instructions), loads and stores 16-byte vectors, and sizes the
// block (512 threads, one 66 KB buffer, at most 64 registers) so that two
// blocks share an SM and one's loads, stores and barriers overlap the
// other's network.
// tools/network_variants.py times the other forms (PERF.md).
//
// B3 is one block on one SM of 132: launch latency and the network's own
// shuffles and shared-memory traffic bound it, not its 8 bytes a key of
// device memory.  So its keys stay in registers (2^kSingleRegLog
// consecutive keys a thread), each thread loads and stores its keys as
// 16-byte vectors, and the dynamic shared-memory limit is raised once per
// device, not per call.
//
// Ragged blocks: slots past the last key hold a pad that sorts last in its
// run's final direction (0xFFFFFFFF ascending, 0 descending), so the pads
// are never written.  `out` must not alias `x`.

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_rank.cuh"
#include "register_bitonic.cuh"

namespace {

constexpr int kMaxTile = 1 << 14;
constexpr int kMaxDevices = 64;  // devices whose attributes are remembered

// B1's geometry (tools/network_variants.py patches a copy to time others).
constexpr int kTileLog = 14;  // slots a block of the tile pass spans
constexpr int kTileRegLog = 5;  // log2 of the keys a thread holds
constexpr int kTileMinBlocks = 2;  // blocks an SM the registers are capped for
constexpr int kTileKeys = 1 << kTileRegLog;
constexpr int kTileThreads = 1 << (kTileLog - kTileRegLog);
// The first phase that goes through shared memory, and the bytes it takes.
constexpr int kTileSharedPhase = kTileRegLog + 2;
constexpr int kTileSmem = grs::windowed_words(kTileLog) * (int)sizeof(uint32_t);
static_assert(1 << kTileLog == kMaxTile, "a block spans the largest tile");

// Loads the 2^R slots of this thread starting at key `first` of x[0, n)
// (pads past n from pad_key), as 16-byte vectors where the pointer is
// aligned and the slots are all keys, else key by key.
template <int LOG, int R>
__device__ __forceinline__ void load_slots(const uint32_t* __restrict__ x, long long n,
                                           long long first, uint32_t (&keys)[1 << R],
                                           int phases, bool alternate) {
  if (first + (1 << R) <= n && (reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    const uint4* v = reinterpret_cast<const uint4*>(x + first);
#pragma unroll
    for (int q = 0; q < (1 << R) / 4; ++q) {
      const uint4 y = __ldg(v + q);
      keys[4 * q] = y.x;
      keys[4 * q + 1] = y.y;
      keys[4 * q + 2] = y.z;
      keys[4 * q + 3] = y.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < (1 << R); ++r) {
      keys[r] = first + r < n ? x[first + r]
                              : grs::pad_key<LOG, R>(r, phases, alternate);
    }
  }
}

// Stores this thread's slots that are keys of out[0, n).
template <int R>
__device__ __forceinline__ void store_slots(uint32_t* __restrict__ out, long long n,
                                            long long first, const uint32_t (&keys)[1 << R]) {
  if (first + (1 << R) <= n && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
    uint4* v = reinterpret_cast<uint4*>(out + first);
#pragma unroll
    for (int q = 0; q < (1 << R) / 4; ++q) {
      v[q] = make_uint4(keys[4 * q], keys[4 * q + 1], keys[4 * q + 2], keys[4 * q + 3]);
    }
  } else {
#pragma unroll
    for (int r = 0; r < (1 << R); ++r) {
      if (first + r < n) out[first + r] = keys[r];
    }
  }
}

// B1.  Block b holds slots [2^14 b, 2^14 (b + 1)) of x[0, n) and sorts each
// run of 2^tile_log of them (the last may be short); with `alternate`, odd
// runs descending.
__global__ void __launch_bounds__(kTileThreads, kTileMinBlocks)
block_sort_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                  long long n, int tile_log, int alternate) {
  extern __shared__ uint4 net_buf[];
  const long long first =
      ((long long)blockIdx.x << kTileLog) + (long long)threadIdx.x * kTileKeys;
  uint32_t keys[kTileKeys];
  load_slots<kTileLog, kTileRegLog>(x, n, first, keys, tile_log, alternate != 0);
  grs::windowed_bitonic_sort<kTileLog, kTileRegLog>(
      keys, reinterpret_cast<uint32_t*>(net_buf), tile_log, alternate != 0);
  store_slots<kTileRegLog>(out, n, first, keys);
}

// Shared memory of the tile pass at runs of 2^tile_log slots: none where
// no phase goes through it.
int block_sort_smem(int tile_log) {
  return tile_log >= kTileSharedPhase ? kTileSmem : 0;
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

// B3's geometry (tools/network_variants.py times other values).
constexpr int kSingleRegLog = 4;  // log2 of the keys a thread holds
constexpr int kSingleKeys = 1 << kSingleRegLog;
constexpr int kSingleMinLog = kSingleRegLog + grs::kLaneLog;  // one warp
constexpr int kSingleMaxLog = 14;
static_assert(1 << kSingleMaxLog == kMaxTile, "one block sorts up to kMaxTile keys");

// B3.  All n <= 2^LOG keys in one block of 2^(LOG-R) threads, slots [n,
// 2^LOG) padded with 0xFFFFFFFF; thread t loads and stores slots
// [2^R t, 2^R (t + 1)).
template <int LOG>
__global__ void __launch_bounds__(1 << (LOG - kSingleRegLog))
single_block_sort_kernel(const uint32_t* __restrict__ x,
                         uint32_t* __restrict__ out, int n) {
  extern __shared__ uint4 net_buf[];
  const int first = threadIdx.x * kSingleKeys;
  uint32_t keys[kSingleKeys];
  load_slots<LOG, kSingleRegLog>(x, n, first, keys, LOG, false);
  grs::register_bitonic_sort<LOG, kSingleRegLog>(keys, net_buf, LOG, false);
  store_slots<kSingleRegLog>(out, n, first, keys);
}

// Two buffers of 2^LOG words for the stages through shared memory (none in
// a one-warp network).
constexpr int single_block_smem(int log) {
  return log > kSingleMinLog ? (2 << log) * (int)sizeof(uint32_t) : 0;
}

// Launches the network of 2^log slots (LOG <= log <= kSingleMaxLog).
template <int LOG>
cudaError_t launch_single_block(const uint32_t* x, uint32_t* out, int n, int log,
                                cudaStream_t stream) {
  if constexpr (LOG < kSingleMaxLog) {
    if (log > LOG) return launch_single_block<LOG + 1>(x, out, n, log, stream);
  }
  single_block_sort_kernel<LOG><<<1, 1 << (LOG - kSingleRegLog),
                                  single_block_smem(LOG), stream>>>(x, out, n);
  return cudaGetLastError();
}

// Raises the dynamic shared-memory limit of the networks of 2^LOG slots
// and up to the size they use.
template <int LOG>
cudaError_t set_single_block_smem() {
  cudaError_t err = cudaFuncSetAttribute(single_block_sort_kernel<LOG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         single_block_smem(LOG));
  if constexpr (LOG < kSingleMaxLog) {
    if (err == cudaSuccess) err = set_single_block_smem<LOG + 1>();
  }
  return err;
}

// Raises the networks' shared-memory limits once per device, B3's and
// B1's (two threads that race only repeat an idempotent call).
cudaError_t network_attributes() {
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (ready[dev]) return cudaSuccess;
  err = set_single_block_smem<kSingleMinLog>();
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(block_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               block_sort_smem(kTileLog));
  }
  ready[dev] = err == cudaSuccess;
  return err;
}

int log2_of(long long pow2) {
  int log = 0;
  while ((1LL << log) < pow2) ++log;
  return log;
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
// written descending.  Launches on `stream`; returns the first CUDA error
// (0 when none).
extern "C" int grs_block_sort_u32(const uint32_t* x, uint32_t* out,
                                  long long n, int tile, int alternate,
                                  cudaStream_t stream) {
  if (n <= 0 || tile <= 0 || tile > kMaxTile || (tile & (tile - 1)) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t err = network_attributes();
  if (err != cudaSuccess) return (int)err;
  const int tile_log = log2_of(tile);
  const long long grid = (n + kMaxTile - 1) / kMaxTile;
  block_sort_kernel<<<(unsigned)grid, kTileThreads, block_sort_smem(tile_log), stream>>>(
      x, out, n, tile_log, alternate);
  return (int)cudaGetLastError();
}

// The dynamic shared memory of block_sort_kernel at `tile` into *smem, and
// the blocks that fit one SM with it
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) into *blocks.
extern "C" int grs_block_sort_blocks_per_sm(int tile, int* blocks, int* smem_bytes) {
  if (tile <= 0 || tile > kMaxTile || (tile & (tile - 1)) != 0 || blocks == nullptr ||
      smem_bytes == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t err = network_attributes();
  if (err != cudaSuccess) return (int)err;
  *smem_bytes = block_sort_smem(log2_of(tile));
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, block_sort_kernel, kTileThreads, *smem_bytes);
}

// B3.  Ascending sort of x[0, n) into out in one block, n <= 2^14; the
// network spans max(2^(R+5), next power of two >= n) slots.  Launches on
// `stream`; returns the first CUDA error (0 when none).
extern "C" int grs_single_block_sort_u32(const uint32_t* x, uint32_t* out,
                                         long long n, cudaStream_t stream) {
  if (n <= 0 || n > kMaxTile) return (int)cudaErrorInvalidValue;
  const cudaError_t err = network_attributes();
  if (err != cudaSuccess) return (int)err;
  const int log = log2_of(n) > kSingleMinLog ? log2_of(n) : kSingleMinLog;
  return (int)launch_single_block<kSingleMinLog>(x, out, (int)n, log, stream);
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
