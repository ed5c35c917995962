// Ascending sort of uint32 keys by four stable 8-bit LSD passes, onesweep
// style (Adinets & Merrill, "Onesweep: A Faster Least Significant Digit
// Radix Sort for GPUs", 2022; the look-back is Merrill & Garland's
// single-pass scan).
//
// Replaces no TPU kernel.  The JAX package's sort_full is a tile sort and
// merge levels (pallas_merge.py), a shape the TPU forced: Mosaic has no
// scatter inside a kernel and its grid runs in order on one core.  Hopper
// has both scatter and many SMs, so above a measured size
// (ops/radix_sort.py, ONESWEEP_MIN_N) the port sorts by digits instead:
// the tile pass and its 14 merge levels read and write every key 15 times
// at 256Mi keys (~30 GiB), these five launches 4.5 times (~9 GiB).
//
//   1. onesweep_histogram_kernel reads the keys once (16-byte loads) and
//      counts all four digits in shared memory, then in the scratch with
//      one atomic a bin a block; the last block to finish turns the four
//      histograms into exclusive scans: the first output slot of each
//      digit of each pass.
//   2. onesweep_pass_kernel, once a digit (bits 0-7, 8-15, 16-23, 24-31),
//      in -> A -> B -> A -> B; the input is never written.  A block takes
//      the next tile of kTile keys from the pass's atomic counter (so every
//      tile it waits for is held by a block already running), loads it
//      warp-striped (warp w holds keys [w*32K, (w+1)*32K), key k of lane l
//      at w*32K + k*32 + l: each load a coalesced 128 bytes) and keeps the
//      keys in registers.  Then:
//        * count: one shared atomic a key on its (digit, warp) counter;
//        * publish: the tile's 256 digit counts as AGGREGATE words of the
//          look-back state (tile 0 publishes PREFIX);
//        * scan: the exclusive scan of the (digit, warp) counters,
//          digit-major, gives each warp's first local slot of each digit;
//        * look-back (warps 0-7, while warps 8-15 place): thread d walks
//          back over the tiles before its own, adding AGGREGATE counts
//          until it meets a PREFIX, publishes its own PREFIX, and turns the
//          result into shift[d], the output index less the local slot of
//          digit d's keys;
//        * place: key by key in input order, the lanes of a warp with the
//          same digit (a shared mask a digit, set by atomic OR) take slots
//          from the warp's counter, which the lowest of them advances: the
//          tile, stably sorted by digit, in shared memory;
//        * store: thread i takes slot i and writes it to shift[d] + i, so
//          each digit's run leaves as consecutive stores.
//
// Look-back state: one 32-bit word a (tile, digit), 2 status bits and the
// count mod 2^30; the last tile has none (nobody looks back at it).  The
// status codes rotate from pass to pass instead of the words being cleared:
// after a pass every word holds that pass's PREFIX code, which the next
// pass reads as "not ready" (codes 0/2, 2/3, 3/0, 0/2 for not ready/PREFIX;
// AGGREGATE is 1).  A count mod 2^30 fixes the exact count E of digit d
// before the tile, as E lies in an interval narrower than 2^30 for
// n <= 2^31: at least c - l - (keys after the tile) and at most the keys
// before it, c the digit's count over all keys and l the tile's.
//
// Scratch (uint32 words, zeroed by the wrapper): kHeader words of
// histograms, tile counters and the histogram's block count, then the state
// for tiles - 1 tiles.  kTile = 512 * 33 = 16896 keeps it under 16 MiB at
// 2^28 keys (15887 tiles of 1 KiB).
//
// Bound on this card: the histogram reads every key once and each pass
// reads and writes it once: 36 bytes a key, 9 GiB at 2^28 keys, 2.9 ms at
// 3.35 TB/s; a pass alone 0.641 ms.  What keeps a pass from it is the
// rank's shared-memory work and instructions, a few shared accesses a key
// (the alternatives tried and their times: PERF.md), which two blocks an SM
// overlap with each other's loads, look-back and stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBits = 8;
constexpr int kBins = 1 << kBits;
constexpr int kPasses = 32 / kBits;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kKeys = 33;  // keys a thread
constexpr int kTile = kThreads * kKeys;
constexpr int kRow = kWarps + 1;  // counter words of a digit, padded
constexpr long long kMaxN = 1LL << 31;

// Scratch layout (words).
constexpr int kStarts = 0;                        // kPasses x kBins
constexpr int kTileCounter = kPasses * kBins;     // one a pass
constexpr int kHistDone = kTileCounter + kPasses;
constexpr int kHeader = 1056;  // the state starts 128-byte aligned
static_assert(kHistDone < kHeader, "header");

constexpr uint32_t kValueMask = (1u << 30) - 1u;
constexpr uint32_t kAggregate = 1u << 30;
// Status codes (top two bits) of PREFIX in pass p, and of "not ready".
__host__ __device__ constexpr uint32_t prefix_code(int pass) {
  return (uint32_t)((0x032u >> (4 * (pass % 3))) & 3u) << 30;  // 2, 3, 0, 2
}
__host__ __device__ constexpr uint32_t wait_code(int pass) {
  return pass == 0 ? 0u : prefix_code(pass - 1);
}
static_assert(prefix_code(0) == 2u << 30 && prefix_code(1) == 3u << 30 &&
              prefix_code(2) == 0u && prefix_code(3) == 2u << 30, "codes");

// Shared memory of a pass block (words): slots, counters, peer masks, warp
// sums, local starts, shifts.
constexpr int kSmemWords = kTile + kBins * kRow + kWarps * kBins + kWarps + 2 * kBins;
constexpr int kSmemBytes = kSmemWords * (int)sizeof(uint32_t);

constexpr int kHistThreads = 512;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t load_relaxed(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(uint32_t* p, uint32_t v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" :: "l"(p), "r"(v) : "memory");
}

__global__ void __launch_bounds__(kHistThreads)
onesweep_histogram_kernel(const uint32_t* __restrict__ x, long long n,
                          uint32_t* __restrict__ scratch) {
  __shared__ uint32_t h[kPasses * kBins];
  __shared__ bool last;
  for (int i = threadIdx.x; i < kPasses * kBins; i += kHistThreads) h[i] = 0;
  __syncthreads();
  auto add = [&](uint32_t key) {
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      atomicAdd(&h[p * kBins + ((key >> (p * kBits)) & (kBins - 1))], 1u);
    }
  };
  // a head of <= 3 keys before the first 16-byte boundary, vectors, a tail
  const long long head = min(n, (long long)(((uintptr_t)0 - (uintptr_t)x) >> 2 & 3));
  const long long nvec = (n - head) / 4;
  const long long tail = n - head - nvec * 4;
  if (blockIdx.x == 0 && threadIdx.x < head) add(x[threadIdx.x]);
  if (blockIdx.x == 0 && threadIdx.x < tail) add(x[head + nvec * 4 + threadIdx.x]);
  const uint4* v = reinterpret_cast<const uint4*>(x + head);
  for (long long i = (long long)blockIdx.x * kHistThreads + threadIdx.x; i < nvec;
       i += (long long)gridDim.x * kHistThreads) {
    const uint4 q = __ldcs(v + i);
    add(q.x);
    add(q.y);
    add(q.z);
    add(q.w);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kPasses * kBins; i += kHistThreads) {
    if (h[i]) atomicAdd(&scratch[kStarts + i], h[i]);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&scratch[kHistDone], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  // The last block: each of four warps turns one pass's counts into their
  // exclusive scan, eight bins a lane.
  __threadfence();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp >= kPasses) return;
  uint32_t* row = scratch + kStarts + warp * kBins + lane * 8;
  uint32_t c[8], total = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    c[i] = load_relaxed(row + i);
    total += c[i];
  }
  uint32_t incl = total;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t up = __shfl_up_sync(0xFFFFFFFFu, incl, d);
    if (lane >= d) incl += up;
  }
  uint32_t run = incl - total;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    row[i] = run;
    run += c[i];
  }
}

// A tile's keys, warp-striped: key k of this lane at first + 32 k of the
// tile.  kFull: every key of the tile is there and none is checked, so the
// place runs no divergent branch between its warp-synchronous steps; the
// last, partial tile checks each key against m.
template <bool kFull>
__device__ __forceinline__ void load_keys(uint32_t (&keys)[kKeys], const uint32_t* in,
                                          int first, int m) {
#pragma unroll
  for (int k = 0; k < kKeys; ++k) {
    const int i = first + k * 32;
    keys[k] = kFull || i < m ? __ldcs(in + i) : 0u;
  }
}

// One shared atomic a key on its (digit, warp) counter.
template <bool kFull>
__device__ __forceinline__ void count_keys(const uint32_t (&keys)[kKeys], int first, int m,
                                           int bit0, uint32_t* cnt, int warp) {
#pragma unroll
  for (int k = 0; k < kKeys; ++k) {
    if (kFull || first + k * 32 < m) {
      atomicAdd(&cnt[((keys[k] >> bit0) & (kBins - 1)) * kRow + warp], 1u);
    }
  }
}

// Key by key in input order, each key to its slot.  The lanes of the warp
// with the key's digit (its peers) set their bits in the warp's mask of that
// digit (one shared atomic OR a key, as CUB's WARP_MATCH_ATOMIC_OR; 8 warp
// ballots cost a third more a pass, PERF.md); each reads the mask and the
// (digit, warp) counter; the lowest peer advances the counter by their
// number and clears the mask; a key's slot is the counter plus its peers in
// lower lanes.
template <bool kFull>
__device__ __forceinline__ void place_keys(const uint32_t (&keys)[kKeys], int first, int m,
                                           int bit0, uint32_t* cnt, uint32_t* masks,
                                           uint32_t* slots, int lane, int warp) {
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < kKeys; ++k) {
    const bool valid = kFull || first + k * 32 < m;
    const uint32_t d = (keys[k] >> bit0) & (kBins - 1);
    uint32_t* mask = masks + warp * kBins + d;
    if (valid) atomicOr(mask, 1u << lane);
    __syncwarp();
    const unsigned peers = valid ? *mask : 0u;
    uint32_t* c = &cnt[d * kRow + warp];
    const uint32_t b = *c;
    __syncwarp();  // every peer has read the mask and the counter
    const unsigned ahead = peers & below;
    if (valid && ahead == 0) {
      *c = b + __popc(peers);
      *mask = 0;
    }
    if (valid) slots[b + __popc(ahead)] = keys[k];
    __syncwarp();  // this key's counter and mask before the next key's
  }
}

// One block a tile, the tiles taken in order from the pass's counter.
__global__ void __launch_bounds__(kThreads, 2)
onesweep_pass_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                     long long n, int pass, uint32_t* __restrict__ scratch) {
  extern __shared__ uint32_t smem[];
  uint32_t* slots = smem;                      // kTile
  uint32_t* cnt = slots + kTile;               // (digit, warp) at d * kRow + w
  uint32_t* masks = cnt + kBins * kRow;        // (warp, digit) at w * kBins + d
  uint32_t* sums = masks + kWarps * kBins;     // kWarps
  uint32_t* local_start = sums + kWarps;       // kBins
  uint32_t* shift = local_start + kBins;       // kBins
  __shared__ int tile_s;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bit0 = pass * kBits;
  const int tiles = (int)((n + kTile - 1) / kTile);  // < 2^17 for n <= 2^31

  if (threadIdx.x == 0) tile_s = (int)atomicAdd(scratch + kTileCounter + pass, 1u);
  for (int i = threadIdx.x; i < kBins * kRow + kWarps * kBins; i += kThreads) cnt[i] = 0;
  __syncthreads();
  const int t = tile_s;
  const long long base = (long long)t * kTile;
  const int m = (int)min((long long)kTile, n - base);
  const bool full = m == kTile;
  const int first = warp * 32 * kKeys + lane;

  // Load, warp-striped, and count.
  uint32_t keys[kKeys];
  if (full) {
    load_keys<true>(keys, in + base, first, m);
    count_keys<true>(keys, first, m, bit0, cnt, warp);
  } else {
    load_keys<false>(keys, in + base, first, m);
    count_keys<false>(keys, first, m, bit0, cnt, warp);
  }
  __syncthreads();

  // Publish the tile's digit counts.
  uint32_t* state = scratch + kHeader;
  const uint32_t prefix = prefix_code(pass);
  uint32_t total = 0;
  if (threadIdx.x < kBins) {
    const int d = threadIdx.x;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += cnt[d * kRow + w];
    if (t + 1 < tiles) store_relaxed(&state[t * kBins + d], (t == 0 ? prefix : kAggregate) | total);
  }

  // Exclusive scan of the (digit, warp) counters, digit-major: thread j
  // holds entries 8j .. 8j + 7, digit j / 2, warps 8 (j % 2) .. + 7.
  {
    constexpr int kPer = kBins * kWarps / kThreads;
    static_assert(kPer * kThreads == kBins * kWarps && kWarps % kPer == 0, "scan");
    const int d = threadIdx.x / (kWarps / kPer);
    const int w0 = threadIdx.x % (kWarps / kPer) * kPer;
    uint32_t* row = cnt + d * kRow + w0;
    uint32_t c[kPer], sum = 0;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      c[i] = row[i];
      sum += c[i];
    }
    uint32_t incl = sum;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const uint32_t up = __shfl_up_sync(0xFFFFFFFFu, incl, s);
      if (lane >= s) incl += up;
    }
    if (lane == 31) sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const uint32_t mine = lane < kWarps ? sums[lane] : 0u;
      uint32_t x = mine;
#pragma unroll
      for (int s = 1; s < 32; s <<= 1) {
        const uint32_t up = __shfl_up_sync(0xFFFFFFFFu, x, s);
        if (lane >= s) x += up;
      }
      if (lane < kWarps) sums[lane] = x - mine;
    }
    __syncthreads();
    uint32_t run = sums[warp] + incl - sum;
    if (w0 == 0) local_start[d] = run;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      row[i] = run;
      run += c[i];
    }
    __syncthreads();
  }

  // Look-back: the count of digit d in the tiles before this one.  Warps
  // 0-7 do it; the others go on to place their keys (a warp's place only
  // touches its own counters and masks, and local_start is read-only
  // here).
  if (threadIdx.x < kBins) {
    const int d = threadIdx.x;
    const uint32_t waiting = wait_code(pass);
    uint32_t excl = 0;  // mod 2^30
    if (t > 0) {
      for (const uint32_t* p = state + (t - 1) * kBins + d;; p -= kBins) {
        uint32_t w;
        do {
          w = load_relaxed(p);
        } while ((w & ~kValueMask) == waiting);
        excl += w & kValueMask;
        if ((w & ~kValueMask) == prefix) break;
      }
      excl &= kValueMask;
      if (t + 1 < tiles) {
        store_relaxed(&state[t * kBins + d], prefix | ((excl + total) & kValueMask));
      }
    }
    const uint32_t* starts = scratch + kStarts + pass * kBins;
    const uint32_t start = starts[d];
    const long long c = (d + 1 < kBins ? (long long)starts[d + 1] : n) - start;
    const long long lo = max(0LL, c - (long long)total - (n - base - m));
    const long long e = lo + (((long long)excl - lo) & (long long)kValueMask);
    shift[d] = (uint32_t)(start + e - local_start[d]);
  }

  // Place: key by key in input order into the tile's sorted slots.
  if (full) {
    place_keys<true>(keys, first, m, bit0, cnt, masks, slots, lane, warp);
  } else {
    place_keys<false>(keys, first, m, bit0, cnt, masks, slots, lane, warp);
  }
  __syncthreads();

  // Store: slot i to shift[digit] + i, consecutive threads on consecutive
  // slots, so a digit's run leaves as consecutive stores.
#pragma unroll
  for (int k = 0; k < kKeys; ++k) {
    const int i = k * kThreads + threadIdx.x;
    if (full || i < m) {
      const uint32_t key = slots[i];
      out[(uint32_t)(shift[(key >> bit0) & (kBins - 1)] + (uint32_t)i)] = key;
    }
  }
}

// Raises the pass kernel's dynamic shared-memory limit once per device,
// and gives the device's SMs.
cudaError_t onesweep_attributes(int* sms) {
  static bool ready[kMaxDevices] = {};
  static int sm_count[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(onesweep_pass_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sm_count[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  if (sms != nullptr) *sms = sm_count[dev];
  return cudaSuccess;
}

// Words of scratch a sort of n keys needs: the header and the look-back
// state of every tile but the last.
long long scratch_words_for(long long n) {
  const long long tiles = (n + kTile - 1) / kTile;
  return kHeader + (tiles > 1 ? (tiles - 1) * kBins : 0);
}

}  // namespace

// Sorts x[0, n) ascending into out, through tmp (both n keys; neither may
// alias x or the other), with `scratch`: scratch_words zeroed words, at
// least kHeader + (tiles - 1) * 256 (ops/onesweep.py, scratch_words).  x is
// not written.  Launches the histogram and four passes on `stream`; returns
// the first CUDA error (0 when none).
extern "C" int grs_onesweep_sort_u32(const uint32_t* x, uint32_t* tmp, uint32_t* out,
                                     long long n, uint32_t* scratch,
                                     long long scratch_words, cudaStream_t stream) {
  if (n <= 0 || n > kMaxN || scratch_words < scratch_words_for(n)) {
    return (int)cudaErrorInvalidValue;
  }
  int sms = 0;
  cudaError_t err = onesweep_attributes(&sms);
  if (err != cudaSuccess) return (int)err;
  const long long vecs = (n + 3) / 4;
  const long long hist_blocks =
      min((vecs + kHistThreads - 1) / kHistThreads, 4LL * (sms > 0 ? sms : 1));
  onesweep_histogram_kernel<<<(unsigned)hist_blocks, kHistThreads, 0, stream>>>(
      x, n, scratch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (n + kTile - 1) / kTile;
  const uint32_t* src = x;
  for (int p = 0; p < kPasses; ++p) {
    uint32_t* dst = p % 2 == 0 ? tmp : out;
    onesweep_pass_kernel<<<(unsigned)tiles, kThreads, kSmemBytes, stream>>>(
        src, dst, n, p, scratch);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    src = dst;
  }
  return (int)cudaSuccess;
}

// The pass kernel's keys a tile into *tile and the scratch header's words
// into *header, for the wrapper to check its own geometry against.
extern "C" int grs_onesweep_geometry(int* tile, int* header) {
  if (tile == nullptr || header == nullptr) return (int)cudaErrorInvalidValue;
  *tile = kTile;
  *header = kHeader;
  return (int)cudaSuccess;
}

// The dynamic shared memory of onesweep_pass_kernel into *smem_bytes, and
// the blocks that fit one SM with it into *blocks.
extern "C" int grs_onesweep_blocks_per_sm(int* blocks, int* smem_bytes) {
  if (blocks == nullptr || smem_bytes == nullptr) return (int)cudaErrorInvalidValue;
  const cudaError_t err = onesweep_attributes(nullptr);
  if (err != cudaSuccess) return (int)err;
  *smem_bytes = kSmemBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, onesweep_pass_kernel,
                                                            kThreads, kSmemBytes);
}
