// One merge level over alternating-direction sorted runs of uint32 keys.
//
// Replaces gpu_radix_sort_tpu/ops/pallas_merge.py:335 `_merge_kernel` (B2)
// together with the XLA split search that fed it (`_merge_splits`, :217).
// The level contract is the JAX one: runs of length L alternate in
// direction (run r ascending iff r is even); pair p merges runs 2p and 2p+1
// into one run of 2L, written ascending iff p is even.  The last run or pair
// may be short (n need not be a multiple of L).  Tie rule: A (the even,
// ascending-stored run) goes first on equal keys.
//
// Bound on this card: each level reads and writes every key once (8 bytes a
// key, 512 MiB a level at 64M keys), so it is bound by HBM bandwidth; what
// keeps a kernel from that bound is latency that no other work covers.
// The design, one CUDA block per output block of kBlockOut keys of a pair:
//   1. Splits.  The block's two merge-path splits (where its first and its
//      last key come from) are found by two warps at once, each probing 32
//      places of device memory a step: ceil(log32(L)) + 1 dependent loads
//      (3 at L = 2^14, 5 at 2^25) where one thread's binary search took
//      log2(L) + 1 (tools/merge_variants.py times that form: PERF.md).
//   2. Loads.  The block's slice of the ascending run, A = x[base + a0,
//      +na), and of the descending run, as stored (B ascending is read from
//      its end), go to shared memory as 16-byte loads, with a head and a
//      tail of <= 3 keys each; each slice is staged at the word offset mod 4
//      it has in device memory, so a vector lands on a 16-byte boundary.
//      A thread issues all its loads before it stores any.
//   3. Merge.  Each thread finds its own split inside the block (merge path
//      on shared memory) and merges kItems keys serially into registers,
//      then writes them back to shared memory with one pad word every 32
//      (no bank conflicts at a stride of kItems words).
//   4. Stores.  The block's output range, ascending or (odd pair) reversed,
//      leaves as 16-byte stores, the head and tail key by key.
//
// TPU workarounds that are not carried over: 8-row DMA windows and headroom
// rows, lane rotations from conditional static rolls, the signed-domain
// min/max, the half-cleaner/fold bitonic merge and the window-containment
// rule L >= b_out + 1024.  Any L >= 1 works here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Geometry (tools/merge_variants.py patches a copy to time others).
constexpr int kThreads = 512;
constexpr int kItems = 16;  // keys a thread merges
constexpr int kBlockOut = kThreads * kItems;
constexpr int kVec = 4;  // keys a load or store of device memory
using Vec = uint4;
// Shared words: the merged keys with a pad word every 32, or the two input
// slices at their word offsets mod 4 (<= 6 words of gaps).
constexpr int kStaged = kBlockOut + kBlockOut / 32 + 8;
constexpr int kVecSlots = (kBlockOut / kVec + kThreads - 1) / kThreads;  // vectors a thread
constexpr int kMaxDevices = 64;
static_assert(kThreads >= 64, "two warps search");

__device__ __forceinline__ Vec pack(const uint32_t* k) {
  return make_uint4(k[0], k[1], k[2], k[3]);
}

// Keys before the first 16-byte boundary of p (p is 4-byte aligned).
__device__ __forceinline__ int head_keys(const uint32_t* p, long long count) {
  const int h = (int)(((uintptr_t)0 - (uintptr_t)p) >> 2 & 3);
  return count < h ? (int)count : h;
}

// Pair p of a level: runs [base, base + la) ascending and [base + la,
// base + la + lb) descending.
struct Pair {
  long long base, la, lb;
  __device__ long long end() const { return base + la + lb; }
};

__device__ __forceinline__ Pair pair_at(long long p, long long n, long long L) {
  const long long base = p * 2 * L;
  return {base, min(L, n - base), max(0LL, min(L, n - base - L))};
}

// The number of A keys among the first `diag` keys of the pair's merge, A
// first on ties: the first i with A(i) > B(diag - 1 - i), where A(i) =
// x[base + i] and B(j) = x[end - 1 - j], so B(diag - 1 - i) = b[i].  Found
// by a whole warp, 32 probes a step, each lane one: the probes that hold
// A(i) <= B(diag - 1 - i) are a prefix of the lanes, and the answer lies
// between the last of them and the next probe.
__device__ long long split_warp(const uint32_t* x, const Pair& q, long long diag) {
  const int lane = threadIdx.x & 31;
  long long lo = max(0LL, diag - q.lb), hi = min(diag, q.la);
  const uint32_t* a = x + q.base;
  const uint32_t* b = x + q.end() - diag;
  while (lo < hi) {
    const long long step = (hi - lo + 31) >> 5;
    const long long i = lo + lane * step;
    const bool below = i < hi && a[i] <= b[i];
    const int c = __popc(__ballot_sync(0xFFFFFFFFu, below));
    if (c == 0) {
      hi = lo;
    } else {
      hi = min(hi, lo + c * step);
      lo += (c - 1) * step + 1;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
merge_level_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                   long long n, long long L, long long blocks_per_pair) {
  extern __shared__ __align__(16) uint32_t s[];
  __shared__ long long split[2];

  const long long p = blockIdx.x / blocks_per_pair;
  const long long k0 = (blockIdx.x % blocks_per_pair) * kBlockOut;
  const Pair q = pair_at(p, n, L);
  const long long len = q.la + q.lb;
  if (k0 >= len) return;  // past the end of a short last pair
  const long long k1 = min(k0 + (long long)kBlockOut, len);

  // 1. The block's splits.
  if (threadIdx.x < 64) {
    const int w = threadIdx.x >> 5;
    const long long a = split_warp(x, q, w ? k1 : k0);
    if ((threadIdx.x & 31) == 0) split[w] = a;
  }
  __syncthreads();
  const long long a0 = split[0];
  const int na = (int)(split[1] - a0);
  const int count = (int)(k1 - k0);
  const int nb = count - na;

  // 2. A's slice and B's slice, as stored, into shared memory at dA, dB.
  const uint32_t* srcA = x + q.base + a0;
  const uint32_t* srcB = x + q.end() - (k0 - a0) - nb;
  const int dA = (int)((uintptr_t)srcA >> 2 & 3);
  const int dB = dA + na + (int)(((uintptr_t)srcB >> 2) - (uintptr_t)(dA + na) & 3);
  const int hA = head_keys(srcA, na), hB = head_keys(srcB, nb);
  const int vA = (na - hA) / kVec, vB = (nb - hB) / kVec;
  {
    Vec y[kVecSlots];
#pragma unroll
    for (int k = 0; k < kVecSlots; ++k) {
      const int v = k * kThreads + threadIdx.x;
      if (v < vA) {
        y[k] = __ldg(reinterpret_cast<const Vec*>(srcA + hA) + v);
      } else if (v < vA + vB) {
        y[k] = __ldg(reinterpret_cast<const Vec*>(srcB + hB) + (v - vA));
      }
    }
#pragma unroll
    for (int k = 0; k < kVecSlots; ++k) {
      const int v = k * kThreads + threadIdx.x;
      if (v < vA) {
        *reinterpret_cast<Vec*>(s + dA + hA + v * kVec) = y[k];
      } else if (v < vA + vB) {
        *reinterpret_cast<Vec*>(s + dB + hB + (v - vA) * kVec) = y[k];
      }
    }
    const int tA = na - hA - vA * kVec, tB = nb - hB - vB * kVec;
    const int e = threadIdx.x;
    if (e < hA) s[dA + e] = srcA[e];
    if (e < tA) s[dA + na - tA + e] = srcA[na - tA + e];
    if (e < hB) s[dB + e] = srcB[e];
    if (e < tB) s[dB + nb - tB + e] = srcB[nb - tB + e];
  }
  __syncthreads();

  // 3. Each thread's split in shared memory, then kItems keys merged:
  // A(i) = s[dA + i], B(j) = s[dB + nb - 1 - j].
  const int diag = min((int)threadIdx.x * kItems, count);
  int lo = max(0, diag - nb), hi = min(diag, na);
  {
    const uint32_t* sa = s + dA;
    const uint32_t* sb = s + dB + nb - diag;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (sa[mid] <= sb[mid]) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
  }
  int ai = lo, bi = diag - lo;
  uint32_t v[kItems];
#pragma unroll
  for (int t = 0; t < kItems; ++t) {
    const bool a_ok = ai < na, b_ok = bi < nb;
    const uint32_t ka = a_ok ? s[dA + ai] : 0u;
    const uint32_t kb = b_ok ? s[dB + nb - 1 - bi] : 0u;
    const bool take_a = a_ok && (!b_ok || ka <= kb);
    v[t] = take_a ? ka : kb;
    ai += take_a;
    bi += !take_a;
  }
  __syncthreads();
#pragma unroll
  for (int t = 0; t < kItems; ++t) {
    const int k = (int)threadIdx.x * kItems + t;
    s[k + (k >> 5)] = v[t];
  }
  __syncthreads();

  // 4. The output range: merged key i at k0 + i of the pair, or at
  // len - 1 - (k0 + i) where the pair is written descending.
  const bool descending = (p & 1) != 0;
  uint32_t* dst = out + (descending ? q.base + len - k1 : q.base + k0);
  auto merged = [&](int j) {
    const int i = descending ? count - 1 - j : j;
    return s[i + (i >> 5)];
  };
  const int h = head_keys(dst, count);
  const int nv = (count - h) / kVec;
  const int tail = count - h - nv * kVec;
#pragma unroll
  for (int k = 0; k < kVecSlots; ++k) {
    const int w = k * kThreads + threadIdx.x;
    if (w < nv) {
      uint32_t keys[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) keys[e] = merged(h + w * kVec + e);
      reinterpret_cast<Vec*>(dst + h)[w] = pack(keys);
    }
  }
  if ((int)threadIdx.x < h) dst[threadIdx.x] = merged(threadIdx.x);
  if ((int)threadIdx.x < tail) {
    dst[count - tail + threadIdx.x] = merged(count - tail + threadIdx.x);
  }
}

constexpr int kSmemBytes = kStaged * (int)sizeof(uint32_t);

// Raises the kernel's dynamic shared-memory limit once per device.
cudaError_t merge_attributes() {
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (ready[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(merge_level_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  ready[dev] = err == cudaSuccess;
  return err;
}

}  // namespace

// Merges the alternating-direction runs of length L in x[0, n) pairwise into
// out (runs of 2L, alternating).  Launches on `stream`; returns the first
// CUDA error (0 when none).  `out` must not alias `x`.
extern "C" int grs_merge_level_u32(const uint32_t* x, uint32_t* out,
                                   long long n, long long L,
                                   cudaStream_t stream) {
  if (n <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  const cudaError_t err = merge_attributes();
  if (err != cudaSuccess) return (int)err;
  const long long pair_len = 2 * L < n ? 2 * L : n;  // the longest pair
  const long long blocks_per_pair = (pair_len + kBlockOut - 1) / kBlockOut;
  const long long pairs = (n + pair_len - 1) / pair_len;
  const long long grid = pairs * blocks_per_pair;
  if (grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
  merge_level_kernel<<<(unsigned)grid, kThreads, kSmemBytes, stream>>>(
      x, out, n, L, blocks_per_pair);
  return (int)cudaGetLastError();
}

// The dynamic shared memory of merge_level_kernel into *smem_bytes, and the
// blocks that fit one SM with it
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) into *blocks.
extern "C" int grs_merge_level_blocks_per_sm(int* blocks, int* smem_bytes) {
  if (blocks == nullptr || smem_bytes == nullptr) return (int)cudaErrorInvalidValue;
  const cudaError_t err = merge_attributes();
  if (err != cudaSuccess) return (int)err;
  *smem_bytes = kSmemBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, merge_level_kernel,
                                                            kThreads, kSmemBytes);
}
