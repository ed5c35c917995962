// One merge level over alternating-direction sorted runs of uint32 keys.
//
// Replaces gpu_radix_sort_tpu/ops/pallas_merge.py:335 `_merge_kernel` (B2)
// together with the XLA split search that fed it (`_merge_splits`, :217).
// The level contract is the JAX one: runs of length L alternate in
// direction (run r ascending iff r is even); pair p merges runs 2p and 2p+1
// into one run of 2L, written ascending iff p is even.  The last run or pair
// may be short (n need not be a multiple of L).
//
// Design: one CUDA block per output block of kBlockOut keys of one pair.
//   1. The block finds its own merge-path splits (two binary searches in
//      device memory, ~2 log2(L) reads) -- no separate split launch.
//   2. It stages its two input slices in shared memory: the ascending run
//      A = x[base, base + la) by plain index, the descending run by reversed
//      index, B(j) = x[base + la + lb - 1 - j], so no pass reverses it.
//   3. Each thread finds its own split inside the block (merge path on
//      shared memory) and merges kItems keys serially.
//   4. The merged keys go back through shared memory and are written with
//      neighbouring threads on neighbouring addresses, at k or reversed
//      (2L - 1 - k) within the pair.
// Tie rule: A (the even, ascending-stored run) goes first on equal keys.
//
// TPU workarounds that are not carried over: 8-row DMA windows and headroom
// rows, lane rotations from conditional static rolls, the signed-domain
// min/max, the half-cleaner/fold bitonic merge and the window-containment
// rule L >= b_out + 1024.  Any L >= 1 works here.
//
// Bound on this card: each level reads and writes every key once (8 bytes a
// key, 512 MiB a level at 64M keys), so the level is bound by HBM bandwidth;
// the split searches are a few reads a block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kBlockOut = kThreads * kItems;  // 4096 keys, 16 KB of shared memory

// The two runs of one pair as seen from device memory.
struct GlobalRuns {
  const uint32_t* x;
  long long base;  // first key of the pair
  long long end;   // one past its last key
  __device__ uint32_t a(long long i) const { return x[base + i]; }
  __device__ uint32_t b(long long j) const { return x[end - 1 - j]; }
};

// The two staged slices in shared memory: A at [0, na), B at [na, na + nb).
struct SharedRuns {
  const uint32_t* s;
  int na;
  __device__ uint32_t a(int i) const { return s[i]; }
  __device__ uint32_t b(int j) const { return s[na + j]; }
};

// Number of A keys among the first `diag` keys of the merge of A (length la)
// and B (length lb), A first on ties.
template <class Runs, class Index>
__device__ Index merge_path(const Runs& r, Index la, Index lb, Index diag) {
  Index lo = diag > lb ? diag - lb : 0;
  Index hi = diag < la ? diag : la;
  while (lo < hi) {
    const Index mid = (lo + hi) >> 1;
    if (r.a(mid) <= r.b(diag - 1 - mid)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
merge_level_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                   long long n, long long L, long long blocks_per_pair) {
  __shared__ uint32_t s[kBlockOut];
  __shared__ long long split[2];

  const long long p = blockIdx.x / blocks_per_pair;
  const long long k0 = (blockIdx.x % blocks_per_pair) * kBlockOut;
  const long long base = p * 2 * L;
  const long long la = min(L, n - base);
  const long long lb = max(0LL, min(L, n - base - L));
  const long long len = la + lb;
  if (k0 >= len) return;  // past the end of a short last pair
  const long long k1 = min(k0 + (long long)kBlockOut, len);

  const GlobalRuns g{x, base, base + len};
  if (threadIdx.x < 2) {
    split[threadIdx.x] = merge_path(g, la, lb, threadIdx.x == 0 ? k0 : k1);
  }
  __syncthreads();
  const long long a0 = split[0];
  const long long b0 = k0 - a0;
  const int na = (int)(split[1] - a0);
  const int count = (int)(k1 - k0);
  const int nb = count - na;

  for (int i = threadIdx.x; i < count; i += kThreads) {
    s[i] = i < na ? g.a(a0 + i) : g.b(b0 + (i - na));
  }
  __syncthreads();

  const SharedRuns r{s, na};
  const int diag = min((int)threadIdx.x * kItems, count);
  int ai = merge_path(r, na, nb, diag);
  int bi = diag - ai;
  uint32_t v[kItems];
#pragma unroll
  for (int t = 0; t < kItems; ++t) {
    const uint32_t ka = ai < na ? r.a(ai) : 0xFFFFFFFFu;
    const uint32_t kb = bi < nb ? r.b(bi) : 0xFFFFFFFFu;
    const bool take_a = ai < na && (bi >= nb || ka <= kb);
    v[t] = take_a ? ka : kb;
    ai += take_a;
    bi += !take_a;
  }
  __syncthreads();
#pragma unroll
  for (int t = 0; t < kItems; ++t) {
    const int k = (int)threadIdx.x * kItems + t;
    if (k < count) s[k] = v[t];
  }
  __syncthreads();

  const bool descending = (p & 1) != 0;
  for (int i = threadIdx.x; i < count; i += kThreads) {
    const long long k = k0 + i;
    out[descending ? base + len - 1 - k : base + k] = s[i];
  }
}

}  // namespace

// Merges the alternating-direction runs of length L in x[0, n) pairwise into
// out (runs of 2L, alternating).  Launches on `stream`; returns
// cudaGetLastError().  `out` must not alias `x`.
extern "C" int grs_merge_level_u32(const uint32_t* x, uint32_t* out,
                                   long long n, long long L,
                                   cudaStream_t stream) {
  if (n <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  const long long two_l = 2 * L;
  const long long blocks_per_pair = (two_l + kBlockOut - 1) / kBlockOut;
  const long long pairs = (n + two_l - 1) / two_l;
  const long long grid = pairs * blocks_per_pair;
  if (grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
  merge_level_kernel<<<(unsigned)grid, kThreads, 0, stream>>>(
      x, out, n, L, blocks_per_pair);
  return (int)cudaGetLastError();
}
