// Stage B of one stable binning pass: every (digit, tile) run of the
// stage-A output goes to its place in the output, in (digit, tile, rank)
// order.
//
// Replaces gpu_radix_sort_tpu/ops/pallas_radix.py:205 `_bin_kernel` (B5).
// The contract is the JAX one.  Stage A has sorted each tile of `tile` keys
// stably by digit; run k = d * n_tiles + t is digit d's segment of tile t,
// which starts at flat position sflat[k] of the stage-A array and goes to
// g_run[k] of the output (g_run is the exclusive scan of the run lengths in
// (digit, tile) order, from the host-side metadata).  So the output is
// stable by digit.
//
// Design: scatter-side, one CUDA block per tile.  The block loads its tile's
// 2^width shifts g_run[k] - sflat[k] into shared memory; each thread then
// takes element p of the tile, recomputes its digit d from `keys`, and
// writes src[p] to out[p + shift[d]].  The destinations of all blocks are
// disjoint, so nothing needs atomics or an order between blocks, and since
// the tile is digit-sorted, neighbouring threads mostly write neighbouring
// addresses.  A payload column runs the same kernel with the stage-A keys
// for the digits and the column as `src`, on the same metadata.
//
// TPU workarounds that are not carried over: the gather-side formulation
// (Mosaic has no scatter), DMA slots and semaphores, conditional lane
// rotations, 8-row chunking, front and back pad rows, and the SMEM caps on
// the metadata.  The caller pads n to whole tiles with 0xFFFFFFFF keys,
// which carry the largest digit of any window and so land at the tail.
//
// Bound on this card: each element is read once and written once (8 bytes
// a key, 2 GiB a pass at 256Mi keys), so a pass is bound by HBM bandwidth;
// the metadata adds 16 bytes a run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxWidth = 8;  // 256 shifts in shared memory

template <bool kMoveKeys>
__global__ void __launch_bounds__(kThreads)
binning_kernel(const uint32_t* __restrict__ keys,
               const uint32_t* __restrict__ src, uint32_t* __restrict__ out,
               long long tile, long long n_tiles, int offset, uint32_t mask,
               const long long* __restrict__ g_run,
               const long long* __restrict__ sflat) {
  __shared__ long long shift[1 << kMaxWidth];
  const long long t = blockIdx.x;
  for (uint32_t d = threadIdx.x; d <= mask; d += kThreads) {
    const long long k = (long long)d * n_tiles + t;
    shift[d] = g_run[k] - sflat[k];
  }
  __syncthreads();

  const long long base = t * tile;
  for (long long i = threadIdx.x; i < tile; i += kThreads) {
    const long long p = base + i;
    const uint32_t key = keys[p];
    const uint32_t d = (key >> offset) & mask;
    out[p + shift[d]] = kMoveKeys ? key : src[p];
  }
}

}  // namespace

// Places the n stage-A elements of `src` (n a multiple of `tile`), whose
// digits are bits [offset, offset + width) of `keys`, into `out` by the run
// metadata g_run (n_tiles * 2^width + 1 entries) and sflat (n_tiles *
// 2^width).  width <= 8.  `src` may be `keys`.  Launches on `stream`;
// returns cudaGetLastError().  `out` must alias neither input.
extern "C" int grs_binning_u32(const uint32_t* keys, const uint32_t* src,
                               uint32_t* out, long long n, long long tile,
                               int offset, int width, const long long* g_run,
                               const long long* sflat, cudaStream_t stream) {
  if (n <= 0 || tile <= 0 || n % tile != 0 || width < 1 ||
      width > kMaxWidth || offset < 0 || offset + width > 32) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n_tiles = n / tile;
  if (n_tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
  const uint32_t mask = (1u << width) - 1u;
  if (src == keys) {
    binning_kernel<true><<<(unsigned)n_tiles, kThreads, 0, stream>>>(
        keys, src, out, tile, n_tiles, offset, mask, g_run, sflat);
  } else {
    binning_kernel<false><<<(unsigned)n_tiles, kThreads, 0, stream>>>(
        keys, src, out, tile, n_tiles, offset, mask, g_run, sflat);
  }
  return (int)cudaGetLastError();
}
