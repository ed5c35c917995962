// The two exchange kernels of the mesh LSD sort: each sender writes its keys
// straight into the receivers' buffers, at offsets derived from the gathered
// digit counts.
//
// Replaces two Pallas kernels of the JAX package:
//   * gpu_radix_sort_tpu/parallel/rdma_exchange.py:60 `_xchg_kernel` (B6):
//     the ragged all-to-all of a digit-sorted shard, here
//     `segment_copy_kernel`.  The TPU kernel issued remote DMAs of 16-row
//     chunks from 128-lane rows and waited on semaphores; its receive
//     buffers carried per-chunk slack that a validity mask hid.  Here a
//     segment is (src_start, count, dst_rank, dst_start) to the element, so
//     the receive buffer holds exactly its n_local keys.  The entry barrier
//     and the drains become stream order (parallel/rdma_exchange.py).
//   * gpu_radix_sort_tpu/parallel/rdma_overlap.py:116 `_xchg_overlap_kernel`
//     (B7): for each group of `tile` keys, a stable digit sort and that
//     group's sends.  Here `group_sort_send_kernel`, one block per group:
//     the counting sort of block_rank.cuh ranks the keys by their digit
//     (width <= 8, one pass) and scatters them into shared memory, then the
//     block stores each destination's slice of its sorted tile straight from
//     shared memory into that receiver's buffer.  No staging: the card
//     overlaps the stores of early blocks with the sorting of later ones.
//     With `stage` set the kernel only sorts, into stage (the serial A/B
//     mode; B6 then sends).
//
// The receivers' base addresses travel by value in the kernel's parameters
// (RankTable, kMaxRanks pointers): building a device table from the host
// would put a synchronising copy on the stream in every round.  A receiver
// on another card is written through peer access
// (grs_enable_peer_access); on one card all buffers are local.  A receiver
// of another process (a process-group mesh) is its buffer mapped into this
// process through CUDA IPC (grs_ipc_*, at the end of this file).
//
// Bounds on this card.  segment_copy reads and writes each key once, 8 bytes
// a key: bound by device-memory bandwidth, so its design is about bytes in
// flight and 16-byte accesses.  Each block takes kCopyChunk keys of the
// source, finds the segments that meet them once (two binary searches by
// two threads), then walks those segments: for each it resolves the
// receiver's address once and stores its part as 16-byte vectors aligned on
// the receiver, between a scalar head and tail of at most 3 keys.  A thread
// loads kCopyUnroll aligned 16-byte vectors of the source before it stores
// them; where the receiver's alignment lags the source's, a vector is put
// together from two aligned loads (the second is the next thread's first,
// from L1).  Staging the chunk in shared memory first (cp.async, one or two
// buffers) measured slower: tools/copy_variants.py and PERF.md.
// group_sort_send reads each key once into registers and stores it once
// from shared memory, 8 bytes a key of device memory, with two ballot
// passes, a scan and three barriers in between (block_rank.cuh); its shared
// memory (~97 KB at 2^14 keys and 8 bits, plus 16 bytes a receiver for the
// schedule) lets two blocks share an SM, so one block's loads and stores
// overlap the other's ranking.  The destinations of all stores are disjoint
// (the counts-derived layout), so there are no atomics in device memory.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "block_rank.cuh"

namespace {

constexpr int kThreads = grs::kRankThreads;
constexpr int kMaxTile = 1 << 14;  // keys a block ranks (16 a thread)
constexpr int kMaxRanks = 256;     // receivers a launch addresses (2 KB of parameters)
// segment_copy's geometry (tools/copy_variants.py times other values).
constexpr int kCopyThreads = 512;
constexpr int kCopyChunk = 1 << 14;  // source keys a block sends
constexpr int kCopyUnroll = 4;       // vectors a thread loads before it stores them
constexpr int kCopyStripes = 16;     // interleaved stripes of chunks, for several receivers

struct RankTable {
  uint32_t* base[kMaxRanks];
};

// The last s in [lo, hi] with starts[s] <= i; lo when there is none.
__device__ __forceinline__ int last_at_or_below(const long long* starts, int lo,
                                                int hi, long long i) {
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (starts[mid] <= i) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

// Words lag..lag+3 of the two consecutive vectors a, b (lag 1 to 3).
__device__ __forceinline__ uint4 lagged(uint4 a, uint4 b, int lag) {
  switch (lag) {
    case 1: return make_uint4(a.y, a.z, a.w, b.x);
    case 2: return make_uint4(a.z, a.w, b.x, b.y);
    default: return make_uint4(a.w, b.x, b.y, b.z);
  }
}

// segs is (4, n_seg) int64: src_start, count, dst_rank, dst_start.  Segments
// are in source order and disjoint (src_start[s] + count[s] <=
// src_start[s + 1]); keys in no segment are not sent.  `shift` is src's word
// offset past a 16-byte boundary: key i is word i + shift of the aligned
// source.  The grid is `stripes` x rows blocks; block b sends chunk
// c = (b mod stripes) rows + b / stripes, the keys [c kCopyChunk,
// (c + 1) kCopyChunk), if there are such keys.  Blocks run in about the
// order of b, so with several stripes the blocks in flight spread over the
// whole source: a sender stores to every receiver at once, not to one
// after the other (a card's NVLink bandwidth is split among its peers).
// The loads read whole aligned vectors, so they may touch up to 3 words
// before a part's first key or past its last, never outside those keys'
// vectors.
__global__ void __launch_bounds__(kCopyThreads)
segment_copy_kernel(const uint32_t* __restrict__ src, long long n_src, int shift,
                    const long long* __restrict__ segs, int n_seg, int stripes,
                    const __grid_constant__ RankTable dst) {
  __shared__ int range[2];
  const long long rows = gridDim.x / stripes;
  const long long first = ((blockIdx.x % stripes) * rows + blockIdx.x / stripes) * kCopyChunk;
  if (first >= n_src) return;
  const long long last = min(first + kCopyChunk, n_src) - 1;
  if (threadIdx.x == 0) {
    range[0] = last_at_or_below(segs, 0, n_seg - 1, first);
  } else if (threadIdx.x == 32) {
    range[1] = last_at_or_below(segs, 0, n_seg - 1, last);
  }
  __syncthreads();
  const uint4* aligned = reinterpret_cast<const uint4*>(src - shift);
  for (int s = range[0]; s <= range[1]; ++s) {
    const long long s0 = segs[s];
    const long long a = max(s0, first);
    const long long b = min(s0 + segs[n_seg + s], last + 1);
    if (a >= b) continue;
    uint32_t* d = dst.base[segs[2LL * n_seg + s]] + segs[3LL * n_seg + s] + (a - s0);
    const int len = (int)(b - a);
    const int head = min(len, (int)((4 - (reinterpret_cast<uintptr_t>(d) >> 2)) & 3));
    const int nvec = (len - head) >> 2;
    const int tail = (len - head) & 3;
    if ((int)threadIdx.x < head) d[threadIdx.x] = src[a + threadIdx.x];
    const long long w = a + head + shift;  // aligned source word of the first vector's key
    const uint4* sv = aligned + (w >> 2);
    const int lag = (int)(w & 3);
    uint4* dv = reinterpret_cast<uint4*>(d + head);
    for (int v0 = threadIdx.x; v0 < nvec; v0 += kCopyThreads * kCopyUnroll) {
      uint4 x[kCopyUnroll], y[kCopyUnroll];
#pragma unroll
      for (int u = 0; u < kCopyUnroll; ++u) {
        const int v = v0 + u * kCopyThreads;
        if (v < nvec) {
          x[u] = __ldg(sv + v);
          if (lag) y[u] = __ldg(sv + v + 1);
        }
      }
#pragma unroll
      for (int u = 0; u < kCopyUnroll; ++u) {
        const int v = v0 + u * kCopyThreads;
        if (v < nvec) dv[v] = lag ? lagged(x[u], y[u], lag) : x[u];
      }
    }
    if ((int)threadIdx.x < tail) {
      d[head + 4 * nvec + threadIdx.x] = src[a + head + 4LL * nvec + threadIdx.x];
    }
  }
}

// sched is (2, n_groups, nranks) int64: start[g, c], the first position of
// destination c's slice in group g's sorted tile (start[g, 0] = 0, ascending
// in c, the slices tile the group), and dst_start[g, c], where that slice
// lands in receiver c's buffer.  With stage set, sched and dst are unused.
// A tile below 1024 keys fills the block's slots with 0xFFFFFFFF pads, which
// sort last and are never stored.
__global__ void __launch_bounds__(kThreads, 2)
group_sort_send_kernel(const uint32_t* __restrict__ x, int tile, int offset,
                       int width, const long long* __restrict__ sched,
                       long long n_groups, int nranks, const RankTable dst,
                       uint32_t* __restrict__ stage) {
  extern __shared__ __align__(16) uint32_t s[];
  const int K = grs::rank_keys_per_thread(tile);
  uint32_t* scratch = s + K * kThreads;
  long long* row_start =
      reinterpret_cast<long long*>(scratch + grs::rank_scratch_words(width));
  long long* row_dst = row_start + nranks;
  const long long g = blockIdx.x;
  const long long base = g * tile;

  uint32_t keys[grs::kMaxKeysPerThread];
#pragma unroll
  for (int k = 0; k < grs::kMaxKeysPerThread; ++k) {
    if (k < K) {
      const int i = grs::rank_slot(k, K);
      keys[k] = i < tile ? x[base + i] : 0xFFFFFFFFu;
    }
  }
  if (stage == nullptr) {
    for (int c = threadIdx.x; c < nranks; c += kThreads) {
      row_start[c] = sched[g * nranks + c];
      row_dst[c] = sched[(n_groups + g) * nranks + c];
    }
  }
  // Its first barrier also publishes the schedule rows.
  grs::rank_scatter(keys, K, offset, width, s, scratch);

  if (stage != nullptr) {
    for (int i = threadIdx.x; i < tile; i += kThreads) stage[base + i] = s[i];
    return;
  }
  for (int i = threadIdx.x; i < tile; i += kThreads) {
    const int c = last_at_or_below(row_start, 0, nranks - 1, i);
    dst.base[c][row_dst[c] + (i - row_start[c])] = s[i];
  }
}

int group_sort_send_smem(int tile, int width, int nranks, bool send) {
  return (grs::rank_keys_per_thread(tile) * kThreads +
          grs::rank_scratch_words(width)) * (int)sizeof(uint32_t) +
         (send ? 2 * nranks * (int)sizeof(long long) : 0);
}

int fill_table(RankTable* table, const long long* dst_ptrs, int nranks) {
  if (dst_ptrs == nullptr || nranks < 1 || nranks > kMaxRanks) {
    return (int)cudaErrorInvalidValue;
  }
  for (int c = 0; c < kMaxRanks; ++c) {
    table->base[c] = c < nranks
        ? reinterpret_cast<uint32_t*>(static_cast<uintptr_t>(dst_ptrs[c]))
        : nullptr;
  }
  return 0;
}

}  // namespace

// B6.  Copies each segment of src[0, n_src) into its receiver's buffer:
// src[src_start + k] -> dst_ptrs[dst_rank][dst_start + k] for k < count.
// segs is a device array (4, n_seg) int64 (see the kernel); dst_ptrs is a
// HOST array of nranks device addresses (uint32_t*), nranks <= 256.  Any
// 4-byte alignment of src and of the receivers works.  Launches on `stream`;
// returns the first CUDA error (0 when none).
extern "C" int grs_segment_copy_u32(const uint32_t* src, long long n_src,
                                    const long long* segs, int n_seg,
                                    const long long* dst_ptrs, int nranks,
                                    cudaStream_t stream) {
  if (n_src < 0 || n_seg < 1 || segs == nullptr) return (int)cudaErrorInvalidValue;
  RankTable table;
  const int bad = fill_table(&table, dst_ptrs, nranks);
  if (bad) return bad;
  if (n_src == 0) return 0;
  const int shift = (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  // one receiver: chunks in order (striping costs a lagged copy a few %)
  const int stripes = nranks > 1 ? kCopyStripes : 1;
  const long long rows = (n_src + (long long)kCopyChunk * stripes - 1) /
                         ((long long)kCopyChunk * stripes);
  segment_copy_kernel<<<(unsigned)(rows * stripes), kCopyThreads, 0, stream>>>(
      src, n_src, shift, segs, n_seg, stripes, table);
  return (int)cudaGetLastError();
}

// B7.  For each group g of `tile` keys of x[0, n) (tile a power of two
// <= 2^14 dividing n), a stable sort by bits [offset, offset + width),
// width <= 8, then its slices sent as `sched` says (see the kernel) to the
// receivers at the HOST array dst_ptrs[nranks].  With `stage` non-null the
// sorted groups go to stage[0, n) instead and nothing is sent.  Launches on
// `stream`; returns cudaGetLastError().
extern "C" int grs_group_sort_send_u32(const uint32_t* x, long long n, int tile,
                                       int offset, int width,
                                       const long long* sched, int nranks,
                                       const long long* dst_ptrs,
                                       uint32_t* stage, cudaStream_t stream) {
  if (n <= 0 || tile < 2 || tile > kMaxTile || (tile & (tile - 1)) != 0 ||
      n % tile != 0 || width < 1 || width > 8 || offset < 0 ||
      offset + width > 32) {
    return (int)cudaErrorInvalidValue;
  }
  RankTable table = {};
  if (stage == nullptr) {
    if (sched == nullptr) return (int)cudaErrorInvalidValue;
    const int bad = fill_table(&table, dst_ptrs, nranks);
    if (bad) return bad;
  }
  const long long n_groups = n / tile;
  const int smem = group_sort_send_smem(tile, width, nranks, stage == nullptr);
  cudaError_t err = cudaFuncSetAttribute(
      group_sort_send_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  group_sort_send_kernel<<<(unsigned)n_groups, kThreads, smem, stream>>>(
      x, tile, offset, width, sched, n_groups, nranks, table, stage);
  return (int)cudaGetLastError();
}

// The dynamic shared memory of group_sort_send_kernel at this tile, width
// and number of receivers (0: the sort-only mode) into *smem, and the blocks
// that fit one SM with it (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
// into *blocks.
extern "C" int grs_group_sort_send_blocks_per_sm(int tile, int width, int nranks,
                                                 int* blocks, int* smem_bytes) {
  if (tile < 2 || tile > kMaxTile || width < 1 || width > 8 || nranks < 0 ||
      nranks > kMaxRanks || blocks == nullptr || smem_bytes == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = group_sort_send_smem(tile, width, nranks, nranks > 0);
  *smem_bytes = smem;
  cudaError_t err = cudaFuncSetAttribute(
      group_sort_send_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, group_sort_send_kernel, kThreads, smem);
}

// Lets `device` write into `peer`'s memory (once for each ordered pair; a
// second call is a no-op).  Returns cudaErrorPeerAccessUnsupported where the
// two cards cannot reach each other: the exchange then raises, it never
// copies through the host.
extern "C" int grs_enable_peer_access(int device, int peer) {
  int can = 0;
  cudaError_t err = cudaDeviceCanAccessPeer(&can, device, peer);
  if (err != cudaSuccess) return (int)err;
  if (!can) return (int)cudaErrorPeerAccessUnsupported;
  int prev = 0;
  err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clear it, so the next launch check does not see it
    err = cudaSuccess;
  }
  const cudaError_t back = cudaSetDevice(prev);
  return (int)(err != cudaSuccess ? err : back);
}

// -- Receive buffers that other processes store into (CUDA IPC) -------------
//
// On a process-group mesh the receivers of B6 and B7 live in other
// processes (parallel/peer_memory.py).  Each process allocates its ranks'
// receive buffers with cudaMalloc of its own, not through PyTorch's caching
// allocator, so that an IPC handle's base is the buffer itself (the caching
// allocator's blocks are carved out of larger segments, and under
// expandable_segments cannot be exported at all), exports their handles,
// and maps every peer's buffer into its own address space once, when the
// sort is built.  The kernels take the mapped addresses as they take any
// receiver's.  Each entry point works on `device` and restores the calling
// thread's current device; each returns a CUDA status, which the wrapper
// turns into an exception.  Nothing is copied through the host.

namespace {

// Runs f() with `device` current, then restores the previous device.
template <typename F>
int on_device(int device, F f) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = f();
  const cudaError_t back = cudaSetDevice(prev);
  return (int)(err != cudaSuccess ? err : back);
}

}  // namespace

// The size of an exported handle (cudaIpcMemHandle_t), in bytes.
extern "C" int grs_ipc_handle_bytes() { return (int)sizeof(cudaIpcMemHandle_t); }

// bytes of device memory on `device` into *ptr, with cudaMalloc.
extern "C" int grs_ipc_alloc(int device, long long bytes, void** ptr) {
  if (bytes <= 0 || ptr == nullptr) return (int)cudaErrorInvalidValue;
  return on_device(device, [&] { return cudaMalloc(ptr, (size_t)bytes); });
}

// The IPC handle of a buffer from grs_ipc_alloc, into handle[0,
// grs_ipc_handle_bytes()).
extern "C" int grs_ipc_export(int device, void* ptr, void* handle) {
  if (ptr == nullptr || handle == nullptr) return (int)cudaErrorInvalidValue;
  return on_device(device, [&] {
    return cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), ptr);
  });
}

// Maps another process's buffer, named by its handle, for kernels on
// `device` into *ptr.  Peer access to the buffer's card is enabled with the
// mapping (cudaIpcMemLazyEnablePeerAccess); where the two cards cannot
// reach each other the open fails and the exchange raises.  A process
// cannot open its own handles: its own buffers are used by their pointers.
extern "C" int grs_ipc_open(int device, const void* handle, void** ptr) {
  if (handle == nullptr || ptr == nullptr) return (int)cudaErrorInvalidValue;
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return on_device(device, [&] {
    return cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
  });
}

// Unmaps a buffer from grs_ipc_open.  Work still queued on `device` may
// store into it, so the device is synchronised first.
extern "C" int grs_ipc_close(int device, void* ptr) {
  return on_device(device, [&] {
    cudaError_t err = cudaDeviceSynchronize();
    return err != cudaSuccess ? err : cudaIpcCloseMemHandle(ptr);
  });
}

// Frees a buffer from grs_ipc_alloc (cudaFree waits for the device).
extern "C" int grs_ipc_free(int device, void* ptr) {
  return on_device(device, [&] { return cudaFree(ptr); });
}
