// Native host library of the PyTorch/CUDA port: the host-side work that is
// hot enough to matter off the Python interpreter.  The port's own copy of
// the JAX package's gpu_radix_sort_tpu/native/sortcore.cpp.
//   * pcg32_fill     — bulk deterministic key generation, bit-exact with the
//                      reference generator (reference: libsort/utils.cu:63-79).
//                      Parallelized over threads via LCG jump-ahead.
//   * cpu_sort_u32   — CPU oracle full sort (reference: invokers.cu:68
//                      `providedCpu` = std::sort).
//   * cpu_partial_u32— CPU oracle stable partial sort by bits
//                      [offset, offset+width) plus reference-contract group
//                      boundaries (reference: invokers.cu:15 `gpuPartial`,
//                      sort.cu:367-394 `GetBoundaries` incl. the high->low
//                      empty-bucket backfill that skips groups 0 and 1).
//   * histogram_u32  — per-digit counts.
//
// A plain C ABI consumed via ctypes; built with g++ at first use by
// gpu_radix_sort_tpu_torch/utils/native.py.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr uint64_t kMult = 6364136223846793005ull;
constexpr uint64_t kInc = 1442695040888963407ull;

inline uint32_t rotr32(uint32_t x, unsigned r) {
  return x >> r | x << (-r & 31u);
}

// Advance-by-n coefficients (a, c) with s_n = s*a + c, via doubling.
void jump_coeffs(uint64_t n, uint64_t* a_out, uint64_t* c_out) {
  uint64_t a = 1, c = 0;          // identity
  uint64_t cur_a = kMult, cur_c = kInc;  // advance-by-1
  while (n) {
    if (n & 1) {
      a = a * cur_a;
      c = c * cur_a + cur_c;
    }
    cur_c = cur_c * (cur_a + 1);
    cur_a = cur_a * cur_a;
    n >>= 1;
  }
  *a_out = a;
  *c_out = c;
}

void pcg32_fill_range(uint64_t state, uint32_t* out, size_t n) {
  for (size_t i = 0; i < n; i++) {
    uint64_t x = state;
    unsigned count = (unsigned)(x >> 59);
    state = x * kMult + kInc;
    x ^= x >> 18;
    out[i] = rotr32((uint32_t)(x >> 27), count);
  }
}

}  // namespace

extern "C" {

// Fills out[0..n) with the PCG32 stream starting at `state`; returns the
// post-advance state (state after n steps).
uint64_t pcg32_fill(uint64_t state, uint32_t* out, uint64_t n) {
  const uint64_t kParThreshold = 1u << 20;
  unsigned hw = std::thread::hardware_concurrency();
  if (n >= kParThreshold && hw > 1) {
    unsigned nthread = std::min<uint64_t>(hw, n / (1u << 18));
    nthread = std::max(1u, nthread);
    std::vector<std::thread> threads;
    uint64_t chunk = n / nthread;
    for (unsigned t = 0; t < nthread; t++) {
      uint64_t begin = t * chunk;
      uint64_t end = (t + 1 == nthread) ? n : begin + chunk;
      uint64_t a, c;
      jump_coeffs(begin, &a, &c);
      uint64_t s = state * a + c;
      threads.emplace_back(pcg32_fill_range, s, out + begin, end - begin);
    }
    for (auto& th : threads) th.join();
  } else {
    pcg32_fill_range(state, out, n);
  }
  uint64_t a, c;
  jump_coeffs(n, &a, &c);
  return state * a + c;
}

// In-place ascending sort of uint32 keys (CPU oracle; reference:
// invokers.cu:68 `providedCpu`).
bool cpu_sort_u32(uint32_t* data, uint64_t n) {
  std::sort(data, data + n);
  return true;
}

// Stable partial sort by bits [offset, offset+width) plus reference-contract
// boundaries.  boundaries must have 2^width entries.  Mirrors the observable
// behavior of the reference C ABI (invokers.cu:15 `gpuPartial`): LSD radix
// passes are stable, so the net effect is a stable sort on the digit;
// boundaries[g] = first index of group g as produced by gpu_groups
// (sort.cu:14-27: only groups whose first element has a differing
// predecessor get marked; group of element 0 does not) followed by the
// high->low backfill for empty groups > 1 (sort.cu:378-394).
bool cpu_partial_u32(uint32_t* data, uint32_t* boundaries, uint64_t n,
                     uint32_t offset, uint32_t width) {
  // check offset alone first: `offset + width` is uint32 arithmetic and
  // can wrap (e.g. offset=0xFFFFFFFE, width=4 -> 2), passing the guard
  // into shift UB.
  if (width == 0 || width > 32 || offset > 32 || offset + width > 32)
    return false;
  uint64_t nb = 1ull << width;
  uint32_t mask = (width == 32) ? 0xffffffffu : ((1u << width) - 1u);
  std::stable_sort(data, data + n, [&](uint32_t a, uint32_t b) {
    return ((a >> offset) & mask) < ((b >> offset) & mask);
  });
  std::memset(boundaries, 0, nb * sizeof(uint32_t));
  for (uint64_t i = 1; i < n; i++) {
    uint32_t g = (data[i] >> offset) & mask;
    uint32_t gp = (data[i - 1] >> offset) & mask;
    if (g != gp) boundaries[g] = (uint32_t)i;
  }
  // Empty-group backfill, exactly as the reference host loop
  // (sort.cu:381-387): groups (nb-1 .. 2], zero entries take the previous
  // (higher) group's boundary; group 1 is never backfilled.
  uint32_t prev = (uint32_t)n;
  for (int64_t g = (int64_t)nb - 1; g > 1; g--) {
    if (boundaries[g] == 0) boundaries[g] = prev;
    prev = boundaries[g];
  }
  return true;
}

// counts[d] = number of keys whose bits [offset, offset+width) equal d.
void histogram_u32(const uint32_t* data, uint64_t n, uint32_t offset,
                   uint32_t width, uint64_t* counts) {
  uint64_t nb = 1ull << width;
  uint32_t mask = (width == 32) ? 0xffffffffu : ((1u << width) - 1u);
  std::memset(counts, 0, nb * sizeof(uint64_t));
  for (uint64_t i = 0; i < n; i++) counts[(data[i] >> offset) & mask]++;
}

}  // extern "C"
