// Per-Gaussian segment sum of the per-record gradient rows.
//
// Replaces opensplat_tpu/ops/pallas/segsum.py::_segsum_kernel (launched by
// pallas_segment_sum). The backward writes each record's (9,) row at its
// candidate row, and the candidate rows are Gaussian-major (the expansion
// writes Gaussian g's candidates at cand_start[g] .. + cand_count[g]), so
// each Gaussian's rows are one contiguous segment and no sort is needed.
// Culled candidates and records past a tile's replay limit are zero rows
// inside the segments and add exactly zero.
//
// One warp per 32 consecutive Gaussians. The warp copies the rows its
// short segments cover through shared memory in windows of WIN rows, as
// coalesced 16-byte loads, and each lane sums its own segment's rows from
// there in index order. A segment longer than LONG rows is summed by the
// whole warp afterwards: lane l takes rows l, l + 32, ... (neighbouring
// lanes on neighbouring rows), then a fixed xor-shuffle tree combines the
// lanes. Every sum is taken in a fixed order: the same bits on every call,
// and no float atomics.
//
// Bound on this card: bytes — the kept records' 36 B rows read once, plus
// 12 B of segment bounds read and 36 B written per Gaussian (the zero rows
// of culled candidates are read too, ~28% more on the main path). The
// design keeps the row reads coalesced and each row read once; the short
// segments' sums run from shared memory.
#include "common.cuh"

namespace {

constexpr int NG = 9;
constexpr int WARPS = 8;
constexpr int WIN = 128;   // rows per window of a warp
constexpr int LONG = 32;   // longer segments are summed by the whole warp
constexpr int WIN_F = WIN * NG + 8;  // floats, with room to align to 16 B
constexpr unsigned FULL = 0xffffffffu;

constexpr int64_t NONE = 0x7fffffffffffffffLL;

__device__ __forceinline__ int64_t min64(int64_t x, int64_t y) {
  return x < y ? x : y;
}

__device__ __forceinline__ int64_t max64(int64_t x, int64_t y) {
  return x > y ? x : y;
}

__device__ __forceinline__ int64_t warp_min(int64_t v) {
  for (int o = 16; o > 0; o >>= 1) v = min64(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ int64_t warp_max(int64_t v) {
  for (int o = 16; o > 0; o >>= 1) v = max64(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__global__ void __launch_bounds__(WARPS * 32) segsum_kernel(
    int C, const int64_t* __restrict__ starts, const int* __restrict__ counts,
    const float* __restrict__ rows, float* __restrict__ out) {
  __shared__ __align__(16) float s_win[WARPS][WIN_F];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t g0 = (static_cast<int64_t>(blockIdx.x) * WARPS + warp) * 32;
  if (g0 >= C) return;  // whole warps leave together; only __syncwarp below
  const int64_t g = g0 + lane;
  const bool valid = g < C;
  const int64_t a = valid ? starts[g] : 0;
  const int n = valid ? counts[g] : 0;
  const int64_t b = a + n;
  const bool is_short = n > 0 && n <= LONG;

  float acc[NG];
#pragma unroll
  for (int j = 0; j < NG; ++j) acc[j] = 0.0f;

  // short segments, window by window over the rows they cover
  float* s = s_win[warp];
  int64_t w = warp_min(is_short ? a : NONE);
  const int64_t r1 = warp_max(is_short ? b : -1);
  while (w < r1) {
    const int64_t wn = min64(WIN, r1 - w);
    const int64_t f0 = w * NG;
    const int64_t f0a = f0 & ~static_cast<int64_t>(3);  // 16-byte aligned
    const int shift = static_cast<int>(f0 - f0a);
    const int n4 = (shift + static_cast<int>(wn) * NG + 3) >> 2;
    const float4* src = reinterpret_cast<const float4*>(rows + f0a);
#pragma unroll 4
    for (int i = lane; i < n4; i += 32)
      reinterpret_cast<float4*>(s)[i] = src[i];
    __syncwarp();
    if (is_short) {
      const int64_t lo = max64(a, w);
      const int64_t hi = min64(b, w + wn);
      for (int64_t r = lo; r < hi; ++r) {
        const float* q = s + shift + (r - w) * NG;
#pragma unroll
        for (int j = 0; j < NG; ++j) acc[j] += q[j];
      }
    }
    __syncwarp();
    // the next window starts at the first row past this one that a short
    // segment still needs (long segments in between are skipped)
    const int64_t nxt = w + wn;
    w = warp_min(is_short && b > nxt ? max64(a, nxt) : NONE);
  }

  // long segments, one at a time in lane order, by the whole warp
  unsigned todo = __ballot_sync(FULL, n > LONG);
  while (todo) {
    const int src = __ffs(todo) - 1;
    todo &= todo - 1;
    const int64_t la = __shfl_sync(FULL, a, src);
    const int ln = __shfl_sync(FULL, n, src);
    float p[NG];
#pragma unroll
    for (int j = 0; j < NG; ++j) p[j] = 0.0f;
#pragma unroll 4
    for (int r = lane; r < ln; r += 32) {
      const float* q = rows + (la + r) * NG;
#pragma unroll
      for (int j = 0; j < NG; ++j) p[j] += q[j];
    }
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      for (int o = 16; o > 0; o >>= 1) p[j] += __shfl_xor_sync(FULL, p[j], o);
      if (lane == src) acc[j] = p[j];
    }
  }

  if (valid) {
#pragma unroll
    for (int j = 0; j < NG; ++j) out[g * NG + j] = acc[j];
  }
}

}  // namespace

OSK_API int osk_segsum(int C, const void* starts, const void* counts,
                       const void* rows, void* out, void* stream) {
  if (C > 0) {
    const int threads = WARPS * 32;
    const int64_t blocks = (static_cast<int64_t>(C) + threads - 1) / threads;
    segsum_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        C, static_cast<const int64_t*>(starts),
        static_cast<const int*>(counts), static_cast<const float*>(rows),
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
