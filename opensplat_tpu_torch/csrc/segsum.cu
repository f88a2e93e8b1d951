// Per-Gaussian segment sum of the per-record gradient stream.
//
// Replaces opensplat_tpu/ops/pallas/segsum.py::_segsum_kernel (launched by
// pallas_segment_sum). The caller orders the tile-sorted stream by
// Gaussian with a stable sort of gauss_ids (perm) and gives each
// Gaussian's offset into that order (exclusive cumsum of its kept count
// from the expansion) and its count. One warp per Gaussian: lane l sums
// records l, l + 32, ... of its segment through perm, then a fixed
// shuffle tree combines the lanes, so each (C, 9) row is summed in a
// fixed order — deterministic, with no float atomics. Sentinel records
// (gid = C) lie past every segment and are never read.
//
// Bound on this card: bytes — 36 B of gradients and 8 B of perm per
// record, read once, and 36 B written per Gaussian. The reads through perm
// are scattered rows of 36 B; a warp covers one Gaussian's records, which
// sit in few tiles.
#include "common.cuh"

namespace {

constexpr int NG = 9;

__global__ void segsum_kernel(int C, const int64_t* __restrict__ offsets,
                              const int* __restrict__ counts,
                              const int64_t* __restrict__ perm,
                              const float* __restrict__ grads,
                              float* __restrict__ out) {
  const int64_t gw =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (gw >= C) return;  // whole warps leave together
  const int64_t off = offsets[gw];
  const int n = counts[gw];
  float acc[NG];
#pragma unroll
  for (int j = 0; j < NG; ++j) acc[j] = 0.0f;
  for (int k = lane; k < n; k += 32) {
    const float* row = grads + perm[off + k] * NG;
#pragma unroll
    for (int j = 0; j < NG; ++j) acc[j] += row[j];
  }
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    for (int o = 16; o > 0; o >>= 1)
      acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], o);
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < NG; ++j) out[gw * NG + j] = acc[j];
  }
}

}  // namespace

OSK_API int osk_segsum(int C, const void* offsets, const void* counts,
                       const void* perm, const void* grads, void* out,
                       void* stream) {
  if (C > 0) {
    const int threads = 256;
    const int64_t blocks = (static_cast<int64_t>(C) * 32 + threads - 1) / threads;
    segsum_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        C, static_cast<const int64_t*>(offsets),
        static_cast<const int*>(counts), static_cast<const int64_t*>(perm),
        static_cast<const float*>(grads), static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
