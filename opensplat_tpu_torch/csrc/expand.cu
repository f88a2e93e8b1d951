// Candidate expansion with the exact tile-ellipse cull.
//
// Replaces opensplat_tpu/ops/pallas/expand.py::_expand_kernel (launched by
// pallas_expand_bin). One thread per Gaussian, as in the reference's
// map_gaussian_to_intersects (forward.cu:107-143): the thread walks its
// tile bounding box in row-major order and writes, at starts[g] + off,
//   key = (tile << 32) | depth_bits   and   gid = g
// for kept (Gaussian, tile) pairs, and the sentinel key
// (n_tiles << 32) | INT32_MAX with gid = C for culled ones, then its kept
// count. The cull is binning.py:293-342 operation for operation: means
// quantised to 0.25 px (saturated coordinates always keep), conic A/B/C
// and s_max = ln(opacity / alpha_thresh) rounded to bf16 (round to
// nearest even), 0.13 px position slack, the 2.1 * 2^-8 * S_corner
// compensation and the -0.05 margin — so the kept set is bit-identical to
// the JAX package's.
//
// Bound on this card: bytes. It reads ~60 B per Gaussian and writes 12 B
// per candidate; the cull is ~60 float operations per candidate. A thread
// per Gaussian keeps the per-Gaussian fields in registers (the TPU kernel
// needed one-hot matmuls to broadcast them); consecutive threads write
// consecutive Gaussians' segments, so stores stay mostly coalesced. Large
// Gaussians serialise on one thread — a later PR can split them.
#include "common.cuh"

namespace {

__device__ __forceinline__ float bf16_round(float x) {
  uint32_t b = __float_as_uint(x);
  b = (b + 0x7FFFu + ((b >> 16) & 1u)) & 0xFFFF0000u;
  return __uint_as_float(b);
}

__device__ __forceinline__ float q16(float v) {
  return fminf(fmaxf(rintf(v * 4.0f), -32768.0f), 32767.0f);
}

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// Conservative lower bound of the exponent over the tile rectangle
// (binning.py::_min_sigma_over_tile, pos_slack = 0.13).
__device__ float min_sigma_over_tile(float mx, float my, float A, float B,
                                     float C, float tx, float ty) {
  const float dhi_x = mx - tx * 16.0f + 0.13f;
  const float dlo_x = dhi_x - 15.0f - 0.26f;
  const float dhi_y = my - ty * 16.0f + 0.13f;
  const float dlo_y = dhi_y - 15.0f - 0.26f;
  const bool inside =
      (dlo_x <= 0.0f) && (dhi_x >= 0.0f) && (dlo_y <= 0.0f) && (dhi_y >= 0.0f);
  if (inside) return 0.0f;
  const float c_safe = fmaxf(C, 1e-12f);
  const float a_safe = fmaxf(A, 1e-12f);
  const float ex_lo = osk::sigma_at(
      A, B, C, dlo_x, clampf(-B * dlo_x / c_safe, dlo_y, dhi_y));
  const float ex_hi = osk::sigma_at(
      A, B, C, dhi_x, clampf(-B * dhi_x / c_safe, dlo_y, dhi_y));
  const float ey_lo = osk::sigma_at(
      A, B, C, clampf(-B * dlo_y / a_safe, dlo_x, dhi_x), dlo_y);
  const float ey_hi = osk::sigma_at(
      A, B, C, clampf(-B * dhi_y / a_safe, dlo_x, dhi_x), dhi_y);
  const float m = fminf(fminf(ex_lo, ex_hi), fminf(ey_lo, ey_hi));
  const float s_corner =
      0.5f * (A * fmaxf(dlo_x * dlo_x, dhi_x * dhi_x) +
              C * fmaxf(dlo_y * dlo_y, dhi_y * dhi_y));
  return m - 0.00820312462747097f * s_corner;  // float32(2.1 * 2^-8)
}

__global__ void expand_kernel(int C, const int* __restrict__ cnt,
                              const int64_t* __restrict__ starts,
                              const int* __restrict__ tile_min,
                              const int* __restrict__ tile_max,
                              const float* __restrict__ depths,
                              const float* __restrict__ xys,
                              const float* __restrict__ conics,
                              const float* __restrict__ s_max, int tb_x,
                              int n_tiles, int64_t* __restrict__ keys,
                              int* __restrict__ gids, int* __restrict__ kept) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= C) return;
  const int n = cnt[g];
  if (n <= 0) {
    kept[g] = 0;
    return;
  }
  const int64_t base = starts[g];
  const int x0 = tile_min[2 * g];
  const int y0 = tile_min[2 * g + 1];
  const int bw = max(tile_max[2 * g] - x0, 1);
  const uint32_t depth_bits = __float_as_uint(depths[g]);

  const float mxq = q16(xys[2 * g]);
  const float myq = q16(xys[2 * g + 1]);
  const bool saturated = mxq >= 32767.0f || mxq <= -32768.0f ||
                         myq >= 32767.0f || myq <= -32768.0f;
  const float mx = mxq * 0.25f;
  const float my = myq * 0.25f;
  const float A = bf16_round(conics[3 * g]);
  const float B = bf16_round(conics[3 * g + 1]);
  const float Cc = bf16_round(conics[3 * g + 2]);
  const float s = bf16_round(s_max[g]);
  const int64_t sentinel = (static_cast<int64_t>(n_tiles) << 32) | 0x7FFFFFFF;

  int n_kept = 0;
  for (int off = 0; off < n; ++off) {
    const int ty = y0 + off / bw;
    const int tx = x0 + off % bw;
    bool keep = saturated;
    if (!keep) {
      const float ms = min_sigma_over_tile(mx, my, A, B, Cc,
                                           static_cast<float>(tx),
                                           static_cast<float>(ty));
      keep = (s - ms) >= -0.05f;
    }
    const int64_t tile = static_cast<int64_t>(ty) * tb_x + tx;
    keys[base + off] = keep ? ((tile << 32) | depth_bits) : sentinel;
    gids[base + off] = keep ? g : C;
    n_kept += keep ? 1 : 0;
  }
  kept[g] = n_kept;
}

}  // namespace

OSK_API int osk_expand(int C, const void* cnt, const void* starts,
                       const void* tile_min, const void* tile_max,
                       const void* depths, const void* xys, const void* conics,
                       const void* s_max, int tb_x, int n_tiles, void* keys,
                       void* gids, void* kept, void* stream) {
  if (C > 0) {
    expand_kernel<<<(C + 255) / 256, 256, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        C, static_cast<const int*>(cnt), static_cast<const int64_t*>(starts),
        static_cast<const int*>(tile_min), static_cast<const int*>(tile_max),
        static_cast<const float*>(depths), static_cast<const float*>(xys),
        static_cast<const float*>(conics), static_cast<const float*>(s_max),
        tb_x, n_tiles, static_cast<int64_t*>(keys), static_cast<int*>(gids),
        static_cast<int*>(kept));
  }
  return static_cast<int>(cudaGetLastError());
}
