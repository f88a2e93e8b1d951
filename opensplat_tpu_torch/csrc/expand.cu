// Candidate expansion with the exact tile-ellipse cull.
//
// Replaces opensplat_tpu/ops/pallas/expand.py::_expand_kernel (launched by
// pallas_expand_bin). Gaussian g owns the candidate rows starts[g] ..
// starts[g] + cnt[g], one per tile of its tile bounding box in row-major
// order, and row starts[g] + off holds
//   key = ((v * n_tiles + tile) << 32) | depth_bits   and   gid = g
// for a kept (Gaussian, tile) pair, and the sentinel key
// ((V * n_tiles) << 32) | INT32_MAX with gid = C for a culled one;
// kept[g] counts g's kept rows. The C Gaussians are V views'
// projections concatenated view-major, per_view a view, and
// v = g / per_view is g's view: the vmapped batch axis that Pallas maps
// onto the TPU kernel's grid goes into the sort key here, so one launch
// and one sort serve every view, and a view's keys, rows and counts are
// the ones a launch on that view alone gives, offset by its first tile.
// With V = 1 the keys are the single view's, and the kernel is its
// instance without the view index (the VIEWS template flag), which cost
// a single view 5% of its time in an instance with it. The cull is
// binning.py:293-342 operation for operation: means quantised to 0.25
// px (saturated coordinates always keep), conic A/B/C and s_max =
// ln(opacity / alpha_thresh) rounded to bf16 (round to nearest even),
// 0.13 px position slack, the 2.1 * 2^-8 * S_corner compensation and
// the -0.05 margin — so the kept set is bit-identical to the JAX
// package's. With cull = 0 (the JAX package's
// pallas_expand_bin(..., cull=False), the reference's tile-bbox
// intersections, forward.cu:107-143) every row keeps and s_max is not
// read; the kernel is templated on the mode, so the culling build is the
// same code as without the option.
//
// Bound on this card: bytes. It reads ~56 B per Gaussian and writes 12 B
// per candidate row; the cull is ~70 float operations per row. A thread
// per Gaussian would leave each warp as slow as its largest Gaussian,
// and its 32 lanes would store into 32 unrelated segments. So the kernel
// is candidate-row-parallel, as the TPU kernel is: one CTA per block of
// G = 128 Gaussians (the JAX G_BLOCK is 256; 128 Gaussians a CTA, with
// 256 threads, took less time on the card). The block's rows are one
// contiguous window, since the stream is Gaussian-major, and its bounds
// come from starts and cnt on the device. The CTA stages each Gaussian's
// fields once in shared memory; then consecutive threads take
// consecutive rows of the window, find their Gaussian by binary search
// over the G window-relative starts, run the cull and store key and gid
// coalesced. A large Gaussian spreads over the whole CTA. Kept counts are
// integer sums in shared memory (one atomic per run of equal Gaussians in
// a warp), so they do not depend on the order.
#include "common.cuh"

namespace {

constexpr int G = 128;        // Gaussians per CTA
constexpr int THREADS = 256;  // rows in flight per CTA

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

// One Gaussian's fields, staged once per CTA.
struct Smem {
  int off[G];     // first row, relative to the window's first row
  int x0[G];      // tile bbox corner
  int y0[G];
  int bw[G];      // tile bbox width (>= 1)
  int kept[G];    // kept rows, summed by the rows' threads
  uint32_t depth[G];
  float4 geo[G];  // quantised mean x, y (px); bf16 A, B
  float2 cs[G];   // bf16 C, bf16 s_max
  int sat[G];     // saturated mean: every row keeps
};

// VIEWS: more than one view. The single view's instance is the kernel
// without the view axis, so the view index costs it nothing.
template <bool CULL, bool VIEWS>
__global__ void __launch_bounds__(THREADS) expand_kernel(
    int C, int per_view, const int* __restrict__ cnt,
    const int64_t* __restrict__ starts,
    const int* __restrict__ tile_min, const int* __restrict__ tile_max,
    const float* __restrict__ depths, const float* __restrict__ xys,
    const float* __restrict__ conics, const float* __restrict__ s_max,
    int tb_x, int n_tiles, int n_views, int64_t* __restrict__ keys,
    int* __restrict__ gids, int* __restrict__ kept) {
  __shared__ Smem S;
  __shared__ int s_rows;
  __shared__ int s_vtile[VIEWS ? G : 1];  // v * n_tiles of each Gaussian
  const int tid = threadIdx.x;
  const int g0 = blockIdx.x * G;
  const int n_g = min(G, C - g0);
  const int64_t w0 = starts[g0];

  // stage: thread i < G takes Gaussian g0 + i
  if (tid < G) {
    const int g = g0 + tid;
    int n = 0, off = 0;
    if (tid < n_g) {
      n = max(cnt[g], 0);
      off = static_cast<int>(starts[g] - w0);
      const int x0 = tile_min[2 * g];
      if constexpr (VIEWS) s_vtile[tid] = (g / per_view) * n_tiles;
      S.x0[tid] = x0;
      S.y0[tid] = tile_min[2 * g + 1];
      S.bw[tid] = max(tile_max[2 * g] - x0, 1);
      S.depth[tid] = __float_as_uint(depths[g]);
      const float mxq = q16(xys[2 * g]);
      const float myq = q16(xys[2 * g + 1]);
      S.sat[tid] = mxq >= 32767.0f || mxq <= -32768.0f ||
                   myq >= 32767.0f || myq <= -32768.0f;
      S.geo[tid] = make_float4(mxq * 0.25f, myq * 0.25f,
                               bf16_round(conics[3 * g]),
                               bf16_round(conics[3 * g + 1]));
      S.cs[tid] = make_float2(bf16_round(conics[3 * g + 2]),
                              CULL ? bf16_round(s_max[g]) : 0.0f);
      if (tid == n_g - 1) s_rows = off + n;
    }
    // Gaussians past C start past the window's end and own no rows
    S.off[tid] = tid < n_g ? off : 0x7FFFFFFF;
    S.kept[tid] = 0;
  }
  __syncthreads();

  const int n_rows = s_rows;
  const int lane = tid & 31;
  const int64_t sentinel =
      (static_cast<int64_t>(n_views * n_tiles) << 32) | 0x7FFFFFFF;
  for (int base = 0; base < n_rows; base += THREADS) {
    const int r = base + tid;
    const bool valid = r < n_rows;
    // the row's Gaussian: the last j with off[j] <= r (a zero-count
    // Gaussian shares its start with the next, so it is never found)
    int j = 0;
#pragma unroll
    for (int step = G / 2; step > 0; step >>= 1)
      if (S.off[j + step] <= r) j += step;
    bool keep = false;
    if (valid) {
      const int off = r - S.off[j];
      const int bw = S.bw[j];
      const int ty = S.y0[j] + off / bw;
      const int tx = S.x0[j] + off % bw;
      keep = !CULL || S.sat[j] != 0;
      if (!keep) {
        const float4 q = S.geo[j];
        const float2 cs = S.cs[j];
        const float ms = min_sigma_over_tile(q.x, q.y, q.z, q.w, cs.x,
                                             static_cast<float>(tx),
                                             static_cast<float>(ty));
        keep = (cs.y - ms) >= -0.05f;
      }
      int64_t tile = static_cast<int64_t>(ty) * tb_x + tx;
      if constexpr (VIEWS) tile += s_vtile[j];
      keys[w0 + r] = keep ? ((tile << 32) | S.depth[j]) : sentinel;
      gids[w0 + r] = keep ? g0 + j : C;
    }
    // rows of one Gaussian are consecutive: one shared atomic per run
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, valid ? j : -1);
    const unsigned kb = __ballot_sync(0xFFFFFFFFu, keep);
    if (valid && lane == __ffs(peers) - 1)
      atomicAdd(&S.kept[j], __popc(peers & kb));
  }
  __syncthreads();
  if (tid < n_g) kept[g0 + tid] = S.kept[tid];
}

}  // namespace

OSK_API int osk_expand(int C, int per_view, const void* cnt,
                       const void* starts, const void* tile_min,
                       const void* tile_max, const void* depths,
                       const void* xys, const void* conics,
                       const void* s_max, int tb_x, int n_tiles, int cull,
                       void* keys, void* gids, void* kept, void* stream) {
  if (C > 0 && per_view > 0) {
    const bool views = per_view < C;
    auto kernel = cull ? (views ? expand_kernel<true, true>
                                : expand_kernel<true, false>)
                       : (views ? expand_kernel<false, true>
                                : expand_kernel<false, false>);
    kernel<<<(C + G - 1) / G, THREADS, 0,
             static_cast<cudaStream_t>(stream)>>>(
        C, per_view, static_cast<const int*>(cnt),
        static_cast<const int64_t*>(starts),
        static_cast<const int*>(tile_min), static_cast<const int*>(tile_max),
        static_cast<const float*>(depths), static_cast<const float*>(xys),
        static_cast<const float*>(conics), static_cast<const float*>(s_max),
        tb_x, n_tiles, C / per_view, static_cast<int64_t*>(keys),
        static_cast<int*>(gids), static_cast<int*>(kept));
  }
  return static_cast<int>(cudaGetLastError());
}

// out[5] = {Gaussians per CTA, threads per CTA, registers per thread,
// shared memory per CTA (bytes), resident CTAs per SM}.
OSK_API int osk_expand_info(void* out) {
  int* o = static_cast<int*>(out);
  o[0] = G;
  o[1] = THREADS;
  return osk::kernel_info(expand_kernel<true, false>, THREADS, 0, o + 2);
}
