// Tile rasterizer, backward.
//
// Replaces opensplat_tpu/ops/pallas/raster.py::_bwd_kernel (launched by
// pallas_rasterize_backward). One CTA per 16x16 tile, one thread per
// pixel. The tile replays its records back to front from its replay limit
// glim = start + min(max_p eff_p, count), eff_p = final_idx_p - start
// (count for pixels that never stopped) — the same limit as
// compact_grad_layout. T is recovered by division (T_k = T_run / (1 -
// alpha)) with the reference's 0.99 backward clamp (backward.cu:272).
// For each record every thread computes its pixel's 9 gradient terms
// (v_x, v_y, v_A, v_B, v_C, v_opacity, v_r, v_g, v_b); the CTA reduces
// them with warp shuffles, then across the 8 warps through shared memory
// in a fixed order, zeroes a nonfinite sum, and one thread per term writes
// the record's (9,) f32 at the record's index in the sorted stream.
// Records past the replay limit are not written (the caller zero-fills).
// The result is deterministic, unlike the reference's warp atomics
// (backward.cu:331-352).
//
// Bound on this card: the per-record CTA reduction (45 shuffles and a
// barrier per record) and the (pixel, record) arithmetic, not bytes. Two
// alternating shared reduction buffers let one barrier per record suffice.
#include "common.cuh"

namespace {

using osk::PIX;
constexpr int NWARP = PIX / 32;
constexpr int NG = 9;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(PIX) raster_bwd_kernel(
    const int* __restrict__ tile_start, const int* __restrict__ tile_end,
    const int* __restrict__ gids, const float* __restrict__ xys,
    const float* __restrict__ conics, const float* __restrict__ opac,
    const float* __restrict__ colors, const float* __restrict__ bg,
    const float* __restrict__ final_t, const int* __restrict__ final_idx,
    const float* __restrict__ v_img, const float* __restrict__ v_ft,
    int height, int width, int tb_x, float* __restrict__ grads) {
  __shared__ float s_x[PIX], s_y[PIX], s_a[PIX], s_b[PIX], s_c[PIX];
  __shared__ float s_op[PIX], s_r[PIX], s_g[PIX], s_bl[PIX];
  __shared__ float red[2][NWARP][NG];
  __shared__ int s_eff;

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int px = (t % tb_x) * osk::BLOCK_X + tid % osk::BLOCK_X;
  const int py = (t / tb_x) * osk::BLOCK_Y + tid / osk::BLOCK_X;
  const bool inside = px < width && py < height;
  const float fpx = static_cast<float>(px);
  const float fpy = static_cast<float>(py);
  const int start = tile_start[t];
  const int count = tile_end[t] - start;

  const int fidx = final_idx[t * PIX + tid];
  const int eff = fidx >= osk::STOP_SENTINEL ? count : fidx - start;
  if (tid == 0) s_eff = 0;
  __syncthreads();
  atomicMax(&s_eff, eff);  // max is order-free: deterministic
  __syncthreads();
  const int glim = start + min(s_eff, count);

  // padding pixels carry zero cotangents and so add exactly zero
  float T_run = 1.0f, vr = 0.0f, vg = 0.0f, vb = 0.0f, vob = 0.0f;
  if (inside) {
    const int p = py * width + px;
    T_run = final_t[p];
    vr = v_img[3 * p];
    vg = v_img[3 * p + 1];
    vb = v_img[3 * p + 2];
    const float bg_dot = vr * bg[0] + vg * bg[1] + vb * bg[2];
    vob = T_run * (v_ft[p] + bg_dot);
  }
  float buf_dot = 0.0f;  // sum over later records of fac * (colour . v_rgb)
  int parity = 0;

  for (int hi = glim; hi > start; hi -= PIX) {
    const int lo = max(start, hi - PIX);
    __syncthreads();  // the previous batch is consumed
    const int idx = lo + tid;
    if (idx < hi) {
      const int gi = gids[idx];
      s_x[tid] = xys[2 * gi];
      s_y[tid] = xys[2 * gi + 1];
      s_a[tid] = conics[3 * gi];
      s_b[tid] = conics[3 * gi + 1];
      s_c[tid] = conics[3 * gi + 2];
      s_op[tid] = opac[gi];
      s_r[tid] = colors[3 * gi];
      s_g[tid] = colors[3 * gi + 1];
      s_bl[tid] = colors[3 * gi + 2];
    }
    __syncthreads();
    for (int k = hi - lo - 1; k >= 0; --k) {
      const int gk = lo + k;
      float v[NG];
#pragma unroll
      for (int j = 0; j < NG; ++j) v[j] = 0.0f;
      if (inside && gk < fidx) {
        const float A = s_a[k], B = s_b[k], C = s_c[k], op = s_op[k];
        const float dx = s_x[k] - fpx;
        const float dy = s_y[k] - fpy;
        const float sigma = osk::sigma_at(A, B, C, dx, dy);
        const float vis = expf(-sigma);
        const float a_raw = op * vis;
        if (sigma >= 0.0f && a_raw >= osk::ALPHA_THRESH) {
          const float alpha = fminf(a_raw, osk::BWD_ALPHA_CLAMP);
          const float ra = 1.0f / (1.0f - alpha);
          const float T_k = T_run * ra;  // transmittance before this record
          const float fac = alpha * T_k;
          const float w = s_r[k] * vr + s_g[k] * vg + s_bl[k] * vb;
          const float v_alpha = T_k * w - ra * (buf_dot + vob);
          const float v_sigma = -op * vis * v_alpha;
          v[0] = v_sigma * (A * dx + B * dy);
          v[1] = v_sigma * (B * dx + C * dy);
          v[2] = 0.5f * v_sigma * dx * dx;
          v[3] = 0.5f * v_sigma * dx * dy;
          v[4] = 0.5f * v_sigma * dy * dy;
          v[5] = vis * v_alpha;
          v[6] = fac * vr;
          v[7] = fac * vg;
          v[8] = fac * vb;
          buf_dot += fac * w;
          T_run = T_k;
        }
      }
#pragma unroll
      for (int j = 0; j < NG; ++j) v[j] = warp_sum(v[j]);
      if (lane == 0) {
#pragma unroll
        for (int j = 0; j < NG; ++j) red[parity][warp][j] = v[j];
      }
      __syncthreads();
      if (tid < NG) {
        float s = 0.0f;
#pragma unroll
        for (int w8 = 0; w8 < NWARP; ++w8) s += red[parity][w8][tid];
        grads[static_cast<int64_t>(gk) * NG + tid] = isfinite(s) ? s : 0.0f;
      }
      parity ^= 1;
    }
  }
}

}  // namespace

OSK_API int osk_raster_bwd(int n_tiles, const void* tile_start,
                           const void* tile_end, const void* gids,
                           const void* xys, const void* conics,
                           const void* opac, const void* colors,
                           const void* bg, const void* final_t,
                           const void* final_idx, const void* v_img,
                           const void* v_ft, int height, int width, int tb_x,
                           void* grads, void* stream) {
  if (n_tiles > 0) {
    raster_bwd_kernel<<<n_tiles, PIX, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(tile_start), static_cast<const int*>(tile_end),
        static_cast<const int*>(gids), static_cast<const float*>(xys),
        static_cast<const float*>(conics), static_cast<const float*>(opac),
        static_cast<const float*>(colors), static_cast<const float*>(bg),
        static_cast<const float*>(final_t),
        static_cast<const int*>(final_idx), static_cast<const float*>(v_img),
        static_cast<const float*>(v_ft), height, width, tb_x,
        static_cast<float*>(grads));
  }
  return static_cast<int>(cudaGetLastError());
}
