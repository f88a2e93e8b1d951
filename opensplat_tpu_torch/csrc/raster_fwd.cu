// Tile rasterizer, forward.
//
// Replaces opensplat_tpu/ops/pallas/raster.py::_fwd_kernel (launched by
// pallas_rasterize_forward). One CTA per 16x16 tile, one thread per pixel,
// front-to-back over the tile's depth-sorted records (reference
// forward.cu:256-378). Records come in batches of 256: the CTA gathers
// each batch cooperatively by gauss_id straight from the per-Gaussian
// xys / conics / opacities / colours tensors into shared memory, which
// replaces the JAX package's separate packed-record gather
// (integration.py::_pack_planes). Per pixel: alpha = min(0.999,
// op * exp(-sigma)); records with sigma < 0 or alpha < 1/255 are skipped;
// the first record at which T * (1 - alpha) <= 1e-4 stops the pixel and
// is not composited, and its global index is the pixel's final_idx
// (sentinel 2^30 when the pixel never stops). The CTA leaves once every
// pixel is done (__syncthreads_count). Output: out = rgb + T * background
// (image layout, cropped), final T, and final_idx for all 256 pixels of
// each tile, padding pixels included, as the JAX kernel emits them.
//
// Bound on this card: the (pixel, record) pairs — about 15 float
// operations and one exp each — and the latency of the per-batch gather,
// not bytes. The shared-memory batch serves every record to 256 threads
// with one global read; the early exit cuts the pairs to what compositing
// needs. Double-buffering the gather is later work.
#include "common.cuh"

namespace {

using osk::PIX;

__global__ void __launch_bounds__(PIX) raster_fwd_kernel(
    const int* __restrict__ tile_start, const int* __restrict__ tile_end,
    const int* __restrict__ gids, const float* __restrict__ xys,
    const float* __restrict__ conics, const float* __restrict__ opac,
    const float* __restrict__ colors, const float* __restrict__ bg,
    int height, int width, int tb_x, float* __restrict__ out_img,
    float* __restrict__ out_t, int* __restrict__ final_idx) {
  __shared__ float s_x[PIX], s_y[PIX], s_a[PIX], s_b[PIX], s_c[PIX];
  __shared__ float s_op[PIX], s_r[PIX], s_g[PIX], s_bl[PIX];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int px = (t % tb_x) * osk::BLOCK_X + tid % osk::BLOCK_X;
  const int py = (t / tb_x) * osk::BLOCK_Y + tid / osk::BLOCK_X;
  const float fpx = static_cast<float>(px);
  const float fpy = static_cast<float>(py);
  const int start = tile_start[t];
  const int end = tile_end[t];

  float T = 1.0f, r = 0.0f, g = 0.0f, b = 0.0f;
  int stop = osk::STOP_SENTINEL;
  bool done = false;

  for (int base = start; base < end; base += PIX) {
    // barrier: the previous batch is consumed; leave when all pixels stopped
    if (__syncthreads_count(done) == PIX) break;
    const int idx = base + tid;
    if (idx < end) {
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
    const int n = min(PIX, end - base);
    for (int k = 0; k < n && !done; ++k) {
      const float sigma =
          osk::sigma_at(s_a[k], s_b[k], s_c[k], s_x[k] - fpx, s_y[k] - fpy);
      if (!(sigma >= 0.0f)) continue;
      float alpha = s_op[k] * expf(-sigma);
      if (!(alpha >= osk::ALPHA_THRESH)) continue;
      alpha = fminf(alpha, osk::FWD_ALPHA_CLAMP);
      const float next_t = T * (1.0f - alpha);
      if (next_t <= osk::T_EPS) {
        done = true;
        stop = base + k;
        break;
      }
      const float vis = alpha * T;
      r += vis * s_r[k];
      g += vis * s_g[k];
      b += vis * s_bl[k];
      T = next_t;
    }
  }

  if (px < width && py < height) {
    const int p = py * width + px;
    out_img[3 * p] = r + T * bg[0];
    out_img[3 * p + 1] = g + T * bg[1];
    out_img[3 * p + 2] = b + T * bg[2];
    out_t[p] = T;
  }
  final_idx[t * PIX + tid] = stop;
}

}  // namespace

OSK_API int osk_raster_fwd(int n_tiles, const void* tile_start,
                           const void* tile_end, const void* gids,
                           const void* xys, const void* conics,
                           const void* opac, const void* colors,
                           const void* bg, int height, int width, int tb_x,
                           void* out_img, void* out_t, void* final_idx,
                           void* stream) {
  if (n_tiles > 0) {
    raster_fwd_kernel<<<n_tiles, PIX, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(tile_start), static_cast<const int*>(tile_end),
        static_cast<const int*>(gids), static_cast<const float*>(xys),
        static_cast<const float*>(conics), static_cast<const float*>(opac),
        static_cast<const float*>(colors), static_cast<const float*>(bg),
        height, width, tb_x, static_cast<float*>(out_img),
        static_cast<float*>(out_t), static_cast<int*>(final_idx));
  }
  return static_cast<int>(cudaGetLastError());
}
