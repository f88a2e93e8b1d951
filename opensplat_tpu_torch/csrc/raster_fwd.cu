// Tile rasterizer, forward.
//
// Replaces opensplat_tpu/ops/pallas/raster.py::_fwd_kernel (launched by
// pallas_rasterize_forward): front-to-back compositing over each 16x16
// tile's depth-sorted records (reference forward.cu:256-378), one thread
// per pixel. Per pixel: alpha = min(0.999, op * exp(-sigma)); records
// with sigma < 0 or alpha < 1/255 are skipped; the first record at which
// T * (1 - alpha) <= 1e-4 stops the pixel and is not composited, and its
// global index is the pixel's final_idx (sentinel 2^30 when the pixel
// never stops). Output: out = rgb + T * background (image layout,
// cropped), final T, and final_idx for all 256 pixels of each tile,
// padding pixels included, as the JAX kernel emits them.
// Views: the grid is V * n_tiles CTAs over V views of one image size
// (the vmapped batch axis, which Pallas maps onto the TPU kernel's
// grid). CTA b renders tile b % n_tiles of view v = b / n_tiles: its
// record range is tile_start/tile_end[b] of the one sorted stream, and
// it writes view v's image and final-T planes and background bg[v]
// (bg_stride 3; 0 shares one background). Nothing else depends on v,
// so each view's output is bit for bit that of a launch on the view
// alone.
//
// Bound on this card: the (pixel, record) arithmetic, about 20 float
// operations and one expf a pair, not bytes. Two things keep a kernel
// from it: a branch per record (sigma < 0, alpha < 1/255, the stop)
// makes each record one serial latency chain, and with one CTA per tile
// the longest tile (1563 records against a mean of 342 at 512 px) runs
// on one SM and sets the kernel's time. The design:
//  - Records go in chunks of K = 64, gathered by gauss_id straight from
//    the per-Gaussian tensors with cp.async into three packed float4s a
//    record ({x, y, A, B}, {C, op, -, -}, {r, g, b, -}): three wide
//    shared loads a record instead of nine. The next chunk's copies fly
//    while the current one computes (two buffers, one barrier a chunk);
//    the gauss_ids are loaded a chunk ahead.
//  - Each pixel computes the K records' alphas in one unrolled block
//    without branches (alpha = 0 where sigma < 0, alpha < 1/255, or past
//    the tile's end), so their independent sigma / expf chains overlap.
//    A serial pass then composites the K alphas, also without branches:
//    the stop and the pixel's done flag are selects, so the compiler can
//    interleave the pass with the alphas' tail. A record with alpha 0
//    leaves T * (1 - 0) == T, which is above 1e-4 while the pixel runs,
//    so the substitution changes no decision and no sum.
//  - A warp whose 32 pixels have all stopped skips the chunk's compute;
//    the CTA leaves once all its pixels are done (__syncthreads_count).
// One CTA of 256 threads runs each tile. The longest tile (1563 records
// against a mean of 342 at 512 px) still runs on one SM and sets about
// half of the kernel's time: splitting a tile's pixels over two or four
// CTAs was measured and bought nothing (PERF.md), since each CTA still
// replays the whole list. Shortening that chain needs the record list
// split with an exact merge of the stop, which is later work.
// Every per-pixel decision is raster_bwd.cu's replay bit for bit: the
// same osk::sigma_at, expf, threshold, clamp and stop test (the library
// builds with --fmad=false), and the colour sums round as the plain
// version's do. No atomics; the output does not depend on scheduling.
// osk_raster_fwd_info reports K, registers, shared memory and resident
// CTAs per SM.
#include "common.cuh"

namespace {

using osk::PIX;
constexpr int K = 64;     // records per chunk
constexpr int NBUF = 2;   // chunk buffers: one computing, one landing
constexpr unsigned FULL = 0xFFFFFFFFu;

__global__ void __launch_bounds__(PIX) raster_fwd_kernel(
    const int* __restrict__ tile_start, const int* __restrict__ tile_end,
    const int* __restrict__ gids, const float* __restrict__ xys,
    const float* __restrict__ conics, const float* __restrict__ opac,
    const float* __restrict__ colors, const float* __restrict__ bg,
    int bg_stride, int n_tiles, int height, int width, int tb_x,
    float* __restrict__ out_img, float* __restrict__ out_t,
    int* __restrict__ final_idx) {
  __shared__ float4 s_rec[NBUF][K][3];

  const int bt = blockIdx.x;  // tile of the views' concatenated grid
  const int v = bt / n_tiles;
  const int t = bt - v * n_tiles;
  const int tid = threadIdx.x;
  const int pix = tid;  // pixel in the tile
  const int px = (t % tb_x) * osk::BLOCK_X + pix % osk::BLOCK_X;
  const int py = (t / tb_x) * osk::BLOCK_Y + pix / osk::BLOCK_X;
  const float fpx = static_cast<float>(px);
  const float fpy = static_cast<float>(py);
  const int start = tile_start[bt];
  const int end = tile_end[bt];
  const int nch = (end - start + K - 1) / K;

  // thread tid < K gathers record tid of each chunk
  auto load_gid = [&](int c) {
    const int i = start + c * K + tid;
    return (tid < K && c < nch && i < end) ? gids[i] : -1;
  };
  auto gather = [&](int c, int gi) {
    if (tid < K) {
      float4* q = s_rec[c % NBUF][tid];
      float* d = reinterpret_cast<float*>(q);
      if (gi >= 0) {
        osk::cp_async8(d, xys + 2 * gi);
        osk::cp_async4(d + 2, conics + 3 * gi);
        osk::cp_async4(d + 3, conics + 3 * gi + 1);
        osk::cp_async4(d + 4, conics + 3 * gi + 2);
        osk::cp_async4(d + 5, opac + gi);
        osk::cp_async4(d + 8, colors + 3 * gi);
        osk::cp_async4(d + 9, colors + 3 * gi + 1);
        osk::cp_async4(d + 10, colors + 3 * gi + 2);
      } else if (c < nch) {
        // past the tile's end in its last chunk: opacity 0 gives alpha 0
        q[0] = q[1] = q[2] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
    osk::cp_commit();  // one group per chunk, empty or not
  };

  float T = 1.0f, r = 0.0f, g = 0.0f, b = 0.0f;
  int stop = osk::STOP_SENTINEL;
  bool done = false;

  gather(0, load_gid(0));
  int gid_next = load_gid(1);
  for (int c = 0; c < nch; ++c) {
    osk::cp_wait_all();  // this thread's copies of chunk c have landed
    // barrier: everyone's copies are visible and chunk c - 1 is consumed;
    // leave when every pixel of the CTA has stopped
    if (__syncthreads_count(done) == PIX) break;
    gather(c + 1, gid_next);  // into chunk c - 1's buffer
    gid_next = load_gid(c + 2);
    if (__all_sync(FULL, done)) continue;

    const float4(*rb)[3] = s_rec[c % NBUF];
    // the K records' alphas: independent, so the unrolled chains overlap
    float ar[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float4 q0 = rb[k][0];
      const float4 q1 = rb[k][1];
      const float sigma =
          osk::sigma_at(q0.z, q0.w, q1.x, q0.x - fpx, q0.y - fpy);
      const float a_raw = q1.y * expf(-sigma);
      ar[k] = (sigma >= 0.0f && a_raw >= osk::ALPHA_THRESH)
                  ? fminf(a_raw, osk::FWD_ALPHA_CLAMP) : 0.0f;
    }
    // front to back; a record with alpha 0, or past the pixel's stop,
    // leaves T and the colour sums as they are
    const int lo = start + c * K;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float a = ar[k];
      const float next_t = T * (1.0f - a);
      const bool stops = !done && next_t <= osk::T_EPS;
      stop = stops ? lo + k : stop;
      done = done || stops;
      const bool comp = !done && a > 0.0f;
      const float4 q2 = rb[k][2];
      const float vis = a * T;
      r = comp ? r + vis * q2.x : r;
      g = comp ? g + vis * q2.y : g;
      b = comp ? b + vis * q2.z : b;
      T = comp ? next_t : T;
    }
  }

  if (px < width && py < height) {
    const int64_t p =
        static_cast<int64_t>(v) * height * width + py * width + px;
    const float* bgv = bg + v * bg_stride;
    out_img[3 * p] = r + T * bgv[0];
    out_img[3 * p + 1] = g + T * bgv[1];
    out_img[3 * p + 2] = b + T * bgv[2];
    out_t[p] = T;
  }
  final_idx[static_cast<int64_t>(bt) * PIX + pix] = stop;
}

}  // namespace

OSK_API int osk_raster_fwd(int n_views, int n_tiles, const void* tile_start,
                           const void* tile_end, const void* gids,
                           const void* xys, const void* conics,
                           const void* opac, const void* colors,
                           const void* bg, int bg_stride, int height,
                           int width, int tb_x, void* out_img, void* out_t,
                           void* final_idx, void* stream) {
  if (n_views > 0 && n_tiles > 0) {
    raster_fwd_kernel<<<n_views * n_tiles, PIX, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(tile_start), static_cast<const int*>(tile_end),
        static_cast<const int*>(gids), static_cast<const float*>(xys),
        static_cast<const float*>(conics), static_cast<const float*>(opac),
        static_cast<const float*>(colors), static_cast<const float*>(bg),
        bg_stride, n_tiles, height, width, tb_x, static_cast<float*>(out_img),
        static_cast<float*>(out_t), static_cast<int*>(final_idx));
  }
  return static_cast<int>(cudaGetLastError());
}

// out[4] = {records per chunk, registers per thread, shared memory per
// CTA (bytes), resident CTAs per SM}.
OSK_API int osk_raster_fwd_info(void* out) {
  int* o = static_cast<int*>(out);
  o[0] = K;
  return osk::kernel_info(raster_fwd_kernel, PIX, 0, o + 1);
}
