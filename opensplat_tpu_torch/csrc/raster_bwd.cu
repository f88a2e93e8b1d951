// Tile rasterizer, backward.
//
// Replaces opensplat_tpu/ops/pallas/raster.py::_bwd_kernel (launched by
// pallas_rasterize_backward). One CTA per 16x16 tile, one thread per
// pixel; over V views of one size (the vmapped batch axis) the grid is
// V * n_tiles, and CTA b replays tile b % n_tiles of view b / n_tiles
// against that view's planes (final T, cotangents, background bg[v] at
// bg_stride), as raster_fwd.cu does; rows go to out_index of the one
// stream, so each view's rows are those of a launch on the view alone.
// The tile replays its records back to front from its replay limit
// glim = start + min(max_p eff_p, count), eff_p = final_idx_p - start
// (count for pixels that never stopped) — the same limit as
// compact_grad_layout. T is recovered by division (T_k = T_run / (1 -
// alpha)) with the reference's 0.99 backward clamp (backward.cu:272);
// sigma and the alpha >= 1/255 test are the forward's operations
// (raster_fwd.cu), so the replay takes exactly the records the forward
// composited.
//
// Records go in chunks of K = 32:
//  1. each thread takes its pixel through the chunk in two loops: (a) the
//     alpha of every record, which depends on no running state, so the
//     fully unrolled sigma / expf chains of the K records overlap; (b)
//     back to front, carrying T_run and buf_dot, v_sigma = -op * vis *
//     v_alpha and fac = alpha * T_k (zero where the pixel does not
//     composite the record), stored in shared memory. Nothing is reduced
//     per record;
//  2. one barrier, then the nine per-record sums are taken as moments, as
//     the JAX kernel does (raster.py _BWD_MOMENTS): with qx, qy the pixel's
//     offset from the tile centre, the moments of v_sigma against
//     [1, qx, qy, qx^2, qy^2, qx*qy] and of fac against the pixel's
//     [v_r, v_g, v_b]. Lanes are on records, each warp loops over its own
//     32 pixels in a fixed order, and the eight warps' partials go to
//     shared memory;
//  3. after the next chunk's first barrier the partials are summed over
//     the warps in a fixed order and recombined per record in float32
//     with xr = x - tcx, yr = y - tcy (sum_p v_sigma dx = xr m0 - m_x,
//     ...; g_op = -m0 / max(op, 1e-12)); nonfinite sums become 0. The
//     nine terms are split over the eight warps, and each lane writes its
//     record's terms at row out_index[record] of the zero-filled output.
// So a chunk costs two barriers where the replay of one record used to
// cost a barrier and a 45-shuffle reduction tree, and every sum is taken
// in a fixed order (deterministic, no atomics). While a chunk computes,
// the next one's record fields are gathered by gauss_id with cp.async into
// a ring of three shared buffers (the third keeps the fields the delayed
// step 3 still reads); the gauss_ids of the chunk after that are loaded
// into a register a chunk ahead.
//
// Bound on this card: the (pixel, record) arithmetic (about 45 float
// operations and one expf per pair), not bytes. The design takes the
// per-record reduction off that path (step 2 is ~16 instructions per
// (pixel, record) slot against ~50 in step 1) and lets step 1's records
// overlap. What remains is the longest tile: its replay runs on one CTA,
// and on the main path it takes most of the kernel's time (chip_smoke.py
// prints the tile balance). Records past the replay limit are not written
// (the caller zero-fills). Shared memory per CTA: 2 x K x 257 x 4 B of
// values ([record][pixel] rows padded by one float, conflict-free both
// ways) plus the field ring, the warps' partials and the pixels'
// cotangents, ~82 KB at K = 32, so two CTAs stay resident per SM;
// osk_raster_bwd_info reports K, registers, shared memory and resident
// CTAs from the runtime. The library builds with --fmad=false (the
// forward's decisions must be reproduced bit for bit); the moment sums and
// the gradient terms use explicit fmaf, which contracts regardless of
// that flag.
#include "common.cuh"

namespace {

using osk::PIX;
constexpr int NWARP = PIX / 32;
constexpr int NM = 9;   // moments per record
constexpr int NFB = 3;  // record-field buffers in the prefetch ring
constexpr int K = 32;   // records per chunk: one per lane in step 2

// [record][pixel] buffers padded to PIX + 1 floats a row: the writes (a
// warp's 32 pixels, one record) and the reads of step 2 (lanes on
// records, one pixel per warp) hit 32 distinct banks.
constexpr int ROW = PIX + 1;

struct Smem {
  float vs[K * ROW];         // v_sigma
  float fac[K * ROW];        // fac
  float4 rec[NFB][K][3];     // x y A B | C op r g | b - - -
  float red[NWARP][NM][K];   // per-warp moment partials
  float4 vrgb[PIX];          // the pixel's v_r, v_g, v_b
};

// Thread t copies field t % 8 of record t / 8 of a chunk (8 copies per
// record: xy as one 8-byte copy, A, B, C, opacity, r, g, b).
__device__ __forceinline__ void gather_field(float4* rec3, int f, int gi,
                                             const float* xys,
                                             const float* conics,
                                             const float* opac,
                                             const float* colors) {
  float* r = reinterpret_cast<float*>(rec3);
  switch (f) {
    case 0: osk::cp_async8(r + 0, xys + 2 * gi); break;
    case 1: osk::cp_async4(r + 2, conics + 3 * gi); break;
    case 2: osk::cp_async4(r + 3, conics + 3 * gi + 1); break;
    case 3: osk::cp_async4(r + 4, conics + 3 * gi + 2); break;
    case 4: osk::cp_async4(r + 5, opac + gi); break;
    case 5: osk::cp_async4(r + 6, colors + 3 * gi); break;
    case 6: osk::cp_async4(r + 7, colors + 3 * gi + 1); break;
    default: osk::cp_async4(r + 8, colors + 3 * gi + 2); break;
  }
}

// 1 / x for x in [0.01, 1] (x = 1 - alpha, alpha clamped to 0.99):
// the hardware reciprocal and one Newton step, without the special-case
// branch of the IEEE division (no zero, denormal or infinity can occur),
// within an ulp of it; 1 / 1 is exactly 1.
__device__ __forceinline__ float recip_unit(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return fmaf(r, fmaf(-x, r, 1.0f), r);
}

__device__ __forceinline__ float finite_or_zero(float v) {
  return isfinite(v) ? v : 0.0f;
}

__global__ void __launch_bounds__(PIX, 2) raster_bwd_kernel(
    const int* __restrict__ tile_start, const int* __restrict__ tile_end,
    const int* __restrict__ gids, const float* __restrict__ xys,
    const float* __restrict__ conics, const float* __restrict__ opac,
    const float* __restrict__ colors, const float* __restrict__ bg,
    const float* __restrict__ final_t, const int* __restrict__ final_idx,
    const float* __restrict__ v_img, const float* __restrict__ v_ft,
    const int* __restrict__ out_index, int bg_stride, int n_tiles,
    int height, int width, int tb_x, float* __restrict__ grads) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& S = *reinterpret_cast<Smem*>(smem_raw);
  __shared__ int s_eff;

  const int bt = blockIdx.x;  // tile of the views' concatenated grid
  const int v = bt / n_tiles;
  const int t = bt - v * n_tiles;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx0 = (t % tb_x) * osk::BLOCK_X;
  const int ty0 = (t / tb_x) * osk::BLOCK_Y;
  const int px = tx0 + tid % osk::BLOCK_X;
  const int py = ty0 + tid / osk::BLOCK_X;
  const bool inside = px < width && py < height;
  const float fpx = static_cast<float>(px);
  const float fpy = static_cast<float>(py);
  const float tcx = static_cast<float>(tx0) + 0.5f * (osk::BLOCK_X - 1);
  const float tcy = static_cast<float>(ty0) + 0.5f * (osk::BLOCK_Y - 1);
  const int start = tile_start[bt];
  const int count = tile_end[bt] - start;

  const int fidx = final_idx[static_cast<int64_t>(bt) * PIX + tid];
  const int eff = fidx >= osk::STOP_SENTINEL ? count : fidx - start;
  if (tid == 0) s_eff = 0;
  __syncthreads();
  atomicMax(&s_eff, eff);  // max is order-free: deterministic
  __syncthreads();
  const int glim = start + min(s_eff, count);
  const int nch = glim > start ? (glim - start + K - 1) / K : 0;

  // padding pixels carry zero cotangents and so add exactly zero
  float T_run = 1.0f, vr = 0.0f, vg = 0.0f, vb = 0.0f, vob = 0.0f;
  if (inside) {
    const int64_t p =
        static_cast<int64_t>(v) * height * width + py * width + px;
    const float* bgv = bg + v * bg_stride;
    T_run = final_t[p];
    vr = v_img[3 * p];
    vg = v_img[3 * p + 1];
    vb = v_img[3 * p + 2];
    const float bg_dot = vr * bgv[0] + vg * bgv[1] + vb * bgv[2];
    vob = T_run * (v_ft[p] + bg_dot);
  }
  S.vrgb[tid] = make_float4(vr, vg, vb, 0.0f);
  float buf_dot = 0.0f;  // sum over later records of fac * (colour . v_rgb)

  // the gather: thread tid copies field tid % 8 of record tid / 8
  const int g_rec = tid >> 3;
  const int g_fld = tid & 7;
  const bool gatherer = g_rec < K;
  auto chunk_lo = [&](int c) { return max(start, glim - (c + 1) * K); };
  auto chunk_n = [&](int c) { return glim - c * K - chunk_lo(c); };
  auto load_gid = [&](int c) {
    return (gatherer && c < nch && g_rec < chunk_n(c))
               ? gids[chunk_lo(c) + g_rec] : -1;
  };
  auto gather = [&](int c, int gi) {
    if (gi >= 0)
      gather_field(S.rec[c % NFB][g_rec], g_fld, gi, xys, conics, opac,
                   colors);
    osk::cp_commit();  // one group per chunk, empty or not
  };
  gather(0, load_gid(0));
  int gid_next = load_gid(1);

  // step 2: lane = record, pixels 32 * warp + i (rows 2 * warp and
  // 2 * warp + 1 of the tile)
  const int p2 = 32 * warp;
  const float qy0 = static_cast<float>(2 * warp) - 0.5f * (osk::BLOCK_Y - 1);
  // records at or past this pixel's stop (all of them for padding
  // pixels) are not composited: stream index < fidx_eff
  const int fidx_eff = inside ? fidx : 0;

  // step 3 of the previous chunk: this lane's record's row, chunk length
  int oidx = 0, n_prev = 0;

  auto finalize = [&](int c) {
    const int k = lane;
    if (k >= n_prev) return;
    auto msum = [&](int j) {
      float s = 0.0f;
#pragma unroll
      for (int w8 = 0; w8 < NWARP; ++w8) s += S.red[w8][j][k];
      return s;
    };
    const float4 q0 = S.rec[c % NFB][k][0];
    const float4 q1 = S.rec[c % NFB][k][1];
    const float xr = q0.x - tcx, yr = q0.y - tcy;
    const float A = q0.z, B = q0.w, C = q1.x, op = q1.y;
    float* row = grads + static_cast<int64_t>(oidx) * NM;
    switch (warp) {
      case 0: {  // v_x, v_y
        const float m0 = msum(0);
        const float sx = xr * m0 - msum(1);
        const float sy = yr * m0 - msum(2);
        row[0] = finite_or_zero(A * sx + B * sy);
        row[1] = finite_or_zero(B * sx + C * sy);
        break;
      }
      case 1: {  // v_A
        const float m0 = msum(0), mx = msum(1), mxx = msum(3);
        row[2] = finite_or_zero(0.5f * (xr * xr * m0 - 2.0f * xr * mx + mxx));
        break;
      }
      case 2: {  // v_B
        const float m0 = msum(0), mx = msum(1), my = msum(2), mxy = msum(5);
        row[3] = finite_or_zero(
            0.5f * (xr * yr * m0 - xr * my - yr * mx + mxy));
        break;
      }
      case 3: {  // v_C
        const float m0 = msum(0), my = msum(2), myy = msum(4);
        row[4] = finite_or_zero(0.5f * (yr * yr * m0 - 2.0f * yr * my + myy));
        break;
      }
      case 4:  // v_opacity
        row[5] = finite_or_zero(-msum(0) / fmaxf(op, 1e-12f));
        break;
      default:  // v_r, v_g, v_b
        row[warp + 1] = finite_or_zero(msum(warp + 1));
        break;
    }
  };

  for (int c = 0; c < nch; ++c) {
    gather(c + 1, gid_next);
    gid_next = load_gid(c + 2);
    osk::cp_wait_group<1>();  // this thread's copies of chunk c have landed
    __syncthreads();        // B1: everyone's; the partials of chunk c - 1
    if (c > 0) finalize(c - 1);

    // step 1a: this pixel's alpha before the clamp for each record, 0
    // where it does not composite the record. The records are independent
    // here (no running state), so the unrolled sigma / expf chains overlap.
    const int lo = chunk_lo(c);
    const int n = chunk_n(c);
    const float4* rb = &S.rec[c % NFB][0][0];
    const int kstop = fidx_eff - lo;
    float ar[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      // no branch: slots past the chunk's end read stale fields and are
      // masked, so the K records form one block the compiler interleaves
      const float4 q0 = rb[3 * k];
      const float4 q1 = rb[3 * k + 1];
      const float sigma =
          osk::sigma_at(q0.z, q0.w, q1.x, q0.x - fpx, q0.y - fpy);
      const float a_raw = q1.y * expf(-sigma);
      ar[k] = (k < n && k < kstop && sigma >= 0.0f &&
               a_raw >= osk::ALPHA_THRESH) ? a_raw : 0.0f;
    }
    // step 1b: back to front, carrying T_run and buf_dot; a record not
    // composited has alpha 0, so fac = 0 and the state stays.
    // v_sigma = -op * vis * v_alpha = -a_raw * v_alpha (-op * vis rounds
    // to -a_raw).
#pragma unroll
    for (int k = K - 1; k >= 0; --k) {
      const float alpha = fminf(ar[k], osk::BWD_ALPHA_CLAMP);
      const float ra = recip_unit(1.0f - alpha);
      const float T_k = T_run * ra;  // transmittance before this record
      const float fc = alpha * T_k;
      const float4 q1 = rb[3 * k + 1];
      const float w = fmaf(q1.z, vr, fmaf(q1.w, vg, rb[3 * k + 2].x * vb));
      const float v_alpha = fmaf(T_k, w, -ra * (buf_dot + vob));
      const bool used = ar[k] > 0.0f;
      S.vs[k * ROW + tid] = used ? -ar[k] * v_alpha : 0.0f;
      S.fac[k * ROW + tid] = fc;
      buf_dot = used ? fmaf(fc, w, buf_dot) : buf_dot;
      T_run = used ? T_k : T_run;
    }
    oidx = lane < n ? out_index[lo + lane] : 0;
    n_prev = n;
    __syncthreads();  // B2: the chunk's values are in shared memory

    // step 2: moments, lanes on records, this warp's 32 pixels in order
    float m[NM];
#pragma unroll
    for (int j = 0; j < NM; ++j) m[j] = 0.0f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int p = p2 + i;
      const float v = S.vs[lane * ROW + p];
      const float f = S.fac[lane * ROW + p];
      const float4 vc = S.vrgb[p];
      const float qx = static_cast<float>(i & 15) - 0.5f * (osk::BLOCK_X - 1);
      const float qy = qy0 + static_cast<float>(i >> 4);
      const float tx = qx * v;
      const float ty = qy * v;
      m[0] += v;
      m[1] += tx;
      m[2] += ty;
      m[3] = fmaf(qx, tx, m[3]);
      m[4] = fmaf(qy, ty, m[4]);
      m[5] = fmaf(qx, ty, m[5]);
      m[6] = fmaf(vc.x, f, m[6]);
      m[7] = fmaf(vc.y, f, m[7]);
      m[8] = fmaf(vc.z, f, m[8]);
    }
#pragma unroll
    for (int j = 0; j < NM; ++j) S.red[warp][j][lane] = m[j];
  }
  if (nch > 0) {
    __syncthreads();
    finalize(nch - 1);
  }
}

}  // namespace

OSK_API int osk_raster_bwd(int n_views, int n_tiles, const void* tile_start,
                           const void* tile_end, const void* gids,
                           const void* xys, const void* conics,
                           const void* opac, const void* colors,
                           const void* bg, const void* final_t,
                           const void* final_idx, const void* v_img,
                           const void* v_ft, const void* out_index,
                           int bg_stride, int height, int width, int tb_x,
                           void* grads, void* stream) {
  if (n_views <= 0 || n_tiles <= 0)
    return static_cast<int>(cudaGetLastError());
  const int smem = static_cast<int>(sizeof(Smem));
  cudaError_t e = cudaFuncSetAttribute(
      raster_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  raster_bwd_kernel<<<n_views * n_tiles, PIX, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tile_start), static_cast<const int*>(tile_end),
      static_cast<const int*>(gids), static_cast<const float*>(xys),
      static_cast<const float*>(conics), static_cast<const float*>(opac),
      static_cast<const float*>(colors), static_cast<const float*>(bg),
      static_cast<const float*>(final_t), static_cast<const int*>(final_idx),
      static_cast<const float*>(v_img), static_cast<const float*>(v_ft),
      static_cast<const int*>(out_index), bg_stride, n_tiles, height, width,
      tb_x, static_cast<float*>(grads));
  return static_cast<int>(cudaGetLastError());
}

// out[4] = {K, registers per thread, shared memory per CTA (bytes),
// resident CTAs per SM}.
OSK_API int osk_raster_bwd_info(void* out) {
  int* o = static_cast<int*>(out);
  const int smem = static_cast<int>(sizeof(Smem));
  const cudaError_t e = cudaFuncSetAttribute(
      raster_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  o[0] = K;
  return osk::kernel_info(raster_bwd_kernel, PIX, smem, o + 1);
}
