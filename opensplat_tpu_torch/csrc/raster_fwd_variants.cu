// Forward rasterizer with pieces ablated: the ablation microbench.
//
// Replaces tools/kbench_raster.py::build_variant (its inner fwd_kernel,
// launched by pl.pallas_call): the JAX forward kernel's chunk loop with
// one piece removed per variant, timed to locate where a tile's time
// goes. Variants (template argument V):
//   FULL      the chunk algorithm: sigma from tile-centred quadratic
//             features, alpha = min(0.999, op * exp(-sigma)), a running
//             prefix of log1p(-alpha) per pixel, the stop test in log space
//             (logT + excl + la <= log 1e-4) and the final_idx of the stop;
//   NOMATMUL  excl = la of the record itself (no prefix over the chunk);
//   NOTRANS   no transcendentals: alpha = min(0.999, op * (1 - 0.05 sigma)),
//             la = -alpha, vis uses (1 + excl), T *= 1 + 1e-6 sum(la);
//   NOSTOP    no stop test, no final_idx and no early exit;
//   SKELETON  the chunk loop and the chunk loads only: T += x[chunk base].
//
// One CTA of 256 threads per 16x16 tile, one thread per pixel. Chunks are
// K = 256 records wide and aligned to the global record index, as in the
// JAX kernel: base0 = start - start % K, lanes outside [start, end) are
// masked, so a tile's first chunk overhangs the previous tile's tail.
// Each chunk is read contiguously by record index into shared memory (the
// JAX kernel DMAs contiguous records); the CTA turns each record into its
// six quadratic features there once, then every thread scans the chunk
// for its pixel. Per chunk a pixel keeps what the JAX variant keeps: T at
// the chunk's start, the running prefix of la (its exclusive cumulative
// sum, the JAX kernel's triangular matmul) and the done / final_idx
// flags. A pixel whose stop falls in the chunk composites nothing from
// the stop on; the CTA leaves once every pixel is done
// (__syncthreads_count), except in NOSTOP and SKELETON.
//
// Output: acc (T, 8, 256) rows [r, g, b, T, 0, 0, 0, 0] and final_idx
// (T, 256) (2^30 where a pixel never stopped).
//
// Bound on this card: the (pixel, record) pairs the chunks replay, about
// 20 float operations and two transcendentals each in FULL; the records
// are read once per tile (36 bytes each). The bench exists to measure how
// far each piece keeps the kernel from that bound.
#include "common.cuh"

namespace {

using osk::PIX;

constexpr int K = 256;  // records per chunk (the JAX kernel's K)
// float32(log(1e-4)): the JAX kernel's _LOG_T_EPS
constexpr float LOG_T_EPS = -9.210340371976182f;

enum Variant { FULL = 0, NOMATMUL = 1, NOTRANS = 2, NOSTOP = 3, SKELETON = 4 };

template <int V>
__global__ void __launch_bounds__(PIX) kbench_fwd_kernel(
    const int* __restrict__ tile_start, const int* __restrict__ tile_end,
    int n_rec, const float* __restrict__ xys,
    const float* __restrict__ conics, const float* __restrict__ opac,
    const float* __restrict__ colors, int tb_x, float* __restrict__ acc,
    int* __restrict__ final_idx) {
  // per-record quadratic features F0..F5 (FULL..NOSTOP) or the raw x
  // (SKELETON, s_f[0]); opacity and colour
  __shared__ float s_f[6][K];
  __shared__ float s_op[K], s_r[K], s_g[K], s_b[K];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int start = tile_start[t];
  const int end = tile_end[t];
  const int base0 = start - start % K;
  const int n_chunks = end > start ? (end - base0 + K - 1) / K : 0;
  const float tcx = static_cast<float>((t % tb_x) * osk::BLOCK_X) + 7.5f;
  const float tcy = static_cast<float>((t / tb_x) * osk::BLOCK_Y) + 7.5f;
  // this pixel's offsets from the tile centre, and their products
  const float qx = static_cast<float>(tid % osk::BLOCK_X) - 7.5f;
  const float qy = static_cast<float>(tid / osk::BLOCK_X) - 7.5f;
  const float qxx = qx * qx, qyy = qy * qy, qxy = qx * qy;

  float T = 1.0f, r = 0.0f, g = 0.0f, b = 0.0f;
  int stop = osk::STOP_SENTINEL;
  bool done = false;

  for (int i = 0; i < n_chunks; ++i) {
    // barrier: the previous chunk is consumed; leave when all pixels stopped
    if (V == NOSTOP || V == SKELETON) {
      __syncthreads();
    } else if (__syncthreads_count(done) == PIX) {
      break;
    }
    const int base = base0 + i * K;
    const int idx = base + tid;
    float x = 0.0f, y = 0.0f, A = 0.0f, B = 0.0f, C = 0.0f, o = 0.0f;
    float cr = 0.0f, cg = 0.0f, cb = 0.0f;
    if (idx < n_rec) {
      x = xys[2 * idx];
      y = xys[2 * idx + 1];
      A = conics[3 * idx];
      B = conics[3 * idx + 1];
      C = conics[3 * idx + 2];
      o = opac[idx];
      cr = colors[3 * idx];
      cg = colors[3 * idx + 1];
      cb = colors[3 * idx + 2];
    }
    if (V == SKELETON) {
      s_f[0][tid] = x;
      s_f[1][tid] = y;
      s_f[2][tid] = A;
      s_f[3][tid] = B;
      s_f[4][tid] = C;
    } else {
      // raster.py::_record_quad, in its operation order
      const float xr = x - tcx;
      const float yr = y - tcy;
      s_f[0][tid] = 0.5f * A;
      s_f[1][tid] = 0.5f * C;
      s_f[2][tid] = B;
      s_f[3][tid] = -(A * xr + B * yr);
      s_f[4][tid] = -(C * yr + B * xr);
      s_f[5][tid] = 0.5f * (A * xr * xr + C * yr * yr) + B * xr * yr;
    }
    s_op[tid] = o;
    s_r[tid] = cr;
    s_g[tid] = cg;
    s_b[tid] = cb;
    __syncthreads();
    if (V == SKELETON) {
      T += s_f[0][0];
      continue;
    }
    if (done) continue;  // every lane is unused for a stopped pixel

    const float t0 = T;  // T at the chunk's start (the JAX T_carry)
    const float logT = logf(fmaxf(t0, 1e-37f));
    float excl = 0.0f;  // sum of la over the composited lanes so far
    const int k_lo = max(start - base, 0);
    const int k_hi = min(end - base, K);
    for (int k = k_lo; k < k_hi; ++k) {
      // sigma = pixel_quad . record_quad, clamped at 0 (no sign test)
      float sigma = qxx * s_f[0][k] + qyy * s_f[1][k] + qxy * s_f[2][k] +
                    qx * s_f[3][k] + qy * s_f[4][k] + s_f[5][k];
      sigma = fmaxf(sigma, 0.0f);
      float alpha;
      if (V == NOTRANS) {
        alpha = fminf(osk::FWD_ALPHA_CLAMP, s_op[k] * (1.0f - 0.05f * sigma));
      } else {
        alpha = fminf(osk::FWD_ALPHA_CLAMP, s_op[k] * expf(-sigma));
      }
      if (!(alpha >= osk::ALPHA_THRESH)) continue;
      const float la = V == NOTRANS ? -alpha : log1pf(-alpha);
      const float ex = V == NOMATMUL ? la : excl;
      if (V != NOSTOP && logT + ex + la <= LOG_T_EPS) {
        stop = base + k;
        done = true;
        break;
      }
      const float vis = V == NOTRANS ? alpha * t0 * (1.0f + ex)
                                     : alpha * t0 * expf(ex);
      r += vis * s_r[k];
      g += vis * s_g[k];
      b += vis * s_b[k];
      excl += la;
    }
    T = V == NOTRANS ? t0 * (1.0f + excl * 1e-6f) : t0 * expf(excl);
  }

  float* out = acc + static_cast<size_t>(t) * 8 * PIX;
  out[0 * PIX + tid] = r;
  out[1 * PIX + tid] = g;
  out[2 * PIX + tid] = b;
  out[3 * PIX + tid] = T;
  for (int row = 4; row < 8; ++row) out[row * PIX + tid] = 0.0f;
  final_idx[t * PIX + tid] = stop;
}

}  // namespace

OSK_API int osk_kbench_fwd(int variant, int n_tiles, const void* tile_start,
                           const void* tile_end, int n_rec, const void* xys,
                           const void* conics, const void* opac,
                           const void* colors, int tb_x, void* acc,
                           void* final_idx, void* stream) {
  if (n_tiles <= 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  const auto ts = static_cast<const int*>(tile_start);
  const auto te = static_cast<const int*>(tile_end);
  const auto xy = static_cast<const float*>(xys);
  const auto co = static_cast<const float*>(conics);
  const auto op = static_cast<const float*>(opac);
  const auto cl = static_cast<const float*>(colors);
  auto out = static_cast<float*>(acc);
  auto fi = static_cast<int*>(final_idx);
  switch (variant) {
    case FULL:
      kbench_fwd_kernel<FULL><<<n_tiles, PIX, 0, s>>>(ts, te, n_rec, xy, co,
                                                      op, cl, tb_x, out, fi);
      break;
    case NOMATMUL:
      kbench_fwd_kernel<NOMATMUL><<<n_tiles, PIX, 0, s>>>(
          ts, te, n_rec, xy, co, op, cl, tb_x, out, fi);
      break;
    case NOTRANS:
      kbench_fwd_kernel<NOTRANS><<<n_tiles, PIX, 0, s>>>(
          ts, te, n_rec, xy, co, op, cl, tb_x, out, fi);
      break;
    case NOSTOP:
      kbench_fwd_kernel<NOSTOP><<<n_tiles, PIX, 0, s>>>(ts, te, n_rec, xy, co,
                                                        op, cl, tb_x, out, fi);
      break;
    case SKELETON:
      kbench_fwd_kernel<SKELETON><<<n_tiles, PIX, 0, s>>>(
          ts, te, n_rec, xy, co, op, cl, tb_x, out, fi);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
