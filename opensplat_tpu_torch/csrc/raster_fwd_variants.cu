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
//   SKELETON  the chunk loop and its loads only: T += x[chunk base].
// What each computes is the JAX variant's: chunks of K = 256 records
// aligned to the global record index, lanes outside [start, end) masked,
// T folded (T = T_chunk * exp(sum of the composited la)) and log T taken
// again only at a chunk's end; a pixel stops at the first used record
// that passes the test, composites nothing from there on and keeps that
// record's global index as final_idx.
//
// Bound on this card: the issue rate. The records sit in L2 (the bench's
// 40 MB stream) and a pair needs ~20 float operations and two or three
// transcendentals, but a warp spends far more instructions than that on
// each (warp, record) step. The first port of this kernel (256-record
// chunks, ten scalar shared loads, a branch per record and pixel) ran 39
// instructions on a record none of the warp's pixels uses and 102 on one
// that some pixel composites (its inner loop in SASS,
// tools/sass_report.py), over 3.13M (warp, record) steps on the bench's
// stream, 1.38M of them used: 209M instructions, 0.200 ms at 4 a clock on
// 132 SMs at 1980 MHz, against 0.285 ms measured (H100 80GB HBM3, 700 W).
// This kernel takes 28.6 instructions an alpha step, ~4 for the vote and
// ~53 more on a voted record, over 1.76M alpha steps and 1.38M voted
// ones: 130M instructions, 0.125 ms at the issue rate, against 0.186 ms
// measured (PERF.md). The design cuts the steps and the instructions per
// step:
//  - Records go in the JAX chunks of K = 256, aligned to the global
//    record index, so T folds between chunks. A chunk is contiguous in
//    each tensor (no gauss_id gather), so it lands by 576 16-byte
//    cp.async copies (zero-filled past the stream's end) into one of two
//    buffers; the next chunk's copies fly while this one computes.
//    Chunks of 64 and 128 ran slower (PERF.md): more barriers and
//    padded blocks, while the longer overhang costs copies only.
//  - The CTA turns each landed record into its quadratic features once,
//    as three float4s ({f0, f1, f2, f3}, {f4, f5, op, -}, {r, g, b, -}),
//    and into a warp mask: the warps whose two pixel rows its alpha can
//    reach above 1/255 (warp_mask, exact: a record it drops has alpha
//    below 1/255 at every pixel of that warp). A record outside
//    [start, end) reaches no warp, so the overhang into the previous
//    tile costs copies only. A second barrier publishes them; each warp
//    then lists, in order, the records its bit keeps (ballot and popc).
//  - A warp computes the alphas of its listed records in unrolled,
//    branch-free blocks of G = 8 (three broadcast shared loads a record;
//    alpha 0 where the JAX `used` is false; the list is padded with a
//    zero record), so their sigma / expf chains overlap.
//  - A warp-uniform vote per record then skips log1pf, the stop test,
//    expf(excl) and the colour sums of a record that no pixel of the warp
//    uses: a skipped record has la = 0 and leaves excl as it is; `used`
//    stays explicit in the stop select, so an unused record never stops
//    a pixel. The rest is branch-free selects.
//  - A warp whose 32 pixels have stopped skips the rest of the
//    chunk; the CTA leaves once all its pixels are done
//    (__syncthreads_count), except in NOSTOP and SKELETON.
//  - 64 registers a thread, so four CTAs share an SM: 32 warps hide the
//    chain of each voted record (64-alpha blocks at 127 registers and
//    two CTAs ran 0.37-0.39 ms).
// One CTA of 256 threads per 16x16 tile, one thread per pixel. Output:
// acc (T, 8, 256) rows [r, g, b, T, 0, 0, 0, 0] and final_idx (T, 256)
// (2^30 where a pixel never stopped). The four record tensors must be
// 16-byte aligned (the wrapper checks). osk_kbench_fwd_info reports K, G,
// registers, shared memory and resident CTAs per SM of FULL.
#include "common.cuh"

namespace {

using osk::PIX;

constexpr int K = 256;  // records per chunk (the JAX kernel's K)
constexpr int G = 8;    // records per alpha block
constexpr int CTAS = 4;  // resident CTAs per SM the registers must allow
constexpr unsigned ALL = 0xFFFFFFFFu;
// float32(log(1e-4)): the JAX kernel's _LOG_T_EPS
constexpr float LOG_T_EPS = -9.210340371976182f;

enum Variant { FULL = 0, NOMATMUL = 1, NOTRANS = 2, NOSTOP = 3, SKELETON = 4 };

static_assert(K == PIX, "one thread per record of a chunk");

// One chunk as it lands: contiguous slices of the four tensors.
struct Raw {
  float xy[2 * K];
  float con[3 * K];
  float op[K];
  float col[3 * K];
};
constexpr int N16 = static_cast<int>(sizeof(Raw)) / 16;  // copies a chunk

// Copies the piece-th 16 bytes (piece < N16) of the chunk at global
// record sb; bytes past a tensor's end are zero-filled, never read.
__device__ __forceinline__ void copy_piece(Raw* dst, int piece, int sb,
                                          int n_rec, const float* xys,
                                          const float* conics,
                                          const float* opac,
                                          const float* colors) {
  constexpr int P_XY = 2 * K / 4, P_CON = 3 * K / 4, P_OP = K / 4;
  const float* src;
  float* d;
  int off, n;
  if (piece < P_XY) {
    src = xys, d = dst->xy, off = 2 * sb, n = 2 * n_rec;
  } else if (piece < P_XY + P_CON) {
    piece -= P_XY;
    src = conics, d = dst->con, off = 3 * sb, n = 3 * n_rec;
  } else if (piece < P_XY + P_CON + P_OP) {
    piece -= P_XY + P_CON;
    src = opac, d = dst->op, off = sb, n = n_rec;
  } else {
    piece -= P_XY + P_CON + P_OP;
    src = colors, d = dst->col, off = 3 * sb, n = 3 * n_rec;
  }
  off += 4 * piece;
  const int bytes = min(max(n - off, 0), 4) * 4;
  osk::cp_async16(d + 4 * piece, bytes > 0 ? src + off : src, bytes);
}

// The warps (bit w: pixel rows 2w and 2w + 1 of the tile) that a record
// can reach with alpha >= 1/255, from its tile-centred position (xr, yr):
// the bounding box of its ellipse sigma <= s_max + 0.5, widened by 0.1
// pixel, against the tile's columns and each warp's rows. s_max is where
// alpha falls to 1/255 (op exp(-s) or op (1 - 0.05 s)). The margins are
// ten times the rounding of the kernel's sigma (under 0.05) and of the
// box for the conics it accepts (positive A and C up to 1000,
// A C - B^2 >= A C / 100); any other record reaches every warp. A record
// with op < 1/255 reaches none (alpha <= op).
template <int V>
__device__ __forceinline__ unsigned warp_mask(float xr, float yr, float A,
                                              float B, float C, float op) {
  if (op < osk::ALPHA_THRESH) return 0u;
  const float det = A * C - B * B;
  if (!(A > 0.0f && C > 0.0f && A <= 1000.0f && C <= 1000.0f &&
        det >= 0.01f * A * C && op <= 1e30f && fabsf(xr) <= 1e30f &&
        fabsf(yr) <= 1e30f)) {
    return 0xFFu;
  }
  const float s = 0.5f + (V == NOTRANS ? 20.0f * (1.0f - 1.0f / (255.0f * op))
                                       : logf(255.0f * op));
  const float ex = sqrtf(2.0f * s * C / det) + 0.1f;
  const float ey = sqrtf(2.0f * s * A / det) + 0.1f;
  if (xr - ex > 7.5f || xr + ex < -7.5f) return 0u;
  const float lo = ceilf((yr - ey + 6.5f) * 0.5f);
  const float hi = floorf((yr + ey + 7.5f) * 0.5f);
  if (lo > 7.0f || hi < 0.0f || lo > hi) return 0u;
  const int l = static_cast<int>(fmaxf(lo, 0.0f));
  const int h = static_cast<int>(fminf(hi, 7.0f));
  return ((2u << h) - 1u) & ~((1u << l) - 1u);
}

template <int V>
__global__ void __launch_bounds__(PIX, CTAS) kbench_fwd_kernel(
    const int* __restrict__ tile_start, const int* __restrict__ tile_end,
    int n_rec, const float* __restrict__ xys,
    const float* __restrict__ conics, const float* __restrict__ opac,
    const float* __restrict__ colors, int tb_x, float* __restrict__ acc,
    int* __restrict__ final_idx) {
  __shared__ __align__(16) Raw s_raw[2];
  // the chunk's features, and a zero record (op 0) after them
  __shared__ float4 s_feat[K + 1][3];
  __shared__ unsigned char s_mask[K];  // warp_mask of each record
  // per warp, the records its mask keeps, in order, padded with the zero
  // record to a whole alpha block
  __shared__ unsigned short s_list[PIX / 32][K + G];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int start = tile_start[t];
  const int end = tile_end[t];
  const int sb0 = start - start % K;
  const int n_chunks = end > start ? (end - sb0 + K - 1) / K : 0;
  const float tcx = static_cast<float>((t % tb_x) * osk::BLOCK_X) + 7.5f;
  const float tcy = static_cast<float>((t / tb_x) * osk::BLOCK_Y) + 7.5f;
  // this pixel's offsets from the tile centre, and their products
  const float qx = static_cast<float>(tid % osk::BLOCK_X) - 7.5f;
  const float qy = static_cast<float>(tid / osk::BLOCK_X) - 7.5f;
  const float qxx = qx * qx, qyy = qy * qy, qxy = qx * qy;

  // per pixel: T at the chunk's start (the JAX T_carry), its log, and
  // the sum of la over the records composited since
  float t0 = 1.0f, logT = 0.0f, excl = 0.0f;
  float T = 1.0f, r = 0.0f, g = 0.0f, b = 0.0f;
  int stop = osk::STOP_SENTINEL;
  bool done = false;

  if (tid < 3) s_feat[K][tid] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (n_chunks > 0) {
    for (int i = tid; i < N16; i += PIX) {
      copy_piece(&s_raw[0], i, sb0, n_rec, xys, conics, opac, colors);
    }
  }
  osk::cp_commit();
  for (int c = 0; c < n_chunks; ++c) {
    const int sb = sb0 + c * K;
    osk::cp_wait_all();  // this thread's copies of chunk c have landed
    // barrier: everyone's copies are visible, the features of c - 1 are
    // consumed; leave when every pixel of the CTA has stopped
    if (V == NOSTOP || V == SKELETON) {
      __syncthreads();
    } else if (__syncthreads_count(done) == PIX) {
      break;
    }
    if (c + 1 < n_chunks) {  // into the buffer c - 1 landed in
      for (int i = tid; i < N16; i += PIX) {
        copy_piece(&s_raw[(c + 1) % 2], i, sb + K, n_rec, xys, conics, opac,
                   colors);
      }
    }
    osk::cp_commit();
    const Raw& raw = s_raw[c % 2];
    if (V == SKELETON) {  // x of the chunk's first record
      T += raw.xy[0];
      continue;
    }

    {  // record sb + tid: raster.py::_record_quad's order
      float4 q0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), q1 = q0, q2 = q0;
      unsigned mask = 0u;
      const int gk = sb + tid;
      if (gk >= start && gk < end) {
        const float2 xy = reinterpret_cast<const float2*>(raw.xy)[tid];
        const float A = raw.con[3 * tid], B = raw.con[3 * tid + 1],
                    C = raw.con[3 * tid + 2];
        const float xr = xy.x - tcx;
        const float yr = xy.y - tcy;
        q0 = make_float4(0.5f * A, 0.5f * C, B, -(A * xr + B * yr));
        q1 = make_float4(-(C * yr + B * xr),
                         0.5f * (A * xr * xr + C * yr * yr) + B * xr * yr,
                         raw.op[tid], 0.0f);
        q2 = make_float4(raw.col[3 * tid], raw.col[3 * tid + 1],
                         raw.col[3 * tid + 2], 0.0f);
        mask = warp_mask<V>(xr, yr, A, B, C, raw.op[tid]);
      }
      s_feat[tid][0] = q0;
      s_feat[tid][1] = q1;
      s_feat[tid][2] = q2;
      s_mask[tid] = static_cast<unsigned char>(mask);
    }
    __syncthreads();

    if (c > 0) {  // a chunk ended: fold T
      T = V == NOTRANS ? t0 * (1.0f + excl * 1e-6f) : t0 * expf(excl);
      t0 = T;
      logT = logf(fmaxf(t0, 1e-37f));
      excl = 0.0f;
    }
    if (V != NOSTOP && __all_sync(ALL, done)) continue;

    // this warp's list: the records its mask bit keeps, in order
    const int w = tid / 32, lane = tid % 32;
    unsigned short* list = s_list[w];
    const unsigned below = (1u << lane) - 1u;
    int n_w = 0;
#pragma unroll
    for (int i = 0; i < K; i += 32) {
      const bool in = (s_mask[i + lane] >> w) & 1u;
      const unsigned bits = __ballot_sync(ALL, in);
      if (in) list[n_w + __popc(bits & below)] = i + lane;
      n_w += __popc(bits);
    }
    if (lane < G) list[n_w + lane] = K;
    __syncwarp();

#pragma unroll 1
    for (int k0 = 0; k0 < n_w; k0 += G) {
      if (V != NOSTOP && __all_sync(ALL, done)) break;
      // the block's alphas: independent, so the unrolled chains overlap
      float a[G];
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const int k = list[k0 + j];
        const float4 q0 = s_feat[k][0];
        const float4 q1 = s_feat[k][1];
        // sigma = pixel_quad . record_quad, clamped at 0 (no sign test)
        float sigma = qxx * q0.x + qyy * q0.y + qxy * q0.z + qx * q0.w +
                      qy * q1.x + q1.y;
        sigma = fmaxf(sigma, 0.0f);
        const float alpha =
            V == NOTRANS
                ? fminf(osk::FWD_ALPHA_CLAMP, q1.z * (1.0f - 0.05f * sigma))
                : fminf(osk::FWD_ALPHA_CLAMP, q1.z * expf(-sigma));
        a[j] = alpha >= osk::ALPHA_THRESH ? alpha : 0.0f;
      }
      // in order; a record no pixel of the warp uses is skipped
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const bool used = a[j] > 0.0f && !done;
        if (!__any_sync(ALL, used)) continue;
        const int k = list[k0 + j];
        const float al = a[j];
        const float la = V == NOTRANS ? -al : log1pf(-al);
        const float ex = V == NOMATMUL ? la : excl;
        const bool stops =
            V != NOSTOP && used && logT + ex + la <= LOG_T_EPS;
        stop = stops ? sb + k : stop;
        done = done || stops;
        const bool comp = used && !stops;
        const float vis = V == NOTRANS ? al * t0 * (1.0f + ex)
                                       : al * t0 * expf(ex);
        const float4 q2 = s_feat[k][2];
        r = comp ? r + vis * q2.x : r;
        g = comp ? g + vis * q2.y : g;
        b = comp ? b + vis * q2.z : b;
        excl = comp ? excl + la : excl;
      }
    }
  }
  if (V != SKELETON) {
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
  decltype(&kbench_fwd_kernel<FULL>) kernel;
  switch (variant) {
    case FULL: kernel = kbench_fwd_kernel<FULL>; break;
    case NOMATMUL: kernel = kbench_fwd_kernel<NOMATMUL>; break;
    case NOTRANS: kernel = kbench_fwd_kernel<NOTRANS>; break;
    case NOSTOP: kernel = kbench_fwd_kernel<NOSTOP>; break;
    case SKELETON: kernel = kbench_fwd_kernel<SKELETON>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  kernel<<<n_tiles, PIX, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tile_start), static_cast<const int*>(tile_end),
      n_rec, static_cast<const float*>(xys), static_cast<const float*>(conics),
      static_cast<const float*>(opac), static_cast<const float*>(colors), tb_x,
      static_cast<float*>(acc), static_cast<int*>(final_idx));
  return static_cast<int>(cudaGetLastError());
}

// out[5] = {records per chunk, records per alpha block, registers per
// thread, shared memory per CTA (bytes), resident CTAs per SM} of FULL.
OSK_API int osk_kbench_fwd_info(void* out) {
  int* o = static_cast<int*>(out);
  o[0] = K;
  o[1] = G;
  return osk::kernel_info(kbench_fwd_kernel<FULL>, PIX, 0, o + 2);
}
