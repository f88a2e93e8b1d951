// SSIM of a rendered (H, W, 3) image against its ground truth, and the
// gradient of the mean SSIM with respect to the rendered image, as a
// direct separable 11-tap stencil.
//
// Replaces no Pallas kernel: the JAX package's ssim (opensplat_tpu/ops/
// ssim.py) is jnp, and XLA runs its separable blur as two matmuls with
// banded H x H and W x W matrices, which the TPU's matrix unit makes the
// cheap choice. On this card those matmuls pay 2 (H + W) multiply-adds an
// output where the window needs 22; the stencil pays the 22.
//
// The window is the reference's asymmetric one (ssim.cpp:43), handed in
// by the wrapper as float32 taps g[0..10]. The blur B is a cross-
// correlation with zero padding: (B f)[i] = sum_k g[k] f[i + k - 5], taken
// along each row, then along each column. Its transpose correlates with
// the flipped window, (B^T f)[i] = sum_k g[k] f[i + 5 - k], zero outside
// the image; the backward applies it to three per-pixel fields
//   P = dS/dmu2 - 2 mu2 dS/dsigma2^2 - mu1 dS/dsigma12,
//   Q = dS/dsigma2^2, R = dS/dsigma12
// of the SSIM map S (img1 = gt, img2 = rendered), so that
//   d mean(S) / d img2 = (B^T P + 2 img2 B^T Q + img1 B^T R) / (H W 3).
// Every tap sum runs k = 0..10 in order, every float op rounds on its own
// (--fmad=false), so a pixel's values are the bits of the plain version
// (ops/kernels/ssim.py), which takes the same steps on whole slices.
//
// Bound on this card: bytes and operations alike. A view's forward
// reads both images once (24 B a pixel) and writes one partial sum per
// tile; the backward reads them again and writes the gradient (12 B): 60
// B a pixel against the 404 float32 operations a pixel and channel that
// SSIM needs, 0.0115 against 0.0116 ms at 800 x 800. The design holds the
// bytes at that floor and spends operations instead: the backward
// recomputes the forward's statistics over its tile and halo rather than
// reading nine stored floats a pixel (132 B a pixel in all). A block
// stages its tile of both images, all three channels, with the halo in
// shared memory by coalesced loads along the W * 3 row (zero outside the
// image); then, a channel at a time, blurs the five products along rows
// into shared memory and along columns from there. The backward writes
// its tile's gradient through shared memory so the stores are coalesced
// too.
//
// The forward's mean: each block sums its tile's map values in a fixed
// order (per thread, then an xor-shuffle tree, then the warps in order)
// and a one-block pass sums the partials in float64 in a fixed order. No
// atomics: a view's SSIM has the same bits on every call, alone or in a
// batch of views.
#include <atomic>

#include "common.cuh"

namespace {

constexpr int K = 11;       // taps
constexpr int RAD = K / 2;  // 5
constexpr int TH = 16;      // output rows of a tile
constexpr int TW = 32;      // output columns of a tile
constexpr int NT = 256;     // threads of a block
constexpr float C1 = 0.0001f;  // float32(0.01 ** 2)
constexpr float C2 = 0.0009f;  // float32(0.03 ** 2)
constexpr unsigned FULL = 0xffffffffu;

// forward: the inputs' tile with a 5-pixel halo
constexpr int FIR = TH + 2 * RAD, FIC = TW + 2 * RAD;
// backward: the fields need the statistics over tile + 5, which need the
// inputs over tile + 10
constexpr int BIR = TH + 4 * RAD, BIC = TW + 4 * RAD;
constexpr int BFR = TH + 2 * RAD, BFC = TW + 2 * RAD;
constexpr int BWD_ROWBUF = (5 * BIR * BFC > 3 * BFR * TW) ? 5 * BIR * BFC
                                                          : 3 * BFR * TW;
constexpr int BWD_SMEM_FLOATS =
    2 * 3 * BIR * BIC + BWD_ROWBUF + 3 * BFR * BFC + TH * TW * 3;
constexpr int BWD_SMEM = BWD_SMEM_FLOATS * 4;

struct Taps {
  float g[K];
};

// Rows r0 .. r0 + ROWS - 1, columns c0 .. c0 + COLS - 1 of an (H, W, 3)
// image into s[ch][ROWS][COLS], zero outside the image.
template <int ROWS, int COLS>
__device__ __forceinline__ void load_tile(const float* __restrict__ img,
                                          int H, int W, int r0, int c0,
                                          float* s) {
  constexpr int RC = COLS * 3;
  for (int p = threadIdx.x; p < ROWS * RC; p += NT) {
    const int r = p / RC, e = p - r * RC;
    const int c = e / 3, ch = e - c * 3;
    const int gr = r0 + r, gc = c0 + c;
    float v = 0.0f;
    if (gr >= 0 && gr < H && gc >= 0 && gc < W)
      v = __ldg(img + (static_cast<int64_t>(gr) * W + gc) * 3 + ch);
    s[(ch * ROWS + r) * COLS + c] = v;
  }
}

// Channel ch's five products (x, y, x^2, y^2, x y) blurred along rows:
// sh[q][r][c] = sum_k g[k] f_q(r, c + k) for c < COLS - 10.
template <int ROWS, int COLS>
__device__ __forceinline__ void blur_rows5(const float* sx, const float* sy,
                                           int ch, const Taps& t,
                                           float* sh) {
  constexpr int OC = COLS - 2 * RAD;
  for (int p = threadIdx.x; p < ROWS * OC; p += NT) {
    const int r = p / OC, c = p - r * OC;
    const float* px = sx + (ch * ROWS + r) * COLS + c;
    const float* py = sy + (ch * ROWS + r) * COLS + c;
    float a = px[0], b = py[0];
    float m1 = t.g[0] * a, m2 = t.g[0] * b;
    float e11 = t.g[0] * (a * a), e22 = t.g[0] * (b * b);
    float e12 = t.g[0] * (a * b);
#pragma unroll
    for (int k = 1; k < K; ++k) {
      a = px[k];
      b = py[k];
      m1 = m1 + t.g[k] * a;
      m2 = m2 + t.g[k] * b;
      e11 = e11 + t.g[k] * (a * a);
      e22 = e22 + t.g[k] * (b * b);
      e12 = e12 + t.g[k] * (a * b);
    }
    constexpr int Q = ROWS * OC;
    sh[p] = m1;
    sh[Q + p] = m2;
    sh[2 * Q + p] = e11;
    sh[3 * Q + p] = e22;
    sh[4 * Q + p] = e12;
  }
}

struct Stats {
  float mu1, mu2, e11, e22, e12;
};

// The row sums blurred along columns at (r, c): sum_k g[k] sh[q][r + k][c].
template <int ROWS, int OC>
__device__ __forceinline__ Stats blur_cols5(const float* sh, int r, int c,
                                            const Taps& t) {
  constexpr int Q = ROWS * OC;
  float v[5];
#pragma unroll
  for (int q = 0; q < 5; ++q) {
    const float* s = sh + q * Q + r * OC + c;
    float acc = t.g[0] * s[0];
#pragma unroll
    for (int k = 1; k < K; ++k) acc = acc + t.g[k] * s[k * OC];
    v[q] = acc;
  }
  return {v[0], v[1], v[2], v[3], v[4]};
}

struct MapTerms {
  float mu1, mu2, a1, a2, d1, d2;
};

__device__ __forceinline__ MapTerms map_terms(const Stats& s) {
  const float mu1_sq = s.mu1 * s.mu1;
  const float mu2_sq = s.mu2 * s.mu2;
  const float mu1_mu2 = s.mu1 * s.mu2;
  const float s11 = s.e11 - mu1_sq;
  const float s22 = s.e22 - mu2_sq;
  const float s12 = s.e12 - mu1_mu2;
  return {s.mu1, s.mu2, 2.0f * mu1_mu2 + C1, 2.0f * s12 + C2,
          (mu1_sq + mu2_sq) + C1, (s11 + s22) + C2};
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__global__ void __launch_bounds__(NT) ssim_fwd_kernel(
    int H, int W, const float* __restrict__ x, const float* __restrict__ y,
    Taps t, float* __restrict__ partials) {
  __shared__ float sx[3 * FIR * FIC];
  __shared__ float sy[3 * FIR * FIC];
  __shared__ float sh[5 * FIR * TW];
  __shared__ float red[NT / 32];
  const int r0 = blockIdx.y * TH, c0 = blockIdx.x * TW;
  load_tile<FIR, FIC>(x, H, W, r0 - RAD, c0 - RAD, sx);
  load_tile<FIR, FIC>(y, H, W, r0 - RAD, c0 - RAD, sy);
  __syncthreads();
  float acc = 0.0f;
  for (int ch = 0; ch < 3; ++ch) {
    blur_rows5<FIR, FIC>(sx, sy, ch, t, sh);
    __syncthreads();
    for (int p = threadIdx.x; p < TH * TW; p += NT) {
      const int i = p / TW, j = p - i * TW;
      if (r0 + i < H && c0 + j < W) {
        const MapTerms m = map_terms(blur_cols5<FIR, TW>(sh, i, j, t));
        acc += (m.a1 * m.a2) / (m.d1 * m.d2);
      }
    }
    __syncthreads();
  }
  acc = warp_sum(acc);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = red[0];
#pragma unroll
    for (int w = 1; w < NT / 32; ++w) s += red[w];
    partials[blockIdx.y * gridDim.x + blockIdx.x] = s;
  }
}

__global__ void __launch_bounds__(NT) ssim_mean_kernel(
    int n, const float* __restrict__ partials, double count,
    float* __restrict__ out) {
  __shared__ double s[NT];
  double a = 0.0;
  for (int i = threadIdx.x; i < n; i += NT) a += partials[i];
  s[threadIdx.x] = a;
  __syncthreads();
  for (int o = NT / 2; o > 0; o >>= 1) {
    if (threadIdx.x < o) s[threadIdx.x] += s[threadIdx.x + o];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = static_cast<float>(s[0] / count);
}

__global__ void __launch_bounds__(NT, 2) ssim_bwd_kernel(
    int H, int W, const float* __restrict__ x, const float* __restrict__ y,
    Taps t, const float* __restrict__ grad_out, float inv_count,
    float* __restrict__ grad) {
  extern __shared__ float smem[];
  float* sx = smem;                    // [3][BIR][BIC]
  float* sy = sx + 3 * BIR * BIC;      // [3][BIR][BIC]
  float* sh = sy + 3 * BIR * BIC;      // rows: [5][BIR][BFC], then [3][BFR][TW]
  float* sf = sh + BWD_ROWBUF;         // fields [3][BFR][BFC]
  float* so = sf + 3 * BFR * BFC;      // gradient tile [TH][TW][3]
  const int r0 = blockIdx.y * TH, c0 = blockIdx.x * TW;
  load_tile<BIR, BIC>(x, H, W, r0 - 2 * RAD, c0 - 2 * RAD, sx);
  load_tile<BIR, BIC>(y, H, W, r0 - 2 * RAD, c0 - 2 * RAD, sy);
  const float scale = grad_out[0] * inv_count;
  __syncthreads();
  constexpr int FQ = BFR * BFC;
  constexpr int HQ = BFR * TW;
  for (int ch = 0; ch < 3; ++ch) {
    blur_rows5<BIR, BIC>(sx, sy, ch, t, sh);
    __syncthreads();
    // the fields over the tile and its 5-pixel halo; zero outside the
    // image, where the transpose of the zero padding takes nothing
    for (int p = threadIdx.x; p < FQ; p += NT) {
      const int r = p / BFC, c = p - r * BFC;
      const int gr = r0 - RAD + r, gc = c0 - RAD + c;
      float P = 0.0f, Q = 0.0f, R = 0.0f;
      if (gr >= 0 && gr < H && gc >= 0 && gc < W) {
        const MapTerms m = map_terms(blur_cols5<BIR, BFC>(sh, r, c, t));
        const float den = m.d1 * m.d2;
        const float S = (m.a1 * m.a2) / den;
        Q = -(S / m.d2);
        R = (2.0f * m.a1) / den;
        P = ((2.0f * m.mu1) * m.a2) / den;
        P = P - ((2.0f * m.mu2) * S) / m.d1;
        P = P - (2.0f * m.mu2) * Q;
        P = P - m.mu1 * R;
      }
      sf[p] = P;
      sf[FQ + p] = Q;
      sf[2 * FQ + p] = R;
    }
    __syncthreads();
    // B^T along rows: the flipped window
    for (int p = threadIdx.x; p < HQ; p += NT) {
      const int r = p / TW, j = p - r * TW;
#pragma unroll
      for (int f = 0; f < 3; ++f) {
        const float* s = sf + f * FQ + r * BFC + j + 2 * RAD;
        float acc = t.g[0] * s[0];
#pragma unroll
        for (int k = 1; k < K; ++k) acc = acc + t.g[k] * s[-k];
        sh[f * HQ + p] = acc;
      }
    }
    __syncthreads();
    // B^T along columns, then the chain through img2^2 and img1 img2
    for (int p = threadIdx.x; p < TH * TW; p += NT) {
      const int i = p / TW, j = p - i * TW;
      float b[3];
#pragma unroll
      for (int f = 0; f < 3; ++f) {
        const float* s = sh + f * HQ + (i + 2 * RAD) * TW + j;
        float acc = t.g[0] * s[0];
#pragma unroll
        for (int k = 1; k < K; ++k) acc = acc + t.g[k] * s[-k * TW];
        b[f] = acc;
      }
      const int at = (ch * BIR + i + 2 * RAD) * BIC + j + 2 * RAD;
      const float xv = sx[at], yv = sy[at];
      so[p * 3 + ch] = ((b[0] + (2.0f * yv) * b[1]) + xv * b[2]) * scale;
    }
    __syncthreads();
  }
  for (int p = threadIdx.x; p < TH * TW * 3; p += NT) {
    const int i = p / (TW * 3), e = p - i * (TW * 3);
    if (r0 + i < H && c0 + e / 3 < W)
      grad[(static_cast<int64_t>(r0 + i) * W + c0) * 3 + e] = so[p];
  }
}

// The backward's BWD_SMEM (94 KB) passes the 48 KB a launch may take
// without asking; the attribute is set once for each device the process
// launches on (a bit a device), not on every launch.
int bwd_attr() {
  static std::atomic<uint64_t> set{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const uint64_t bit = uint64_t{1} << (dev & 63);
  if (set.load(std::memory_order_acquire) & bit) return 0;
  e = cudaFuncSetAttribute(ssim_bwd_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           BWD_SMEM);
  if (e == cudaSuccess) set.fetch_or(bit, std::memory_order_release);
  return static_cast<int>(e);
}

Taps taps_of(const void* taps) {
  Taps t;
  for (int k = 0; k < K; ++k) t.g[k] = static_cast<const float*>(taps)[k];
  return t;
}

dim3 grid_of(int H, int W) {
  return dim3(static_cast<unsigned>((W + TW - 1) / TW),
              static_cast<unsigned>((H + TH - 1) / TH));
}

}  // namespace

// Mean SSIM of img2 (rendered) against img1 (gt), both (H, W, 3) float32:
// the tile kernel writes one partial sum a tile into `partials` (ceil(H /
// 16) * ceil(W / 32) floats), the one-block pass their mean into out[0].
// `taps` is a host array of the 11 float32 window taps.
OSK_API int osk_ssim_fwd(int H, int W, const void* img1, const void* img2,
                         const void* taps, void* partials, void* out,
                         void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_of(H, W);
  ssim_fwd_kernel<<<grid, NT, 0, s>>>(
      H, W, static_cast<const float*>(img1), static_cast<const float*>(img2),
      taps_of(taps), static_cast<float*>(partials));
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ssim_mean_kernel<<<1, NT, 0, s>>>(
      static_cast<int>(grid.x * grid.y), static_cast<const float*>(partials),
      3.0 * H * W, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// d mean SSIM / d img2 times grad_out[0] (a device scalar) into grad (H,
// W, 3); inv_count is float32(1 / (H W 3)).
OSK_API int osk_ssim_bwd(int H, int W, const void* img1, const void* img2,
                         const void* taps, const void* grad_out,
                         float inv_count, void* grad, void* stream) {
  const int e = bwd_attr();
  if (e != 0) return e;
  ssim_bwd_kernel<<<grid_of(H, W), NT, BWD_SMEM,
                    static_cast<cudaStream_t>(stream)>>>(
      H, W, static_cast<const float*>(img1), static_cast<const float*>(img2),
      taps_of(taps), static_cast<const float*>(grad_out), inv_count,
      static_cast<float*>(grad));
  return static_cast<int>(cudaGetLastError());
}

// o[0..1] the tile (rows, columns); o[2..4] the forward kernel's and
// o[5..7] the backward kernel's registers, shared memory a CTA (bytes)
// and resident CTAs an SM (osk::kernel_info).
OSK_API int osk_ssim_info(void* out) {
  int* o = static_cast<int*>(out);
  o[0] = TH;
  o[1] = TW;
  int e = osk::kernel_info(ssim_fwd_kernel, NT, 0, o + 2);
  if (e != 0) return e;
  e = bwd_attr();
  if (e != 0) return e;
  return osk::kernel_info(ssim_bwd_kernel, NT, BWD_SMEM, o + 5);
}
