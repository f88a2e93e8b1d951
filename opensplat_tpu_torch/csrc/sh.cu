// The render's spherical-harmonic colours, forward, and the gradient of
// the coefficients derived by hand, one thread per (view, row).
//
// Replaces no Pallas kernel: the JAX package's SH (opensplat_tpu/ops/
// sh.py) is jnp, which XLA fuses on the TPU. In PyTorch the same function
// (ops/sh.py::render_colours_plain, the plain version) is the view
// directions, a `cat` of features_dc and features_rest into a fresh (N,
// B, 3) tensor, ~30 elementwise passes that stack the (N, B) basis, and a
// cuBLAS gemv a view; autograd's backward adds a 32 x 32 GEMM (the outer
// product of the basis and the colour gradient) and hands the two
// coefficient gradients back as views into the `cat`'s gradient.
//
// The math of a (view, row) is csrc/sh_row.cuh: the direction and the
// basis the plain version's operations one for one, each float op
// rounded on its own (--fmad=false), the sum over the bases a chain of
// fused multiply-adds in index order.
//
// Inputs: means (3 floats a row at a row stride of its own, one state's
// rows for every view or a state a view), the views' camera centres
// (views, 3), and features_dc (3 floats a row) and features_rest (3 (B -
// 1) floats a row), each state's rows consecutive, one state or a state
// a view; B in {1, 4, 9, 16, 25} is a template parameter, n_used <= B the
// bases used. The forward writes rgb (views, N, 3) and the clamp's mask
// (views, N), 3 bits a byte, for the backward, which reads the colour
// gradient (3 floats a row at a row stride of its own), the means and
// the mask, and writes the gradients of features_dc and features_rest,
// (states, N, ...): a state a view, or one state for every view, whose
// gradient is the sum of the views' in view order (no atomics).
//
// Bound on this card: bytes. At B = 16 a (view, row) of the forward reads
// the mean (12 B), features_dc (12 B) and features_rest (180 B) and
// writes its colour (12 B) and mask (1 B); the backward reads the colour
// gradient, the mean and the mask (25 B) and writes the coefficients'
// gradients (192 B): ~434 B a row against ~150 float32 operations, 0.75
// ms at 3.35 TB/s for garden's 5,803,008 rows. A features_rest row is
// 180 B, not a multiple of 16, so a thread that read its own row would
// make strided, uncoalesced loads. The design moves each byte once and
// coalesced: a block takes NT consecutive rows of one view (grid y is the
// view), copies their coefficients, consecutive in memory, into shared
// memory with 16-byte asynchronous copies while each thread computes its
// row's basis, then each thread contracts its row from shared memory.
// The backward keeps no coefficient: it recomputes the basis from the
// mean, fills its block's gradient rows in shared memory and writes them
// back with 16-byte stores.
#include "common.cuh"
#include "sh_row.cuh"

namespace {

constexpr int NT = 128;  // threads (rows) of a block

// The entries' host arrays, in the order ops/kernels/sh.py's _SH passes
// them.
enum FwdPtr { FP_MEANS, FP_CAM, FP_DC, FP_REST, FP_RGB, FP_MASK };
enum BwdPtr { BP_MEANS, BP_CAM, BP_MASK, BP_G, BP_V_DC, BP_V_REST };
enum FwdInt { FI_N, FI_VIEWS, FI_B, FI_N_USED, FI_S_MEANS, FI_VS_MEANS,
              FI_VS_DC, FI_VS_REST };
enum BwdInt { BI_N, BI_VIEWS, BI_STATES, BI_B, BI_N_USED, BI_S_MEANS,
              BI_VS_MEANS, BI_S_G };

struct FwdArgs {
  const float* means;
  const float* cam;
  const float* dc;
  const float* rest;
  float* rgb;
  uint8_t* mask;
  int64_t s_means, vs_means, vs_dc, vs_rest;  // floats; a view stride 0:
                                              // one state
  int n, n_used;
};

struct BwdArgs {
  const float* means;
  const float* cam;
  const uint8_t* mask;
  const float* g;
  float* v_dc;
  float* v_rest;
  int64_t s_means, vs_means, s_g;
  int n, n_used, views;
  int shared;  // one state for every view
};

// A block's NT rows of W floats in shared memory, laid out as in global
// memory from a lead of 0..3 floats: the block's first float's offset
// from 16 bytes in global memory, so that both sides of a 16-byte copy
// are aligned.
template <int W>
constexpr int kStageFloats = NT * W + 4;

__device__ __forceinline__ int lead_of(const float* g) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(g) >> 2) & 3u);
}

// Issues the copies of nt rows of W floats, consecutive from g, into s
// from `lead`; the caller commits and waits.
template <int W>
__device__ __forceinline__ void load_rows(const float* g, int nt, float* s,
                                          int lead) {
  const int total = nt * W;
  int head = (4 - lead) & 3;
  head = head < total ? head : total;
  const int nv = (total - head) >> 2;
  for (int j = threadIdx.x; j < head; j += NT)
    osk::cp_async4(s + lead + j, g + j);
  for (int q = threadIdx.x; q < nv; q += NT)
    osk::cp_async16(s + lead + head + 4 * q, g + head + 4 * q, 16);
  for (int j = head + 4 * nv + threadIdx.x; j < total; j += NT)
    osk::cp_async4(s + lead + j, g + j);
}

// Writes nt rows of W floats from s (from `lead`) to g, consecutive;
// after a barrier.
template <int W>
__device__ __forceinline__ void store_rows(const float* s, int nt, float* g,
                                           int lead) {
  const int total = nt * W;
  int head = (4 - lead) & 3;
  head = head < total ? head : total;
  const int nv = (total - head) >> 2;
  for (int j = threadIdx.x; j < head; j += NT) g[j] = s[lead + j];
  const float4* s4 = reinterpret_cast<const float4*>(s + lead + head);
  float4* g4 = reinterpret_cast<float4*>(g + head);
  for (int q = threadIdx.x; q < nv; q += NT) g4[q] = s4[q];
  for (int j = head + 4 * nv + threadIdx.x; j < total; j += NT)
    g[j] = s[lead + j];
}

// The basis of row i under view v.
template <int B>
__device__ __forceinline__ void row_basis(const float* means, int64_t sm,
                                          int64_t vsm, const float* cam,
                                          int v, int64_t i, int n_used,
                                          float bs[B]) {
  const float* mp = means + v * vsm + i * sm;
  const float m[3] = {__ldg(mp), __ldg(mp + 1), __ldg(mp + 2)};
  const float e[3] = {__ldg(cam + 3 * v), __ldg(cam + 3 * v + 1),
                      __ldg(cam + 3 * v + 2)};
  float dir[3];
  osk_sh::view_dir(m, e, dir);
  osk_sh::basis<B>(dir, n_used, bs);
}

template <int B>
__global__ void __launch_bounds__(NT) sh_fwd_kernel(
    const __grid_constant__ FwdArgs a) {
  constexpr int R = 3 * (B - 1);
  constexpr int RW = R > 0 ? R : 1;  // B = 1 stages no features_rest
  __shared__ __align__(16) float s_dc[kStageFloats<3>];
  __shared__ __align__(16) float s_rest[kStageFloats<RW>];
  const int v = blockIdx.y;
  const int i0 = blockIdx.x * NT;
  const int nt = a.n - i0 < NT ? a.n - i0 : NT;
  const float* gdc = a.dc + v * a.vs_dc + static_cast<int64_t>(i0) * 3;
  const float* grest = a.rest + v * a.vs_rest + static_cast<int64_t>(i0) * R;
  const int ldc = lead_of(gdc);
  const int lrest = lead_of(grest);
  load_rows<3>(gdc, nt, s_dc, ldc);
  if constexpr (R > 0) load_rows<RW>(grest, nt, s_rest, lrest);
  osk::cp_commit();
  const int t = threadIdx.x;
  float bs[B];
  if (t < nt)
    row_basis<B>(a.means, a.s_means, a.vs_means, a.cam, v, i0 + t,
                 a.n_used, bs);
  osk::cp_wait_all();
  __syncthreads();
  if (t >= nt) return;
  float rgb[3];
  const unsigned bits =
      osk_sh::colour<B>(bs, a.n_used, s_dc + ldc + 3 * t,
                        s_rest + lrest + RW * t, rgb);
  const int64_t r = static_cast<int64_t>(v) * a.n + i0 + t;
#pragma unroll
  for (int c = 0; c < 3; ++c) a.rgb[3 * r + c] = rgb[c];
  a.mask[r] = static_cast<uint8_t>(bits);
}

template <int B>
__global__ void __launch_bounds__(NT) sh_bwd_kernel(
    const __grid_constant__ BwdArgs a) {
  constexpr int R = 3 * (B - 1);
  constexpr int RW = R > 0 ? R : 1;
  __shared__ __align__(16) float s_dc[kStageFloats<3>];
  __shared__ __align__(16) float s_rest[kStageFloats<RW>];
  const int st = blockIdx.y;  // the state whose gradient rows it writes
  const int i0 = blockIdx.x * NT;
  const int nt = a.n - i0 < NT ? a.n - i0 : NT;
  const int64_t row0 = static_cast<int64_t>(st) * a.n + i0;
  float* odc = a.v_dc + row0 * 3;
  float* orest = a.v_rest + row0 * R;
  const int ldc = lead_of(odc);
  const int lrest = lead_of(orest);
  const int t = threadIdx.x;
  if (t < nt) {
    const int64_t i = i0 + t;
    float* rdc = s_dc + ldc + 3 * t;
    float* rr = s_rest + lrest + RW * t;
    const int vb = a.shared ? 0 : st;
    const int ve = a.shared ? a.views : st + 1;
    for (int v = vb; v < ve; ++v) {
      float bs[B];
      row_basis<B>(a.means, a.s_means, a.vs_means, a.cam, v, i, a.n_used,
                   bs);
      const int64_t r = static_cast<int64_t>(v) * a.n + i;
      const float* gp = a.g + r * a.s_g;
      const float g[3] = {__ldg(gp), __ldg(gp + 1), __ldg(gp + 2)};
      float gm[3];
      osk_sh::masked(g, a.mask[r], gm);
      osk_sh::coeff_grad<B>(bs, gm, v != vb, rdc, rr);
    }
  }
  __syncthreads();
  store_rows<3>(s_dc, nt, odc, ldc);
  if constexpr (R > 0) store_rows<RW>(s_rest, nt, orest, lrest);
}

bool valid_bases(int64_t b, int64_t n_used) {
  return (b == 1 || b == 4 || b == 9 || b == 16 || b == 25) && n_used >= 1 &&
         n_used <= b;
}

template <int B>
cudaError_t launch_fwd(const FwdArgs& a, int views, cudaStream_t s) {
  const dim3 grid((a.n + NT - 1) / NT, views);
  sh_fwd_kernel<B><<<grid, NT, 0, s>>>(a);
  return cudaGetLastError();
}

template <int B>
cudaError_t launch_bwd(const BwdArgs& a, int states, cudaStream_t s) {
  const dim3 grid((a.n + NT - 1) / NT, states);
  sh_bwd_kernel<B><<<grid, NT, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Forward over `views` views of N rows. ptrs: FwdPtr's device pointers
// (rgb and mask contiguous, views * N rows; dc and rest each state's rows
// consecutive); ints: FwdInt's int64 values.
OSK_API int osk_sh_fwd(const void* ptrs, const void* ints, void* stream) {
  void* const* P = static_cast<void* const*>(ptrs);
  const int64_t* I = static_cast<const int64_t*>(ints);
  const int64_t views = I[FI_VIEWS], b = I[FI_B];
  if (I[FI_N] < 0 || I[FI_N] > 0x7fffffff || views < 1 || views > 65535 ||
      !valid_bases(b, I[FI_N_USED]) || I[FI_S_MEANS] < 3 ||
      I[FI_VS_MEANS] < 0 || I[FI_VS_DC] < 0 || I[FI_VS_REST] < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  FwdArgs a{};
  a.n = static_cast<int>(I[FI_N]);
  if (a.n == 0) return static_cast<int>(cudaGetLastError());
  a.means = static_cast<const float*>(P[FP_MEANS]);
  a.cam = static_cast<const float*>(P[FP_CAM]);
  a.dc = static_cast<const float*>(P[FP_DC]);
  a.rest = static_cast<const float*>(P[FP_REST]);
  a.rgb = static_cast<float*>(P[FP_RGB]);
  a.mask = static_cast<uint8_t*>(P[FP_MASK]);
  a.s_means = I[FI_S_MEANS];
  a.vs_means = I[FI_VS_MEANS];
  a.vs_dc = I[FI_VS_DC];
  a.vs_rest = I[FI_VS_REST];
  a.n_used = static_cast<int>(I[FI_N_USED]);
  const int v = static_cast<int>(views);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (b) {
    case 1: return static_cast<int>(launch_fwd<1>(a, v, s));
    case 4: return static_cast<int>(launch_fwd<4>(a, v, s));
    case 9: return static_cast<int>(launch_fwd<9>(a, v, s));
    case 16: return static_cast<int>(launch_fwd<16>(a, v, s));
    default: return static_cast<int>(launch_fwd<25>(a, v, s));
  }
}

// Backward over `views` views of N rows into `states` states' gradients
// (states = views, or 1: one state for every view). ptrs: BwdPtr's
// device pointers (v_dc and v_rest contiguous, states * N rows); ints:
// BwdInt's int64 values.
OSK_API int osk_sh_bwd(const void* ptrs, const void* ints, void* stream) {
  void* const* P = static_cast<void* const*>(ptrs);
  const int64_t* I = static_cast<const int64_t*>(ints);
  const int64_t views = I[BI_VIEWS], states = I[BI_STATES], b = I[BI_B];
  if (I[BI_N] < 0 || I[BI_N] > 0x7fffffff || views < 1 || views > 65535 ||
      (states != 1 && states != views) || !valid_bases(b, I[BI_N_USED]) ||
      I[BI_S_MEANS] < 3 || I[BI_VS_MEANS] < 0 || I[BI_S_G] < 3)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a{};
  a.n = static_cast<int>(I[BI_N]);
  if (a.n == 0) return static_cast<int>(cudaGetLastError());
  a.means = static_cast<const float*>(P[BP_MEANS]);
  a.cam = static_cast<const float*>(P[BP_CAM]);
  a.mask = static_cast<const uint8_t*>(P[BP_MASK]);
  a.g = static_cast<const float*>(P[BP_G]);
  a.v_dc = static_cast<float*>(P[BP_V_DC]);
  a.v_rest = static_cast<float*>(P[BP_V_REST]);
  a.s_means = I[BI_S_MEANS];
  a.vs_means = I[BI_VS_MEANS];
  a.s_g = I[BI_S_G];
  a.n_used = static_cast<int>(I[BI_N_USED]);
  a.views = static_cast<int>(views);
  a.shared = states != views;
  const int st = static_cast<int>(states);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (b) {
    case 1: return static_cast<int>(launch_bwd<1>(a, st, s));
    case 4: return static_cast<int>(launch_bwd<4>(a, st, s));
    case 9: return static_cast<int>(launch_bwd<9>(a, st, s));
    case 16: return static_cast<int>(launch_bwd<16>(a, st, s));
    default: return static_cast<int>(launch_bwd<25>(a, st, s));
  }
}

// o[0] threads a block, o[1..3] the forward's registers, shared memory a
// CTA (bytes) and resident CTAs an SM (osk::kernel_info), o[4..6] the
// backward's, both at B = 16 (SH degree 3).
OSK_API int osk_sh_info(void* out) {
  int* o = static_cast<int*>(out);
  o[0] = NT;
  const int e = osk::kernel_info(sh_fwd_kernel<16>, NT, 0, o + 1);
  if (e != 0) return e;
  return osk::kernel_info(sh_bwd_kernel<16>, NT, 0, o + 4);
}
