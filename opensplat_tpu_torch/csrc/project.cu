// The EWA projection of Gaussians to the screen, forward, and its
// vector-Jacobian product derived by hand, one thread per (view, row).
//
// Replaces no Pallas kernel: the JAX package's projection (opensplat_tpu/
// ops/projection.py) is jnp, which XLA fuses on the TPU. In PyTorch the
// same function (ops/projection.py::_project_views, the plain version) is
// ~100 operations over whole (V, N) columns, two per-view cuBLAS
// products of N x 3 by 3 x 3, and autograd's ~200 passes backward, each
// reading and writing whole columns, many of them strided slices.
//
// The math of a row is csrc/project_row.cuh: the plain version's
// operations one for one, each float op rounded on its own
// (--fmad=false), with IEEE division and square root, and the matrix
// products as chains of fused multiply-adds, as cuBLAS takes them; the
// backward recomputes the forward's steps in registers from the inputs
// and takes the chain rule through them term for term as autograd does
// (the note there).
//
// Inputs: means (3 floats a row), scales (3) and quats (4, wxyz) at row
// strides of their own, each one state's rows for every view (view
// stride 0) or a state a view; viewmat and projmat (views, 4, 4); the
// optional valid mask (1 byte a row) and opacities (1 float a row at a
// stride); per-view scalars and the frame's constants by value in the
// launch's argument block, so a view's bits depend on nothing of another
// view. Outputs (forward, contiguous (views, N, ...)): xys, depths,
// cam_depths, radii, conics, cov2d, num_tiles_hit, tile_min, tile_max,
// the mask and the in-front flag. The backward reads the gradients of
// xys, depths, cam_depths, conics and cov2d (any may be absent: a null
// pointer) at row strides of their own, and writes those of means,
// scales and quats, (views, N, ...) a view (the wrapper sums them over
// the views where one state served every view).
//
// Bound on this card: bytes. A row's forward reads 45 B (means, scales,
// quats, opacity, valid) and writes 66 B; the backward reads the 40 B of
// inputs and the gradients (xys and conics in training: 20 B, inside the
// segment sum's 36-byte rows) and writes 40 B: ~230 B a row against some
// 500 float32 operations, 0.39 ms at 3.35 TB/s for garden's 5,803,008
// rows. The design moves each byte once: a block takes 256 consecutive
// rows of one view (grid y is the view), stages that view's two matrices
// in shared memory, and each thread loads its row (quats as one 16-byte
// load where aligned), computes every output in registers and stores
// it; no temporaries, no second pass, no atomics.
#include "common.cuh"
#include "project_row.cuh"

namespace {

using osk_project::Frame;
using osk_project::RowGrad;
using osk_project::RowOut;
using osk_project::ViewScalars;

constexpr int NT = 256;        // threads (rows) of a block
constexpr int MAX_VIEWS = 32;  // views a launch

// The entries' host arrays, in the order ops/kernels/project.py names
// them (FWD_PTRS, BWD_PTRS, INTS, FLOATS).
enum FwdPtr {
  FP_MEANS, FP_SCALES, FP_QUATS, FP_VIEWMAT, FP_PROJMAT, FP_VALID, FP_OPAC,
  FP_XYS, FP_DEPTHS, FP_CAM_DEPTHS, FP_RADII, FP_CONICS, FP_COV2D, FP_TILES,
  FP_TILE_MIN, FP_TILE_MAX, FP_MASK, FP_FRONT
};
enum BwdPtr {
  BP_MEANS, BP_SCALES, BP_QUATS, BP_VIEWMAT, BP_PROJMAT, BP_G_XYS,
  BP_G_DEPTHS, BP_G_CAM_DEPTHS, BP_G_CONICS, BP_G_COV2D, BP_V_MEANS,
  BP_V_SCALES, BP_V_QUATS
};
enum Int {
  I_N, I_VIEWS, I_TB_X, I_TB_Y, I_S_MEANS, I_S_SCALES, I_S_QUATS, I_S_OPAC,
  I_VS_MEANS, I_VS_SCALES, I_VS_QUATS, I_VS_OPAC, I_VS_VALID, I_S_G_XYS,
  I_S_G_DEPTHS, I_S_G_CAM_DEPTHS, I_S_G_CONICS, I_S_G_COV2D
};
// then 6 a view: fx, fy, cx, cy, lim_x, lim_y
enum Float { F_GLOB, F_CLIP, F_HALF_W, F_HALF_H, F_ROW_OFF, F_INV_ALPHA,
             F_VIEW0 };

struct Rows {
  const float* m;
  const float* s;
  const float* q;
  int64_t sm, ss, sq;     // row strides (floats)
  int64_t vsm, vss, vsq;  // view strides (floats; 0: one state)
  int qvec;               // quats rows of 4 floats, 16-byte aligned
};

struct FwdArgs {
  Rows in;
  const float* viewmat;
  const float* projmat;
  const uint8_t* valid;  // null: every row valid
  const float* opac;     // null: the radius' bbox
  int64_t vsv, so, vso;
  float2* xys;
  float* depths;
  float* cam_depths;
  int* radii;
  float* conics;
  float* cov2d;
  int* tiles;
  int2* tile_min;
  int2* tile_max;
  uint8_t* mask;
  uint8_t* front;
  int n;
  Frame f;
  ViewScalars view[MAX_VIEWS];
};

struct BwdArgs {
  Rows in;
  const float* viewmat;
  const float* projmat;
  const float* g_xy;  // null: no gradient
  const float* g_z;
  const float* g_cz;
  const float* g_con;
  const float* g_cov;
  int64_t s_xy, s_z, s_cz, s_con, s_cov;
  float* v_m;  // null: not wanted
  float* v_s;
  float4* v_q;
  int n;
  Frame f;
  ViewScalars view[MAX_VIEWS];
};

// The block's view's viewmat (mats[0..15]) and projmat (mats[16..31]).
__device__ __forceinline__ void load_mats(const float* vm, const float* pm,
                                          int v, float* mats) {
  const int t = threadIdx.x;
  if (t < 16)
    mats[t] = vm[16 * v + t];
  else if (t < 32)
    mats[t] = pm[16 * v + t - 16];
  __syncthreads();
}

__device__ __forceinline__ void load_row(const Rows& in, int v, int i,
                                         float m[3], float s[3],
                                         float q[4]) {
  const float* mp = in.m + v * in.vsm + i * in.sm;
  const float* sp = in.s + v * in.vss + i * in.ss;
  const float* qp = in.q + v * in.vsq + i * in.sq;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    m[k] = __ldg(mp + k);
    s[k] = __ldg(sp + k);
  }
  if (in.qvec) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(qp));
    q[0] = t.x;
    q[1] = t.y;
    q[2] = t.z;
    q[3] = t.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) q[k] = __ldg(qp + k);
  }
}

__global__ void __launch_bounds__(NT) project_fwd_kernel(
    const __grid_constant__ FwdArgs a) {
  __shared__ float mats[32];
  const int v = blockIdx.y;
  load_mats(a.viewmat, a.projmat, v, mats);
  const int i = blockIdx.x * NT + threadIdx.x;
  if (i >= a.n) return;
  float m[3], s[3], q[4];
  load_row(a.in, v, i, m, s, q);
  const bool has_opac = a.opac != nullptr;
  const float opac = has_opac ? __ldg(a.opac + v * a.vso + i * a.so) : 0.0f;
  const bool valid = a.valid == nullptr || a.valid[v * a.vsv + i] != 0;
  RowOut o;
  osk_project::project_row(m, s, q, mats, mats + 16, a.view[v], a.f,
                           has_opac, opac, valid, o);
  const int64_t r = static_cast<int64_t>(v) * a.n + i;
  a.xys[r] = make_float2(o.u, o.v);
  a.depths[r] = o.z;
  a.cam_depths[r] = o.cam_z;
  a.radii[r] = o.radius;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    a.conics[3 * r + k] = o.conic[k];
    a.cov2d[3 * r + k] = o.cov[k];
  }
  a.tiles[r] = o.tiles;
  a.tile_min[r] = make_int2(o.tmin_x, o.tmin_y);
  a.tile_max[r] = make_int2(o.tmax_x, o.tmax_y);
  a.mask[r] = o.mask ? 1 : 0;
  a.front[r] = o.front ? 1 : 0;
}

// 64 registers (4 blocks an SM): a few bytes spill to L1, and the
// launch runs 13% faster than at the 92 registers it takes unbounded
// (0.288 against 0.333 ms at garden's rows on one H100)
__global__ void __launch_bounds__(NT, 4) project_bwd_kernel(
    const __grid_constant__ BwdArgs a) {
  __shared__ float mats[32];
  const int v = blockIdx.y;
  load_mats(a.viewmat, a.projmat, v, mats);
  const int i = blockIdx.x * NT + threadIdx.x;
  if (i >= a.n) return;
  float m[3], s[3], q[4];
  load_row(a.in, v, i, m, s, q);
  const int64_t r = static_cast<int64_t>(v) * a.n + i;
  RowGrad g;
  g.has_xy = a.g_xy != nullptr;
  g.has_z = a.g_z != nullptr;
  g.has_cam_z = a.g_cz != nullptr;
  g.has_conic = a.g_con != nullptr;
  g.has_cov = a.g_cov != nullptr;
  if (g.has_xy) {
    g.xy[0] = __ldg(a.g_xy + r * a.s_xy);
    g.xy[1] = __ldg(a.g_xy + r * a.s_xy + 1);
  }
  if (g.has_z) g.z = __ldg(a.g_z + r * a.s_z);
  if (g.has_cam_z) g.cam_z = __ldg(a.g_cz + r * a.s_cz);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (g.has_conic) g.conic[k] = __ldg(a.g_con + r * a.s_con + k);
    if (g.has_cov) g.cov[k] = __ldg(a.g_cov + r * a.s_cov + k);
  }
  float vm[3], vs[3], vq[4];
  osk_project::project_row_vjp(m, s, q, mats, mats + 16, a.view[v], a.f, g,
                               vm, vs, vq);
  if (a.v_m != nullptr) {
#pragma unroll
    for (int k = 0; k < 3; ++k) a.v_m[3 * r + k] = vm[k];
  }
  if (a.v_s != nullptr) {
#pragma unroll
    for (int k = 0; k < 3; ++k) a.v_s[3 * r + k] = vs[k];
  }
  if (a.v_q != nullptr) a.v_q[r] = make_float4(vq[0], vq[1], vq[2], vq[3]);
}

bool aligned16(const void* x) {
  return (reinterpret_cast<uintptr_t>(x) & 15u) == 0;
}

// The inputs' rows, the frame and the views from the host arrays; false
// when a count or stride is out of range.
bool unpack(void* const* P, const int64_t* I, const float* F, int p_means,
            Rows* in, Frame* f, ViewScalars* view, int* n, int* views) {
  *n = static_cast<int>(I[I_N]);
  *views = static_cast<int>(I[I_VIEWS]);
  if (I[I_N] < 0 || I[I_N] > 0x7fffffff || *views < 1 ||
      *views > MAX_VIEWS)
    return false;
  in->m = static_cast<const float*>(P[p_means]);
  in->s = static_cast<const float*>(P[p_means + 1]);
  in->q = static_cast<const float*>(P[p_means + 2]);
  in->sm = I[I_S_MEANS];
  in->ss = I[I_S_SCALES];
  in->sq = I[I_S_QUATS];
  in->vsm = I[I_VS_MEANS];
  in->vss = I[I_VS_SCALES];
  in->vsq = I[I_VS_QUATS];
  if (in->sm < 3 || in->ss < 3 || in->sq < 4 || in->vsm < 0 ||
      in->vss < 0 || in->vsq < 0)
    return false;
  in->qvec = in->sq == 4 && in->vsq % 4 == 0 && aligned16(in->q);
  f->glob = F[F_GLOB];
  f->clip = F[F_CLIP];
  f->half_w = F[F_HALF_W];
  f->half_h = F[F_HALF_H];
  f->row_off = F[F_ROW_OFF];
  f->inv_alpha = F[F_INV_ALPHA];
  f->tb_x = static_cast<int>(I[I_TB_X]);
  f->tb_y = static_cast<int>(I[I_TB_Y]);
  for (int v = 0; v < *views; ++v) {
    const float* x = F + F_VIEW0 + 6 * v;
    view[v] = ViewScalars{x[0], x[1], x[2], x[3], x[4], x[5]};
  }
  return true;
}

}  // namespace

// Forward over `views` views (at most 32) of N rows. ptrs: FwdPtr's
// device pointers (valid and opac may be null; the outputs contiguous,
// views * N rows, xys, tile_min and tile_max 8-byte aligned); ints: Int's
// int64 values (the gradients' strides unused); floats: Float's float32
// values, then 6 a view.
OSK_API int osk_project_fwd(const void* ptrs, const void* ints,
                            const void* floats, void* stream) {
  void* const* P = static_cast<void* const*>(ptrs);
  const int64_t* I = static_cast<const int64_t*>(ints);
  FwdArgs a{};
  int views = 0;
  if (!unpack(P, I, static_cast<const float*>(floats), FP_MEANS, &a.in, &a.f,
              a.view, &a.n, &views) ||
      I[I_S_OPAC] < 1 || I[I_VS_OPAC] < 0 || I[I_VS_VALID] < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.n == 0) return static_cast<int>(cudaGetLastError());
  a.viewmat = static_cast<const float*>(P[FP_VIEWMAT]);
  a.projmat = static_cast<const float*>(P[FP_PROJMAT]);
  a.valid = static_cast<const uint8_t*>(P[FP_VALID]);
  a.opac = static_cast<const float*>(P[FP_OPAC]);
  a.vsv = I[I_VS_VALID];
  a.so = I[I_S_OPAC];
  a.vso = I[I_VS_OPAC];
  a.xys = static_cast<float2*>(P[FP_XYS]);
  a.depths = static_cast<float*>(P[FP_DEPTHS]);
  a.cam_depths = static_cast<float*>(P[FP_CAM_DEPTHS]);
  a.radii = static_cast<int*>(P[FP_RADII]);
  a.conics = static_cast<float*>(P[FP_CONICS]);
  a.cov2d = static_cast<float*>(P[FP_COV2D]);
  a.tiles = static_cast<int*>(P[FP_TILES]);
  a.tile_min = static_cast<int2*>(P[FP_TILE_MIN]);
  a.tile_max = static_cast<int2*>(P[FP_TILE_MAX]);
  a.mask = static_cast<uint8_t*>(P[FP_MASK]);
  a.front = static_cast<uint8_t*>(P[FP_FRONT]);
  const dim3 grid((a.n + NT - 1) / NT, views);
  project_fwd_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Backward over `views` views of N rows: BwdPtr's device pointers (a
// gradient or a wanted output may be null; v_quats 16-byte aligned; the
// outputs contiguous, views * N rows), Int's and Float's values as for
// the forward.
OSK_API int osk_project_bwd(const void* ptrs, const void* ints,
                            const void* floats, void* stream) {
  void* const* P = static_cast<void* const*>(ptrs);
  const int64_t* I = static_cast<const int64_t*>(ints);
  BwdArgs a{};
  int views = 0;
  if (!unpack(P, I, static_cast<const float*>(floats), BP_MEANS, &a.in, &a.f,
              a.view, &a.n, &views))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.n == 0) return static_cast<int>(cudaGetLastError());
  a.viewmat = static_cast<const float*>(P[BP_VIEWMAT]);
  a.projmat = static_cast<const float*>(P[BP_PROJMAT]);
  a.g_xy = static_cast<const float*>(P[BP_G_XYS]);
  a.g_z = static_cast<const float*>(P[BP_G_DEPTHS]);
  a.g_cz = static_cast<const float*>(P[BP_G_CAM_DEPTHS]);
  a.g_con = static_cast<const float*>(P[BP_G_CONICS]);
  a.g_cov = static_cast<const float*>(P[BP_G_COV2D]);
  a.s_xy = I[I_S_G_XYS];
  a.s_z = I[I_S_G_DEPTHS];
  a.s_cz = I[I_S_G_CAM_DEPTHS];
  a.s_con = I[I_S_G_CONICS];
  a.s_cov = I[I_S_G_COV2D];
  a.v_m = static_cast<float*>(P[BP_V_MEANS]);
  a.v_s = static_cast<float*>(P[BP_V_SCALES]);
  a.v_q = static_cast<float4*>(P[BP_V_QUATS]);
  if (a.v_q != nullptr && !aligned16(a.v_q))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((a.n + NT - 1) / NT, views);
  project_bwd_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// o[0] threads a block, o[1] views a launch, o[2..4] the forward's
// registers, shared memory a CTA (bytes) and resident CTAs an SM
// (osk::kernel_info), o[5..7] the backward's.
OSK_API int osk_project_info(void* out) {
  int* o = static_cast<int*>(out);
  o[0] = NT;
  o[1] = MAX_VIEWS;
  const int e = osk::kernel_info(project_fwd_kernel, NT, 0, o + 2);
  if (e != 0) return e;
  return osk::kernel_info(project_bwd_kernel, NT, 0, o + 5);
}
