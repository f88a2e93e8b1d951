// The EWA projection of one Gaussian under one view, and its vector-
// Jacobian product, as plain float32 functions of one row: the math of
// csrc/project.cu. Host code can compile this header too (it includes
// nothing of CUDA), which is how the port's CPU tests hold the kernel's
// math to the plain version and to its autograd.
//
// Forward, for means m, scales s, wxyz quaternion q, the view's matrices
// V (viewmat) and P (projmat, the full projection) and its scalars fx,
// fy, cx, cy and FOV limits lx, ly (ops/projection.py::_project_views,
// whose operations this follows one for one, each float op rounded on
// its own but the matrix products, fused multiply-adds as in cuBLAS):
//   p = V[:3] m + V[:3, 3]; z = p.z; z' = 1 in the clip slab |z| < clip,
//   else z; tx = z clamp(p.x / z', -lx, lx), ty likewise;
//   J = [[fx / z', 0, -fx tx / z'^2], [0, fy / z', -fy ty / z'^2]];
//   T = J V[:3, :3]; R = R(q / |q|); W = T R diag(g s);
//   cov2d = W W^T + 0.3 I = (a, b, c); det = a c - b^2 (1 where 0);
//   conic = (c, -b, a) / det; radius = ceil(3 sqrt(mid + sqrt(max(mid^2
//   - det, 0.1)))), mid = (a + c) / 2;
//   h = P m + P[:, 3]; w = 1 in the slab, else h.w; n = h.xyz / (w + 1e-6);
//   u = W/2 n.x + cx - 0.5, v = H/2 n.y + cy - 0.5 - row_offset;
//   the tile bbox of the radius (opacity-aware: min(radius,
//   ceil(sqrt(2 s_max v_max) + 1)), 0 where s_max = log(opacity /
//   alpha_thresh) <= 0), the in-front flag z > clip and the mask.
//
// Backward: the chain rule through the same steps, term for term as
// PyTorch's autograd takes it through the plain version: the FOV clamp
// passes gradient inside its limits alone, bounds included (torch.clamp);
// torch.where's branches at the clip slab and at det == 0 pass it to the
// branch taken; the quaternion's normalisation is differentiated; the
// radius and the tile geometry have none. An output without a gradient
// contributes no term.
#pragma once

#ifdef __CUDACC__
#define OSK_HD __host__ __device__ __forceinline__
#else
#include <math.h>
#define OSK_HD inline
#endif

namespace osk_project {

// A view's scalars, each the float32 rounding of the Python value the
// plain version turns into a per-view column.
struct ViewScalars {
  float fx, fy, cx, cy, lim_x, lim_y;
};

// What every row of a call shares.
struct Frame {
  float glob;       // glob_scale
  float clip;       // clip_thresh
  float half_w;     // 0.5 * the width the NDC x spans
  float half_h;     // 0.5 * the height the NDC y spans
  float row_off;    // row_offset (0 without one)
  float inv_alpha;  // float32(1) / float32(alpha_thresh)
  int tb_x, tb_y;   // tiles across and down
};

struct RowOut {
  float u, v, z, cam_z;
  float conic[3], cov[3];
  int radius, tiles;
  int tmin_x, tmin_y, tmax_x, tmax_y;
  bool mask, front;
};

// The gradients a row's outputs received; has_* false for an output
// without one.
struct RowGrad {
  float xy[2], z, cam_z, conic[3], cov[3];
  bool has_xy, has_z, has_cam_z, has_conic, has_cov;
};

// torch.clamp's and torch.minimum's NaN handling
OSK_HD float clampf(float x, float lo, float hi) {
  if (x != x) return x;
  x = x < lo ? lo : x;
  return x > hi ? hi : x;
}

OSK_HD float clamp_minf(float x, float lo) {
  if (x != x) return x;
  return x < lo ? lo : x;
}

OSK_HD float minimumf(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? a : b;
}

OSK_HD int clamp_tile(int t, int hi) {
  t = t < 0 ? 0 : t;
  return t > hi ? hi : t;
}

// Row k of the 4 x 4 row-major matrix M applied to m: M[k, :3] m +
// M[k, 3]. The product is a chain of fused multiply-adds, as cuBLAS
// accumulates the plain version's GEMM (m @ M[:, :3].T), and the column
// is added after it, as the plain version adds it.
OSK_HD float affine(const float* M, int k, const float m[3]) {
  return fmaf(m[2], M[4 * k + 2], fmaf(m[1], M[4 * k + 1], m[0] * M[4 * k])) +
         M[4 * k + 3];
}

// R(q / |q|) (tensor_math.py::quat_to_rotmat); qn gets q / |q|, *n |q|.
OSK_HD void rotmat(const float q[4], float qn[4], float* n, float R[9]) {
  const float nn = sqrtf(((q[0] * q[0] + q[1] * q[1]) + q[2] * q[2]) +
                         q[3] * q[3]);
  *n = nn;
  for (int k = 0; k < 4; ++k) qn[k] = q[k] / nn;
  const float w = qn[0], x = qn[1], y = qn[2], z = qn[3];
  R[0] = 1.0f - 2.0f * (y * y + z * z);
  R[1] = 2.0f * (x * y - w * z);
  R[2] = 2.0f * (x * z + w * y);
  R[3] = 2.0f * (x * y + w * z);
  R[4] = 1.0f - 2.0f * (x * x + z * z);
  R[5] = 2.0f * (y * z - w * x);
  R[6] = 2.0f * (x * z - w * y);
  R[7] = 2.0f * (y * z + w * x);
  R[8] = 1.0f - 2.0f * (x * x + y * y);
}

// The steps up to the 2D covariance, kept for the backward.
struct Cov {
  float p[3], zs, qx, qy, cqx, cqy, tx, ty, rz, rz2;
  float t0[3], t1[3];  // the rows of T = J V[:3, :3]
  float qn[4], n, R[9];
  float s[3], M0[3], M1[3], v0[3], v1[3];  // W's rows before and after s
  float a, b, c;
  bool slab;
};

OSK_HD void cov2d(const float m[3], const float sc[3], const float q[4],
                  const float* V, const ViewScalars& vw, const Frame& f,
                  Cov& k) {
  for (int i = 0; i < 3; ++i) k.p[i] = affine(V, i, m);
  const float z = k.p[2];
  k.slab = fabsf(z) < f.clip;
  k.zs = k.slab ? 1.0f : z;
  k.qx = k.p[0] / k.zs;
  k.qy = k.p[1] / k.zs;
  k.cqx = clampf(k.qx, -vw.lim_x, vw.lim_x);
  k.cqy = clampf(k.qy, -vw.lim_y, vw.lim_y);
  k.tx = z * k.cqx;
  k.ty = z * k.cqy;
  k.rz = 1.0f / k.zs;
  k.rz2 = k.rz * k.rz;
  const float j00 = vw.fx * k.rz;
  const float j02 = (-vw.fx * k.tx) * k.rz2;
  const float j11 = vw.fy * k.rz;
  const float j12 = (-vw.fy * k.ty) * k.rz2;
  for (int i = 0; i < 3; ++i) {
    k.t0[i] = j00 * V[i] + j02 * V[8 + i];
    k.t1[i] = j11 * V[4 + i] + j12 * V[8 + i];
  }
  rotmat(q, k.qn, &k.n, k.R);
  for (int j = 0; j < 3; ++j) {
    k.s[j] = f.glob * sc[j];
    k.M0[j] = (k.t0[0] * k.R[j] + k.t0[1] * k.R[3 + j]) + k.t0[2] * k.R[6 + j];
    k.M1[j] = (k.t1[0] * k.R[j] + k.t1[1] * k.R[3 + j]) + k.t1[2] * k.R[6 + j];
    k.v0[j] = k.M0[j] * k.s[j];
    k.v1[j] = k.M1[j] * k.s[j];
  }
  k.a = ((k.v0[0] * k.v0[0] + k.v0[1] * k.v0[1]) + k.v0[2] * k.v0[2]) + 0.3f;
  k.b = (k.v0[0] * k.v1[0] + k.v0[1] * k.v1[1]) + k.v0[2] * k.v1[2];
  k.c = ((k.v1[0] * k.v1[0] + k.v1[1] * k.v1[1]) + k.v1[2] * k.v1[2]) + 0.3f;
}

// The tile bbox of radius r about the centre (tcx, tcy) in tiles.
OSK_HD void tile_bbox(float tcx, float tcy, float r, const Frame& f,
                      int* x0, int* y0, int* x1, int* y1) {
  const float trx = r * 0.0625f;  // r / BLOCK_X, exact
  const float try_ = r * 0.0625f;
  *x0 = clamp_tile(static_cast<int>(tcx - trx), f.tb_x);
  *x1 = clamp_tile(static_cast<int>((tcx + trx) + 1.0f), f.tb_x);
  *y0 = clamp_tile(static_cast<int>(tcy - try_), f.tb_y);
  *y1 = clamp_tile(static_cast<int>((tcy + try_) + 1.0f), f.tb_y);
}

// Forward of one row. V, P: the view's 4 x 4 matrices, row-major.
// has_opac: opac is the row's opacity (opacity-aware bbox); valid: the
// row's valid_mask entry (true without one).
OSK_HD void project_row(const float m[3], const float sc[3],
                        const float q[4], const float* V, const float* P,
                        const ViewScalars& vw, const Frame& f, bool has_opac,
                        float opac, bool valid, RowOut& o) {
  Cov k;
  cov2d(m, sc, q, V, vw, f, k);
  const float a = k.a, b = k.b, c = k.c;
  const float det0 = a * c - b * b;
  const bool det_ok = det0 != 0.0f;
  const float det = det_ok ? det0 : 1.0f;
  const float inv = 1.0f / det;
  o.conic[0] = c * inv;
  o.conic[1] = -b * inv;
  o.conic[2] = a * inv;
  o.cov[0] = a;
  o.cov[1] = b;
  o.cov[2] = c;
  const float mid = 0.5f * (a + c);
  const float sq = sqrtf(clamp_minf(mid * mid - det, 0.1f));
  const float v_max = mid + sq;
  const float radius = ceilf(3.0f * sqrtf(v_max));

  float h[4];
  for (int i = 0; i < 4; ++i) h[i] = affine(P, i, m);
  const float w = k.slab ? 1.0f : h[3];
  const float rw = 1.0f / (w + 1e-6f);
  const float n0 = h[0] * rw, n1 = h[1] * rw;
  o.cam_z = h[2] * rw;
  o.u = (f.half_w * n0 + vw.cx) - 0.5f;
  o.v = ((f.half_h * n1 + vw.cy) - 0.5f) - f.row_off;
  o.z = k.p[2];

  const float tcx = o.u * 0.0625f;  // u / BLOCK_X, exact
  const float tcy = o.v * 0.0625f;
  float bbox_r = radius;
  if (has_opac) {
    const float s_max = logf(clamp_minf(opac, 1e-12f) * f.inv_alpha);
    const float r_alpha =
        sqrtf((2.0f * clamp_minf(s_max, 0.0f)) * v_max) + 1.0f;
    bbox_r = s_max > 0.0f ? minimumf(radius, ceilf(r_alpha)) : 0.0f;
  }
  tile_bbox(tcx, tcy, bbox_r, f, &o.tmin_x, &o.tmin_y, &o.tmax_x, &o.tmax_y);
  const int area = (o.tmax_x - o.tmin_x) * (o.tmax_y - o.tmin_y);
  int vis_area = area;
  if (has_opac) {
    int x0, y0, x1, y1;
    tile_bbox(tcx, tcy, radius, f, &x0, &y0, &x1, &y1);
    vis_area = (x1 - x0) * (y1 - y0);
  }
  o.front = o.z > f.clip;
  o.mask = o.front && det_ok && vis_area > 0 && valid;
  o.radius = o.mask ? static_cast<int>(radius) : 0;
  o.tiles = o.mask ? area : 0;
}

// Vector-Jacobian product of one row: the gradients of means (gm),
// scales (gs) and quats (gq) from the outputs' gradients g.
OSK_HD void project_row_vjp(const float m[3], const float sc[3],
                            const float q[4], const float* V, const float* P,
                            const ViewScalars& vw, const Frame& f,
                            const RowGrad& g, float gm[3], float gs[3],
                            float gq[4]) {
  Cov k;
  cov2d(m, sc, q, V, vw, f, k);
  float g_p[3] = {0.0f, 0.0f, 0.0f};  // of p = V[:3] m + t
  float g_h[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // of h = P m + P[:, 3]
  float g_z = g.has_z ? g.z : 0.0f;   // of z = p.z, besides g_p[2]
  for (int j = 0; j < 3; ++j) gs[j] = 0.0f;
  for (int j = 0; j < 4; ++j) gq[j] = 0.0f;

  if (g.has_conic || g.has_cov) {
    const float a = k.a, b = k.b, c = k.c;
    const float det0 = a * c - b * b;
    const bool det_ok = det0 != 0.0f;
    const float det = det_ok ? det0 : 1.0f;
    const float inv = 1.0f / det;
    float ga = 0.0f, gb = 0.0f, gc = 0.0f;
    if (g.has_cov) {
      ga = g.cov[0];
      gb = g.cov[1];
      gc = g.cov[2];
    }
    if (g.has_conic) {
      // conic = (c inv, -b inv, a inv)
      gc = gc + g.conic[0] * inv;
      gb = gb - g.conic[1] * inv;
      ga = ga + g.conic[2] * inv;
      const float g_inv = (g.conic[0] * c + g.conic[1] * -b) + g.conic[2] * a;
      // inv = 1 / det; det taken where det0 != 0
      const float g_det = det_ok ? -g_inv * (inv * inv) : 0.0f;
      ga = ga + c * g_det;
      gc = gc + a * g_det;
      gb = gb - 2.0f * b * g_det;
    }
    // a = |v0|^2 + 0.3, b = v0 . v1, c = |v1|^2 + 0.3; v = M s
    float g_M0[3], g_M1[3];
    for (int j = 0; j < 3; ++j) {
      const float g_v0 = 2.0f * k.v0[j] * ga + k.v1[j] * gb;
      const float g_v1 = 2.0f * k.v1[j] * gc + k.v0[j] * gb;
      gs[j] = f.glob * (g_v0 * k.M0[j] + g_v1 * k.M1[j]);
      g_M0[j] = g_v0 * k.s[j];
      g_M1[j] = g_v1 * k.s[j];
    }
    // M0[j] = sum_i t0[i] R[i][j]: the gradients of T's rows and of R
    float g_t0[3], g_t1[3], g_R[9];
    for (int i = 0; i < 3; ++i) {
      g_t0[i] = (k.R[3 * i] * g_M0[0] + k.R[3 * i + 1] * g_M0[1]) +
                k.R[3 * i + 2] * g_M0[2];
      g_t1[i] = (k.R[3 * i] * g_M1[0] + k.R[3 * i + 1] * g_M1[1]) +
                k.R[3 * i + 2] * g_M1[2];
      for (int j = 0; j < 3; ++j)
        g_R[3 * i + j] = k.t0[i] * g_M0[j] + k.t1[i] * g_M1[j];
    }
    // R of the normalised quaternion (w, x, y, z)
    const float w = k.qn[0], x = k.qn[1], y = k.qn[2], z = k.qn[3];
    float g_qn[4];
    g_qn[0] = 2.0f * (((-z * g_R[1] + y * g_R[2]) + (z * g_R[3] - x * g_R[5])) +
                      (-y * g_R[6] + x * g_R[7]));
    g_qn[1] = 2.0f * (((y * g_R[1] + z * g_R[2]) + (y * g_R[3] - 2.0f * x * g_R[4])) +
                      ((-w * g_R[5] + z * g_R[6]) + (w * g_R[7] - 2.0f * x * g_R[8])));
    g_qn[2] = 2.0f * (((-2.0f * y * g_R[0] + x * g_R[1]) + (w * g_R[2] + x * g_R[3])) +
                      ((z * g_R[5] - w * g_R[6]) + (z * g_R[7] - 2.0f * y * g_R[8])));
    g_qn[3] = 2.0f * (((-2.0f * z * g_R[0] - w * g_R[1]) + (x * g_R[2] + w * g_R[3])) +
                      ((-2.0f * z * g_R[4] + y * g_R[5]) + (x * g_R[6] + y * g_R[7])));
    // qn = q / n, n = |q|: g_q = g_qn / n + q (g_n / n), with g_n =
    // -sum_k g_qn[k] q[k] / n^2
    const float nn = k.n;
    const float g_n = -((((g_qn[0] * q[0] + g_qn[1] * q[1]) + g_qn[2] * q[2]) +
                        g_qn[3] * q[3]) / (nn * nn));
    for (int j = 0; j < 4; ++j) gq[j] = g_qn[j] / nn + q[j] * (g_n / nn);
    // t0[i] = j00 V[0][i] + j02 V[2][i]; t1[i] = j11 V[1][i] + j12 V[2][i]
    float g_j00 = 0.0f, g_j02 = 0.0f, g_j11 = 0.0f, g_j12 = 0.0f;
    for (int i = 0; i < 3; ++i) {
      g_j00 = g_j00 + V[i] * g_t0[i];
      g_j02 = g_j02 + V[8 + i] * g_t0[i];
      g_j11 = g_j11 + V[4 + i] * g_t1[i];
      g_j12 = g_j12 + V[8 + i] * g_t1[i];
    }
    // j00 = fx rz, j02 = (-fx tx) rz2, j11 = fy rz, j12 = (-fy ty) rz2
    float g_rz = vw.fx * g_j00 + vw.fy * g_j11;
    const float g_rz2 = (-vw.fx * k.tx) * g_j02 + (-vw.fy * k.ty) * g_j12;
    const float g_tx = -vw.fx * k.rz2 * g_j02;
    const float g_ty = -vw.fy * k.rz2 * g_j12;
    g_rz = g_rz + 2.0f * k.rz * g_rz2;  // rz2 = rz rz
    float g_zs = -g_rz * (k.rz * k.rz);  // rz = 1 / z'
    // tx = z clamp(qx), qx = p.x / z': the clamp passes gradient inside
    // its limits, bounds included
    g_z = g_z + g_tx * k.cqx + g_ty * k.cqy;
    const float g_cqx = g_tx * k.p[2];
    const float g_cqy = g_ty * k.p[2];
    const float g_qx =
        (k.qx >= -vw.lim_x && k.qx <= vw.lim_x) ? g_cqx : 0.0f;
    const float g_qy =
        (k.qy >= -vw.lim_y && k.qy <= vw.lim_y) ? g_cqy : 0.0f;
    g_p[0] = g_qx / k.zs;
    g_p[1] = g_qy / k.zs;
    g_zs = g_zs - g_qx * k.p[0] / (k.zs * k.zs) -
           g_qy * k.p[1] / (k.zs * k.zs);
    // z' = z outside the clip slab, 1 in it
    if (!k.slab) g_z = g_z + g_zs;
  }

  if (g.has_xy || g.has_cam_z) {
    // n = h.xyz rw, rw = 1 / (w + 1e-6), w = h.w outside the slab
    float h[4];
    for (int i = 0; i < 4; ++i) h[i] = affine(P, i, m);
    const float w = k.slab ? 1.0f : h[3];
    const float rw = 1.0f / (w + 1e-6f);
    float g_n[3] = {0.0f, 0.0f, 0.0f};
    if (g.has_xy) {
      g_n[0] = f.half_w * g.xy[0];
      g_n[1] = f.half_h * g.xy[1];
    }
    if (g.has_cam_z) g_n[2] = g.cam_z;
    float g_rw = 0.0f;
    for (int i = 0; i < 3; ++i) {
      g_h[i] = g_n[i] * rw;
      g_rw = g_rw + g_n[i] * h[i];
    }
    if (!k.slab) g_h[3] = -g_rw * (rw * rw);
  }

  g_p[2] = g_p[2] + g_z;
  // m enters p through V[:3, :3] and h through P[:, :3]: the transposed
  // products, each a chain of fused multiply-adds as cuBLAS takes the
  // plain version's gradient GEMMs, then their sum
  for (int j = 0; j < 3; ++j) {
    const float from_p =
        fmaf(g_p[2], V[8 + j], fmaf(g_p[1], V[4 + j], g_p[0] * V[j]));
    const float from_h = fmaf(
        g_h[3], P[12 + j],
        fmaf(g_h[2], P[8 + j], fmaf(g_h[1], P[4 + j], g_h[0] * P[j])));
    gm[j] = from_p + from_h;
  }
}

}  // namespace osk_project
