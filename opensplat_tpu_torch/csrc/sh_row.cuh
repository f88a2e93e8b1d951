// The render's colour of one Gaussian under one view from its spherical-
// harmonic coefficients, and the gradient of the coefficients, as plain
// float32 functions of one row: the math of csrc/sh.cu. Host code can
// compile this header too (it includes nothing of CUDA), which is how the
// port's CPU tests hold the kernel's math to the plain version and to its
// autograd.
//
// Forward, for the row's mean m, the view's camera centre e and B
// coefficients of 3 channels (coefficient 0 features_dc, 1..B-1
// features_rest; B in {1, 4, 9, 16, 25}), of which the first n_used
// (num_sh_bases(degrees_to_use)) are used (ops/sh.py::render_colours_plain,
// whose operations the direction and the basis follow one for one, each
// float op rounded on its own):
//   d = m - e; dir = d / max(|d|, 1e-12);
//   basis_b = the real SH basis of dir (ops/sh.py::eval_sh_basis), 0 for
//   b >= n_used;
//   pre_c = sum_b basis_b coeff_bc, a chain of fused multiply-adds in
//   index order; rgb_c = max(pre_c + 0.5, 0), NaN kept (torch.clamp).
// The forward also returns the clamp's mask: bit c set where pre_c + 0.5
// >= 0, where torch.clamp(min=0)'s backward passes the gradient.
//
// Backward: the means are detached (model.cpp:176-177), so the gradient
// reaches the coefficients alone: v_coeff_bc = basis_b * (bit c ? v_rgb_c
// : 0), one product, as autograd's outer product takes it; 0 for b >=
// n_used.
#pragma once

#ifdef __CUDACC__
#define OSK_HD __host__ __device__ __forceinline__
#define OSK_UNROLL _Pragma("unroll")
#else
#include <math.h>
#define OSK_HD inline
#define OSK_UNROLL
#endif

namespace osk_sh {

// ops/sh.py's constants of degrees 0 and 1, each rounded to float32 as
// PyTorch rounds a Python scalar that multiplies a float32 tensor
constexpr float C0 = 0.28209479177387814f;
constexpr float C1 = 0.4886025119029199f;

// The unit direction from the camera centre e to the mean m: d / max(|d|,
// 1e-12), the norm's squares summed in index order.
OSK_HD void view_dir(const float m[3], const float e[3], float dir[3]) {
  const float d0 = m[0] - e[0], d1 = m[1] - e[1], d2 = m[2] - e[2];
  float n = sqrtf((d0 * d0 + d1 * d1) + d2 * d2);
  n = n < 1e-12f ? 1e-12f : n;  // a NaN norm stays NaN (torch.clamp)
  dir[0] = d0 / n;
  dir[1] = d1 / n;
  dir[2] = d2 / n;
}

// The B columns of the basis at dir; columns at n_used and past are 0.
template <int B>
OSK_HD void basis(const float dir[3], int n_used, float o[B]) {
  // degrees 2-4 (local: device code reads no host array)
  constexpr float C2[5] = {1.0925484305920792f, -1.0925484305920792f,
                           0.31539156525252005f, -1.0925484305920792f,
                           0.5462742152960396f};
  constexpr float C3[7] = {-0.5900435899266435f, 2.890611442640554f,
                           -0.4570457994644658f, 0.3731763325901154f,
                           -0.4570457994644658f, 1.445305721320277f,
                           -0.5900435899266435f};
  constexpr float C4[9] = {2.5033429417967046f, -1.7701307697799304f,
                           0.9461746957575601f, -0.6690465435572892f,
                           0.10578554691520431f, -0.6690465435572892f,
                           0.47308734787878004f, -1.7701307697799304f,
                           0.6258357354491761f};
  const float x = dir[0], y = dir[1], z = dir[2];
  o[0] = C0;
  if constexpr (B > 1) {
    o[1] = C1 * -y;
    o[2] = C1 * z;
    o[3] = C1 * -x;
  }
  if constexpr (B > 4) {
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, yz = y * z, xz = x * z;
    o[4] = C2[0] * xy;
    o[5] = C2[1] * yz;
    o[6] = C2[2] * ((2.0f * zz - xx) - yy);
    o[7] = C2[3] * xz;
    o[8] = C2[4] * (xx - yy);
    if constexpr (B > 9) {
      o[9] = C3[0] * y * (3.0f * xx - yy);
      o[10] = C3[1] * xy * z;
      o[11] = C3[2] * y * ((4.0f * zz - xx) - yy);
      o[12] = C3[3] * z * ((2.0f * zz - 3.0f * xx) - 3.0f * yy);
      o[13] = C3[4] * x * ((4.0f * zz - xx) - yy);
      o[14] = C3[5] * z * (xx - yy);
      o[15] = C3[6] * x * (xx - 3.0f * yy);
    }
    if constexpr (B > 16) {
      o[16] = C4[0] * xy * (xx - yy);
      o[17] = C4[1] * yz * (3.0f * xx - yy);
      o[18] = C4[2] * xy * (7.0f * zz - 1.0f);
      o[19] = C4[3] * yz * (7.0f * zz - 3.0f);
      o[20] = C4[4] * (zz * (35.0f * zz - 30.0f) + 3.0f);
      o[21] = C4[5] * xz * (7.0f * zz - 3.0f);
      o[22] = C4[6] * (xx - yy) * (7.0f * zz - 1.0f);
      o[23] = C4[7] * xz * (xx - 3.0f * yy);
      o[24] = C4[8] * (xx * (xx - 3.0f * yy) - yy * (3.0f * xx - yy));
    }
  }
  OSK_UNROLL
  for (int b = 1; b < B; ++b) {
    if (b >= n_used) o[b] = 0.0f;
  }
}

// rgb (3 floats) from the basis, the row's features_dc (3 floats) and its
// features_rest (B - 1 rows of 3 floats, consecutive); returns the
// clamp's mask bits.
template <int B>
OSK_HD unsigned colour(const float bs[B], int n_used, const float* dc,
                       const float* rest, float rgb[3]) {
  unsigned bits = 0;
  OSK_UNROLL
  for (int c = 0; c < 3; ++c) {
    float acc = bs[0] * dc[c];
    OSK_UNROLL
    for (int b = 1; b < B; ++b) {
      if (b < n_used) acc = fmaf(bs[b], rest[3 * (b - 1) + c], acc);
    }
    const float pre = acc + 0.5f;
    if (pre >= 0.0f) bits |= 1u << c;
    rgb[c] = pre < 0.0f ? 0.0f : pre;  // NaN stays NaN
  }
  return bits;
}

// The clamp's mask applied to a row's colour gradient g (3 floats).
OSK_HD void masked(const float* g, unsigned bits, float gm[3]) {
  OSK_UNROLL
  for (int c = 0; c < 3; ++c) gm[c] = (bits >> c) & 1u ? g[c] : 0.0f;
}

// The gradient of a row's coefficients under one view, basis_b gm_c, into
// dc (3 floats) and rest (B - 1 rows of 3 floats); with `add` (a later
// view of a state that every view shares) added to what they hold.
template <int B>
OSK_HD void coeff_grad(const float bs[B], const float gm[3], bool add,
                       float* dc, float* rest) {
  if (add) {
    OSK_UNROLL
    for (int c = 0; c < 3; ++c) dc[c] = dc[c] + bs[0] * gm[c];
    OSK_UNROLL
    for (int b = 1; b < B; ++b) {
      OSK_UNROLL
      for (int c = 0; c < 3; ++c)
        rest[3 * (b - 1) + c] = rest[3 * (b - 1) + c] + bs[b] * gm[c];
    }
  } else {
    OSK_UNROLL
    for (int c = 0; c < 3; ++c) dc[c] = bs[0] * gm[c];
    OSK_UNROLL
    for (int b = 1; b < B; ++b) {
      OSK_UNROLL
      for (int c = 0; c < 3; ++c) rest[3 * (b - 1) + c] = bs[b] * gm[c];
    }
  }
}

}  // namespace osk_sh
