"""Compositing constants and the Gaussian exponent shared by the
rasterizer kernels' plain versions (opensplat_tpu/ops/rasterize.py:49-52;
reference forward.cu). The dense conformance renderer of the JAX package
is not ported yet."""

ALPHA_THRESH = 1.0 / 255.0  # records below this alpha are skipped
T_EPS = 1e-4  # a pixel stops once T would drop to or below this
FWD_ALPHA_CLAMP = 0.999
BWD_ALPHA_CLAMP = 0.99  # the reference backward re-clamps at 0.99


def sigma_at(A, B, C, dx, dy):
    """Gaussian exponent at pixel offset (dx, dy) = (x - px, y - py), in
    the operation order of csrc/common.cuh::sigma_at."""
    return 0.5 * (A * dx * dx + C * dy * dy) + B * dx * dy
