"""Real spherical-harmonics colour evaluation (degrees 0..4) on tensors.

Counterpart of opensplat_tpu/ops/sh.py (reference sh.cuh:12-124): a
(N, B) basis matrix contracted with (N, B, 3) coefficients; gradients
from autograd.
"""
from __future__ import annotations

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)
SH_C4 = (
    2.5033429417967046,
    -1.7701307697799304,
    0.9461746957575601,
    -0.6690465435572892,
    0.10578554691520431,
    -0.6690465435572892,
    0.47308734787878004,
    -1.7701307697799304,
    0.6258357354491761,
)

_BASES = {0: 1, 1: 4, 2: 9, 3: 16, 4: 25}


def num_sh_bases(degree: int) -> int:
    """Number of SH basis functions for a max degree (reference numShBases)."""
    return _BASES.get(degree, 25)


def deg_from_sh(num_bases: int) -> int:
    """Inverse of num_sh_bases."""
    for d, b in _BASES.items():
        if b == num_bases:
            return d
    return 4


def rgb_to_sh(rgb):
    """RGB in [0, 1] -> 0th SH coefficient (reference rgb2sh)."""
    return (rgb - 0.5) / SH_C0


def eval_sh_basis(degree: int, degrees_to_use: int,
                  viewdirs: torch.Tensor) -> torch.Tensor:
    """(N, num_sh_bases(degree)) basis; columns past
    num_sh_bases(degrees_to_use) are zero."""
    n = viewdirs.shape[0]
    n_total = num_sh_bases(degree)
    n_used = num_sh_bases(degrees_to_use)
    x, y, z = viewdirs[:, 0], viewdirs[:, 1], viewdirs[:, 2]
    cols = [torch.full_like(x, SH_C0)]
    if n_used > 1:
        cols += [SH_C1 * -y, SH_C1 * z, SH_C1 * -x]
    if n_used > 4:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        cols += [
            SH_C2[0] * xy,
            SH_C2[1] * yz,
            SH_C2[2] * (2.0 * zz - xx - yy),
            SH_C2[3] * xz,
            SH_C2[4] * (xx - yy),
        ]
    if n_used > 9:
        cols += [
            SH_C3[0] * y * (3.0 * xx - yy),
            SH_C3[1] * xy * z,
            SH_C3[2] * y * (4.0 * zz - xx - yy),
            SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            SH_C3[4] * x * (4.0 * zz - xx - yy),
            SH_C3[5] * z * (xx - yy),
            SH_C3[6] * x * (xx - 3.0 * yy),
        ]
    if n_used > 16:
        cols += [
            SH_C4[0] * xy * (xx - yy),
            SH_C4[1] * yz * (3.0 * xx - yy),
            SH_C4[2] * xy * (7.0 * zz - 1.0),
            SH_C4[3] * yz * (7.0 * zz - 3.0),
            SH_C4[4] * (zz * (35.0 * zz - 30.0) + 3.0),
            SH_C4[5] * xz * (7.0 * zz - 3.0),
            SH_C4[6] * (xx - yy) * (7.0 * zz - 1.0),
            SH_C4[7] * xz * (xx - 3.0 * yy),
            SH_C4[8] * (xx * (xx - 3.0 * yy) - yy * (3.0 * xx - yy)),
        ]
    basis = torch.stack(cols, dim=-1)
    if n_used < n_total:
        basis = torch.cat(
            [basis, basis.new_zeros((n, n_total - n_used))], dim=-1
        )
    return basis


def spherical_harmonics(degrees_to_use: int, viewdirs: torch.Tensor,
                        coeffs: torch.Tensor) -> torch.Tensor:
    """(N, 3) colour from (N, 3) unit view directions and (N, B, 3)
    coefficients; the total degree follows from B."""
    degree = deg_from_sh(coeffs.shape[-2])
    basis = eval_sh_basis(degree, degrees_to_use, viewdirs)
    return torch.einsum("nb,nbc->nc", basis, coeffs)
