"""Real spherical-harmonics colour evaluation (degrees 0..4) on tensors.

Counterpart of opensplat_tpu/ops/sh.py (reference sh.cuh:12-124): a
(N, B) basis matrix contracted with (N, B, 3) coefficients; gradients
from autograd. A batch of views contracts once a view (views.per_view),
so each view's colours are the bits of its own call.

The render's colours (`render_colours`: view directions, SH, + 0.5,
clamped at 0) are on the card the SH kernel pair (ops/kernels/sh.py,
csrc/sh.cu): one forward launch reading features_dc and features_rest
where they lie, and a backward derived by hand, one launch; on the CPU
they are `render_colours_plain` below, whose gradients come from torch
autograd. The tensor's device alone selects. Counters (utils/
metrics.py): `sh.calls`, the calls of `render_colours`, and `sh.fused`,
those that launched the forward kernel.
"""
from __future__ import annotations

import torch

from ..utils.metrics import count
from .kernels import sh as ksh
from .views import per_view

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


def sh_to_rgb(sh):
    """0th SH coefficient -> RGB clamped to [0, 1] (reference sh2rgb); a
    tensor or a numpy array."""
    return (sh * SH_C0 + 0.5).clip(0.0, 1.0)


def eval_sh_basis(degree: int, degrees_to_use: int,
                  viewdirs: torch.Tensor) -> torch.Tensor:
    """(..., num_sh_bases(degree)) basis of (..., 3) directions; columns
    past num_sh_bases(degrees_to_use) are zero."""
    n_total = num_sh_bases(degree)
    n_used = num_sh_bases(degrees_to_use)
    x, y, z = viewdirs[..., 0], viewdirs[..., 1], viewdirs[..., 2]
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
            [basis, basis.new_zeros(basis.shape[:-1] + (n_total - n_used,))],
            dim=-1)
    return basis


def spherical_harmonics(degrees_to_use: int, viewdirs: torch.Tensor,
                        coeffs: torch.Tensor) -> torch.Tensor:
    """(N, 3) colour from (N, 3) unit view directions and (N, B, 3)
    coefficients; the total degree follows from B. V views: directions
    (V, N, 3) and one state's (N, B, 3) coefficients or V states' (V, N,
    B, 3) give (V, N, 3)."""
    degree = deg_from_sh(coeffs.shape[-2])
    basis = eval_sh_basis(degree, degrees_to_use, viewdirs)
    if viewdirs.dim() == 2:
        return torch.einsum("nb,nbc->nc", basis, coeffs)
    if coeffs.dim() == 3:
        coeffs = coeffs[None]
    return per_view(lambda b, c: torch.einsum("nb,nbc->nc", b, c),
                    viewdirs.shape[0], basis, coeffs)


def render_colours(degrees_to_use: int, means: torch.Tensor,
                   cam_pos: torch.Tensor, features_dc: torch.Tensor,
                   features_rest: torch.Tensor) -> torch.Tensor:
    """The clamped colours (V, N, 3) that V views render: means (1 or V,
    N, 3), detached; cam_pos (V, 3), the views' camera centres;
    features_dc (1 or V, N, 3) and features_rest (1 or V, N, B - 1, 3),
    one state's coefficients for every view or a state a view. On the
    card one thread a (view, row) computes its colour from that view's
    camera and the row alone; in the plain version the products run once
    a view (views.per_view): either way each view's colours are the bits
    of its own call."""
    count("sh.calls")
    if means.is_cuda:
        before = ksh.run_forward.launches
        out = ksh.sh_colours(num_sh_bases(degrees_to_use), means, cam_pos,
                             features_dc, features_rest)
        if ksh.run_forward.launches != before:
            count("sh.fused")
        return out
    return render_colours_plain(degrees_to_use, means, cam_pos, features_dc,
                                features_rest)


def render_colours_plain(degrees_to_use: int, means: torch.Tensor,
                         cam_pos: torch.Tensor, features_dc: torch.Tensor,
                         features_rest: torch.Tensor) -> torch.Tensor:
    """`render_colours` in plain PyTorch, its gradients from autograd."""
    # SH view directions from detached means (model.cpp:176-177)
    viewdirs = means.detach() - cam_pos[:, None, :]
    viewdirs = viewdirs / torch.clamp(
        torch.linalg.norm(viewdirs, dim=-1, keepdim=True), min=1e-12)
    coeffs = torch.cat([features_dc[..., None, :], features_rest], dim=-2)
    return torch.clamp(
        spherical_harmonics(degrees_to_use, viewdirs, coeffs) + 0.5,
        min=0.0)  # model.cpp:192
