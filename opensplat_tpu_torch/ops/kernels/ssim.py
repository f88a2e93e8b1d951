"""SSIM's forward and its gradient with respect to the rendered image
(the SSIM kernel pair).

Replaces no Pallas kernel: the JAX package's ssim is jnp, its blur two
banded matmuls that XLA runs on the TPU's matrix unit. CUDA source:
csrc/ssim.cu — a separable 11-tap stencil over tiles of 16 x 32 pixels,
the backward recomputing the forward's statistics over the tile and its
halo; bytes and operations bound it alike (see the source note there).

`ssim_forward_plain` and `ssim_backward_plain` are the same functions in
plain PyTorch: each blur is the 11 taps as shifted slices in the
kernel's order (along rows, then columns), the backward the explicit
chain rule through the three fields P, Q, R and the transposed blur
with the flipped window. A pixel's blurred statistics, fields and
gradient are the kernel's bits; the mean is PyTorch's. The wrappers take
them only for CPU tensors. `ssim_direct` is the reference's formula in
float64, which the tests and chip_smoke.py hold both to.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from . import _lib

WINDOW = 11
RADIUS = WINDOW // 2
TILE_H, TILE_W = 16, 32  # a kernel block's output tile (csrc/ssim.cu)
C1 = float(np.float32(0.01 ** 2))
C2 = float(np.float32(0.03 ** 2))


def gauss_1d() -> np.ndarray:
    """The reference's asymmetric window of 11 taps, sigma 1.5
    (ssim.cpp:43: exp(-floor((i - 11) / 2)^2 / (2 sigma^2)), normalised),
    float32."""
    i = np.arange(WINDOW, dtype=np.float64)
    k = np.floor((i - WINDOW) / 2.0)
    g = np.exp(-(k ** 2) / (2.0 * 1.5 * 1.5))
    return (g / g.sum()).astype(np.float32)


TAPS = tuple(float(v) for v in gauss_1d())
_TAPS_C = (ctypes.c_float * WINDOW)(*TAPS)


def _taps_along(f: torch.Tensor, dim: int, flip: bool) -> torch.Tensor:
    """sum_k TAPS[k] f[i + k - 5] along `dim` (flip: f[i + 5 - k], the
    transpose), zero outside, k = 0..10 in order."""
    n = f.shape[dim]
    fp = F.pad(f, [0, 0] * (f.dim() - 1 - dim) + [RADIUS, RADIUS])
    out = None
    for k, g in enumerate(TAPS):
        term = g * fp.narrow(dim, 2 * RADIUS - k if flip else k, n)
        out = term if out is None else out + term
    return out


def _blur(f, flip=False):
    """The separable blur of (H, W, C) (flip: its transpose), along rows
    (W) first, then columns (H)."""
    return _taps_along(_taps_along(f, 1, flip), 0, flip)


def _map_terms(img1, img2):
    """(mu1, mu2, a1, a2, d1, d2) of the SSIM map a1 a2 / (d1 d2)."""
    mu1, mu2 = _blur(img1), _blur(img2)
    e11, e22 = _blur(img1 * img1), _blur(img2 * img2)
    e12 = _blur(img1 * img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s11, s22, s12 = e11 - mu1_sq, e22 - mu2_sq, e12 - mu1_mu2
    return (mu1, mu2, 2.0 * mu1_mu2 + C1, 2.0 * s12 + C2,
            (mu1_sq + mu2_sq) + C1, (s11 + s22) + C2)


def ssim_forward_plain(img1, img2):
    """Mean SSIM map of img2 (rendered) against img1 (gt), (H, W, 3)."""
    _, _, a1, a2, d1, d2 = _map_terms(img1, img2)
    return ((a1 * a2) / (d1 * d2)).mean()


def ssim_backward_plain(img1, img2, grad_out):
    """grad_out * d mean(SSIM map) / d img2: the fields P = dS/dmu2 - 2
    mu2 Q - mu1 R, Q = dS/dsigma2^2, R = dS/dsigma12, each through the
    transposed blur."""
    mu1, mu2, a1, a2, d1, d2 = _map_terms(img1, img2)
    den = d1 * d2
    s = (a1 * a2) / den
    q = -(s / d2)
    r = (2.0 * a1) / den
    p = ((2.0 * mu1) * a2) / den
    p = p - ((2.0 * mu2) * s) / d1
    p = p - (2.0 * mu2) * q
    p = p - mu1 * r
    scale = grad_out * _inv_count(img2)
    return ((_blur(p, True) + (2.0 * img2) * _blur(q, True))
            + img1 * _blur(r, True)) * scale


def ssim_direct(rendered, gt):
    """The reference's SSIM (ssim.cpp) in float64, the yardstick the
    plain version and the kernels are held to: the 11 x 11 window as one
    grouped 2-D convolution with zero padding, gt as img1, on the images'
    device; differentiable in `rendered`."""
    g = torch.from_numpy(gauss_1d()).to(gt.device, torch.float64)
    win = torch.outer(g, g)[None, None].expand(3, 1, WINDOW, WINDOW)
    win = win.contiguous()

    def conv(x):
        return F.conv2d(x, win, padding=RADIUS, groups=3)

    x = gt.double().permute(2, 0, 1)[None]
    y = rendered.double().permute(2, 0, 1)[None]
    mu1, mu2 = conv(x), conv(y)
    s11 = conv(x * x) - mu1 * mu1
    s22 = conv(y * y) - mu2 * mu2
    s12 = conv(x * y) - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return (((2 * mu1 * mu2 + c1) * (2 * s12 + c2))
            / ((mu1 * mu1 + mu2 * mu2 + c1) * (s11 + s22 + c2))).mean()


def _inv_count(img) -> float:
    return float(np.float32(1.0 / img.numel()))


def _check(img1, img2):
    if img1.dim() != 3 or img1.shape[2] != 3 or img1.numel() == 0:
        raise ValueError(f"ssim: expected (H, W, 3) images, got "
                         f"{tuple(img1.shape)}")
    _lib.check(img1, "img1", torch.float32)
    _lib.check(img2, "img2", torch.float32, tuple(img1.shape))


def ssim_forward(img1, img2):
    """Mean SSIM of img2 (rendered) against img1 (gt), two (H, W, 3)
    float32 images, as a 0-d tensor. On the card one call launches the
    tile kernel and the one-block mean pass."""
    if not img2.is_cuda:
        return ssim_forward_plain(img1, img2)
    _check(img1, img2)
    h, w = img1.shape[0], img1.shape[1]
    tiles = -(-h // TILE_H) * -(-w // TILE_W)
    partials = torch.empty(tiles, dtype=torch.float32, device=img1.device)
    out = torch.empty((), dtype=torch.float32, device=img1.device)
    p = _lib.ptr
    with _lib.timed("ssim_fwd"):
        _lib.launch("osk_ssim_fwd", h, w, p(img1), p(img2),
                    ctypes.cast(_TAPS_C, ctypes.c_void_p), p(partials),
                    p(out))
    ssim_forward.launches += 1
    return out


def ssim_backward(img1, img2, grad_out):
    """grad_out (a 0-d tensor) times d ssim_forward / d img2, (H, W, 3)."""
    if not img2.is_cuda:
        return ssim_backward_plain(img1, img2, grad_out)
    _check(img1, img2)
    _lib.check(grad_out, "grad_out", torch.float32, ())
    h, w = img1.shape[0], img1.shape[1]
    grad = torch.empty_like(img2)
    p = _lib.ptr
    with _lib.timed("ssim_bwd"):
        _lib.launch("osk_ssim_bwd", h, w, p(img1), p(img2),
                    ctypes.cast(_TAPS_C, ctypes.c_void_p), p(grad_out),
                    ctypes.c_float(_inv_count(img2)), p(grad))
    ssim_backward.launches += 1
    return grad


ssim_forward.launches = 0
ssim_backward.launches = 0


def kernel_info() -> dict:
    """The tile and what the CUDA runtime reports of both kernels' builds
    (registers, shared memory a CTA, resident CTAs an SM)."""
    return _lib.kernel_info(
        "osk_ssim_info",
        ("tile_h", "tile_w", "fwd_registers", "fwd_smem_bytes",
         "fwd_ctas_per_sm", "bwd_registers", "bwd_smem_bytes",
         "bwd_ctas_per_sm"))
