"""SSIM loss, L1, PSNR and the training loss on tensors.

Counterpart of opensplat_tpu/ops/ssim.py, including the reference's
asymmetric Gaussian window (ssim.cpp:43: exp(-floor((i - ws) / 2)^2 /
(2 sigma^2))). The separable 11x11 blur is two float32 matmuls with
banded matrices, as in the JAX package. They run at "highest" float32
matmul precision: the E[x^2] - E[x]^2 variance needs full float32, and
TF32 would corrupt it. No cuDNN convolution is used (TF32 by default).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from .views import per_view


def _gauss_1d(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    i = np.arange(window_size, dtype=np.float64)
    k = np.floor((i - window_size) / 2.0)
    g = np.exp(-(k ** 2) / (2.0 * sigma * sigma))
    return (g / g.sum()).astype(np.float32)


def _band_matrix(n: int, g1d: np.ndarray) -> np.ndarray:
    """B[i, j] = g1d[j - i + pad]: B @ x is the zero-padded 'same'
    1D convolution of x with g1d."""
    k = len(g1d)
    pad = k // 2
    b = np.zeros((n, n), np.float32)
    for off in range(-pad, pad + 1):
        b += np.diag(np.full(n - abs(off), g1d[off + pad], np.float32), k=off)
    return b


_blur_cache: dict = {}


def _blur_mats(h: int, w: int, device):
    key = (h, w, str(device))
    if key not in _blur_cache:
        g = _gauss_1d()
        _blur_cache[key] = (
            torch.from_numpy(_band_matrix(h, g)).to(device),
            torch.from_numpy(_band_matrix(w, g)).to(device),
        )
    return _blur_cache[key]


@contextlib.contextmanager
def _highest_matmul_precision():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _blur(img: torch.Tensor, bh: torch.Tensor, bw: torch.Tensor):
    """Separable 'same' blur of (H, W, C): rows by bh, columns by bw."""
    h, w, c = img.shape
    t = (bh @ img.reshape(h, w * c)).reshape(h, w, c)
    return bw @ t  # (W, W) @ (H, W, C) batched over H


def ssim(rendered: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Mean SSIM between two (H, W, 3) images in [0, 1] (img1 = gt,
    img2 = rendered, as ssim.cpp:9-10)."""
    h, w = gt.shape[0], gt.shape[1]
    bh, bw = _blur_mats(h, w, gt.device)
    img1 = gt.to(torch.float32)
    img2 = rendered.to(torch.float32)
    with _highest_matmul_precision():
        mu1 = _blur(img1, bh, bw)
        mu2 = _blur(img2, bh, bw)
        mu1_sq = mu1 * mu1
        mu2_sq = mu2 * mu2
        mu1_mu2 = mu1 * mu2
        sigma1_sq = _blur(img1 * img1, bh, bw) - mu1_sq
        sigma2_sq = _blur(img2 * img2, bh, bw) - mu2_sq
        sigma12 = _blur(img1 * img2, bh, bw) - mu1_mu2
    c1 = 0.01 ** 2
    c2 = 0.03 ** 2
    ssim_map = ((2.0 * mu1_mu2 + c1) * (2.0 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )
    return ssim_map.mean()


def l1(rendered: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Mean absolute error (model.cpp:54-56)."""
    return (gt - rendered).abs().mean()


def psnr(rendered: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB (model.cpp:49-52); (V,) per view
    for (V, H, W, 3) images."""
    if rendered.dim() == 4:
        return per_view(psnr, rendered.shape[0], rendered, gt)
    mse = ((rendered - gt) ** 2).mean()
    return 10.0 * torch.log10(1.0 / mse)


def main_loss(rendered: torch.Tensor, gt: torch.Tensor,
              ssim_weight: float) -> torch.Tensor:
    """(1 - w) * L1 + w * (1 - SSIM) (model.cpp:780-784); (V,) per view
    for (V, H, W, 3) images, each taken on its view alone."""
    if rendered.dim() == 4:
        return per_view(lambda r, g: main_loss(r, g, ssim_weight),
                        rendered.shape[0], rendered, gt)
    return (1.0 - ssim_weight) * l1(rendered, gt) + ssim_weight * (
        1.0 - ssim(rendered, gt)
    )
