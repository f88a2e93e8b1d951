"""SSIM loss, L1, PSNR and the training loss on tensors.

Counterpart of opensplat_tpu/ops/ssim.py, including the reference's
asymmetric Gaussian window (ssim.cpp:43: exp(-floor((i - ws) / 2)^2 /
(2 sigma^2))). SSIM and its gradient with respect to the rendered image
are the kernel pair of ops/kernels/ssim.py (an 11-tap separable stencil
in float32) on the card, and its plain version on the CPU.
"""
from __future__ import annotations

import torch

from ..utils.metrics import span
from .kernels import ssim as kssim
from .views import per_view


class _Ssim(torch.autograd.Function):
    """Mean SSIM of img2 (rendered) against img1 (gt), differentiable in
    img2 alone."""

    @staticmethod
    def forward(ctx, img2, img1):
        ctx.save_for_backward(img1, img2)
        return kssim.ssim_forward(img1, img2)

    @staticmethod
    def backward(ctx, grad):
        img1, img2 = ctx.saved_tensors
        return kssim.ssim_backward(img1, img2, grad), None


def ssim(rendered: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Mean SSIM between two (H, W, 3) images in [0, 1] (img1 = gt,
    img2 = rendered, as ssim.cpp:9-10). Differentiable in `rendered`;
    a `gt` that requires grad raises."""
    with span("loss.ssim"):
        if gt.requires_grad and torch.is_grad_enabled():
            raise ValueError("ssim: no gradient with respect to the ground "
                             "truth; pass it detached")
        img1 = gt.to(torch.float32).contiguous()
        img2 = rendered.to(torch.float32).contiguous()
        return _Ssim.apply(img2, img1)


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
