"""Plain PyTorch reference of OpenSplat's training step (opensplat.cpp:
151-196, model.cpp:54-56 and 780-784, ssim.cpp): render, loss
(1 - w) L1 + w (1 - SSIM), gradients, and Adam on the six parameter
groups (torch::optim::Adam, one step count each, betas 0.9 and 0.999,
eps 1e-8), with the means' log-linear learning-rate decay.

Imports nothing of the program. SSIM is the reference's: an 11-tap
Gaussian window of sigma 1.5 in its asymmetric form (ssim.cpp:43,
exp(-floor((i - 11) / 2)^2 / (2 sigma^2))), as a separable zero-padded
convolution, img1 the ground truth.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict

import torch
import torch.nn.functional as F

from .render import Camera, render

PARAMS = ("means", "scales", "quats", "features_dc", "features_rest",
          "opacities")
BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


@contextlib.contextmanager
def precision(tf32: bool):
    """Matrix products and convolutions in float32 (tf32=False) or with
    TF32 allowed (tf32=True, the lower precision a later change might
    take); the previous switches are restored."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.backends.cudnn.allow_tf32 = prev[1]
        torch.set_float32_matmul_precision(prev[2])


def _window(device) -> torch.Tensor:
    i = torch.arange(11, dtype=torch.float64)
    g = torch.exp(-torch.floor((i - 11) / 2.0) ** 2 / (2.0 * 1.5 ** 2))
    return (g / g.sum()).to(torch.float32).to(device)


def _blur(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """(1, 3, H, W) blurred along H then W, zero padding, same size."""
    x = F.conv2d(x, g.view(1, 1, 11, 1).expand(3, 1, 11, 1).contiguous(),
                 padding=(5, 0), groups=3)
    return F.conv2d(x, g.view(1, 1, 1, 11).expand(3, 1, 1, 11).contiguous(),
                    padding=(0, 5), groups=3)


def ssim(gt: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of two (H, W, 3) images (ssim.cpp:9-41)."""
    g = _window(gt.device)
    x = gt.permute(2, 0, 1)[None]
    y = img.permute(2, 0, 1)[None]
    mu_x, mu_y = _blur(x, g), _blur(y, g)
    var_x = _blur(x * x, g) - mu_x * mu_x
    var_y = _blur(y * y, g) - mu_y * mu_y
    cov = _blur(x * y, g) - mu_x * mu_y
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    num = (2 * mu_x * mu_y + c1) * (2 * cov + c2)
    den = (mu_x * mu_x + mu_y * mu_y + c1) * (var_x + var_y + c2)
    return (num / den).mean()


def loss_fn(img: torch.Tensor, gt: torch.Tensor, ssim_weight: float):
    return ((1.0 - ssim_weight) * (gt - img).abs().mean()
            + ssim_weight * (1.0 - ssim(gt, img)))


def means_lr(cfg: Dict, step: int) -> float:
    """The means' rate at `step`: the scheduler steps after the
    optimizer, so step t uses the decay at t - 1 (optim_scheduler.cpp)."""
    t = min(max((step - 1) / cfg["num_iters"], 0.0), 1.0)
    return math.exp(math.log(cfg["lr_means"]) * (1 - t)
                    + math.log(cfg["lr_means_final"]) * t)


def step_grads(params: Dict[str, torch.Tensor], alive: torch.Tensor,
               cam: Camera, gt: torch.Tensor, cfg: Dict):
    """(loss, psnr, gradients by parameter) of one view."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    bg = torch.tensor(cfg["background"], dtype=torch.float32,
                      device=gt.device)
    image, raster, fields = render(leaves, alive, cam, bg)
    img = image.clone().requires_grad_(True)
    out = torch.clamp(img, max=1.0)
    loss = loss_fn(out, gt, cfg["ssim_weight"])
    loss.backward()
    with torch.no_grad():
        psnr = 10.0 * torch.log10(1.0 / ((out - gt) ** 2).mean())
    torch.autograd.backward(fields, raster.backward(img.grad))
    grads = {k: leaves[k].grad if leaves[k].grad is not None
             else torch.zeros_like(leaves[k]) for k in PARAMS}
    return float(loss.detach()), float(psnr), grads


class Adam:
    """Masked Adam over the six groups, moments from zero."""

    def __init__(self, params: Dict[str, torch.Tensor]):
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, params, grads, lrs, alive):
        self.count += 1
        bc1 = 1.0 - BETA1 ** self.count
        bc2 = 1.0 - BETA2 ** self.count
        for k, p in params.items():
            g = grads[k]
            keep = alive.reshape((-1,) + (1,) * (p.dim() - 1))
            m = torch.where(keep, BETA1 * self.m[k] + (1 - BETA1) * g,
                            self.m[k])
            v = torch.where(keep, BETA2 * self.v[k] + (1 - BETA2) * g * g,
                            self.v[k])
            upd = lrs[k] * (m / bc1) / (torch.sqrt(v / bc2) + EPS)
            p.sub_(torch.where(keep, upd, 0.0))
            self.m[k], self.v[k] = m, v


def learning_rates(cfg: Dict, step: int) -> Dict[str, float]:
    return {"means": means_lr(cfg, step), "scales": cfg["lr_scales"],
            "quats": cfg["lr_quats"], "features_dc": cfg["lr_features_dc"],
            "features_rest": cfg["lr_features_rest"],
            "opacities": cfg["lr_opacities"]}
