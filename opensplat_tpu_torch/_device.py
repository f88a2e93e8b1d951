"""Device resolution shared by every entry point.

CUDA is the default. A missing card is an error, never a silent switch
to the CPU: the CPU runs the kernels' plain PyTorch versions and is
taken only when the caller asks for it.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "opensplat_tpu_torch: CUDA is not available. The port runs on "
            "an NVIDIA GPU by default; pass device='cpu' to run the plain "
            "PyTorch versions of its kernels instead."
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
