"""Masked Adam, matching torch::optim::Adam semantics per parameter group.

Counterpart of opensplat_tpu/optim/adam.py. Dead capacity rows are frozen
(values and moments untouched); the six parameter groups step together,
so one shared step count reproduces the reference's six Adam instances
(model.cpp:58-69). Unlike the functional JAX version, `adam_update`
updates parameters and moments IN PLACE.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import torch

BETA1 = 0.9
BETA2 = 0.999
EPS = 1e-8


@dataclass
class AdamState:
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    count: int = 0


def adam_init(params: Dict[str, torch.Tensor]) -> AdamState:
    return AdamState(
        mu={k: torch.zeros_like(v) for k, v in params.items()},
        nu={k: torch.zeros_like(v) for k, v in params.items()},
        count=0,
    )


@torch.no_grad()
def adam_update(params: Dict[str, torch.Tensor],
                grads: Dict[str, torch.Tensor], opt: AdamState,
                lrs: Dict[str, float], alive: torch.Tensor) -> None:
    """One masked Adam step, in place: params, opt.mu, opt.nu and
    opt.count change; rows where `alive` is False keep their values and
    moments. Stacked states (leaves (V, C, ...), alive (V, C), one shared
    count) step together, elementwise, each scene as its own call."""
    opt.count += 1
    c = float(opt.count)
    bc1 = 1.0 - BETA1 ** c
    bc2 = 1.0 - BETA2 ** c
    for name, p in params.items():
        g = grads[name]
        m, v = opt.mu[name], opt.nu[name]
        mask = alive.reshape(alive.shape + (1,) * (p.dim() - alive.dim())
                             ).to(p.dtype)
        m_new = BETA1 * m + (1.0 - BETA1) * g
        v_new = BETA2 * v + (1.0 - BETA2) * (g * g)
        step = lrs[name] * (m_new / bc1) / (torch.sqrt(v_new / bc2) + EPS)
        p.sub_(mask * step)
        m.copy_(mask * m_new + (1.0 - mask) * m)
        v.copy_(mask * v_new + (1.0 - mask) * v)


def means_lr_schedule(lr_init: float, lr_final: float, max_steps: int,
                      step) -> float:
    """Log-linear decay (optim_scheduler.cpp:4-8). The reference steps the
    scheduler after the optimizer, so the optimizer at step t uses
    lr(t - 1) with lr(0) = lr_init: pass step - 1."""
    t = min(max(step / max_steps, 0.0), 1.0)
    return math.exp(math.log(lr_init) * (1.0 - t) + math.log(lr_final) * t)
