"""Gaussian parameter set on a fixed capacity with an alive mask.

Counterpart of opensplat_tpu/models/gaussians.py: six learnable tensors
(model.hpp:81-86) at capacity C >= the alive count; dead rows are frozen
by the masked Adam and excluded from rendering by the alive mask.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Dict, Optional

import numpy as np
import torch
from scipy.spatial import cKDTree

from .._device import resolve_device
from ..ops.sh import num_sh_bases, rgb_to_sh
from ..ops.tensor_math import morton_order, random_quat
from ..optim.adam import AdamState, adam_init

PARAM_NAMES = ("means", "scales", "quats", "features_dc", "features_rest",
               "opacities")


@dataclass
class GaussianParams:
    means: torch.Tensor  # (C, 3)
    scales: torch.Tensor  # (C, 3) log-scales
    quats: torch.Tensor  # (C, 4) wxyz
    features_dc: torch.Tensor  # (C, 3) SH degree-0 coefficients
    features_rest: torch.Tensor  # (C, B-1, 3) higher SH coefficients
    opacities: torch.Tensor  # (C, 1) logits

    def as_dict(self) -> Dict[str, torch.Tensor]:
        return {f.name: getattr(self, f.name) for f in fields(self)}


@dataclass
class DensifyStats:
    xys_grad_norm: torch.Tensor  # (C,)
    vis_counts: torch.Tensor  # (C,)
    max_2d_size: torch.Tensor  # (C,)
    initialized: torch.Tensor  # () bool


@dataclass
class TrainState:
    params: GaussianParams
    alive: torch.Tensor  # (C,) bool
    opt: AdamState
    stats: DensifyStats

    @property
    def device(self) -> torch.device:
        return self.alive.device


def zero_stats(capacity: int, device) -> DensifyStats:
    """Cleared statistics on `device` (no default: refine clears them on
    the state's device at every boundary)."""
    z = torch.zeros((capacity,), dtype=torch.float32, device=device)
    return DensifyStats(
        xys_grad_norm=z, vis_counts=z.clone(), max_2d_size=z.clone(),
        initialized=torch.zeros((), dtype=torch.bool, device=device),
    )


def knn_mean_scale(points: np.ndarray) -> np.ndarray:
    """Mean distance to the 3 nearest neighbours (kdtree_tensor.cpp)."""
    d, _ = cKDTree(points).query(points, k=4)  # d[:, 0] == 0 (self)
    return d[:, 1:].mean(axis=1).astype(np.float32)


def round_capacity(n: int, rounding: int = 4096) -> int:
    return max(rounding, ((n + rounding - 1) // rounding) * rounding)


def init_model(
    points_xyz: np.ndarray,
    points_rgb: np.ndarray,
    sh_degree: int,
    capacity: Optional[int] = None,
    capacity_mult: float = 1.5,
    capacity_round: int = 4096,
    seed: int = 42,
    device="cuda",
) -> TrainState:
    """Initial TrainState from SfM points (model.hpp:34-56): means =
    points in Morton order, scales = log(knn mean distance) x3, random
    unit quats from a torch.Generator seeded with `seed`, SH0 =
    rgb2sh(rgb / 255), opacity = logit(0.1). points_rgb is (N, 3) uint8."""
    dev = resolve_device(device)
    n = points_xyz.shape[0]
    if capacity is None:
        capacity = round_capacity(int(n * capacity_mult), capacity_round)
    assert capacity >= n, f"capacity {capacity} < point count {n}"
    perm = morton_order(points_xyz)
    points_xyz = points_xyz[perm]
    points_rgb = points_rgb[perm]
    c = capacity

    means = np.zeros((c, 3), np.float32)
    means[:n] = points_xyz.astype(np.float32)
    scales = np.zeros((c, 3), np.float32)
    scales[:n] = np.log(np.maximum(knn_mean_scale(points_xyz), 1e-10))[:, None]
    quats = np.zeros((c, 4), np.float32)
    quats[:, 0] = 1.0  # dead rows stay valid rotations
    quats[:n] = random_quat(n, torch.Generator().manual_seed(seed)).numpy()
    f_dc = np.zeros((c, 3), np.float32)
    f_dc[:n] = rgb_to_sh(points_rgb.astype(np.float64) / 255.0)
    f_rest = np.zeros((c, num_sh_bases(sh_degree) - 1, 3), np.float32)
    opac = np.zeros((c, 1), np.float32)
    opac[:n] = float(np.log(0.1 / 0.9))  # logit(0.1)
    alive = np.zeros((c,), bool)
    alive[:n] = True

    params = GaussianParams(*(torch.from_numpy(a).to(dev) for a in
                              (means, scales, quats, f_dc, f_rest, opac)))
    return TrainState(
        params=params,
        alive=torch.from_numpy(alive).to(dev),
        opt=adam_init(params.as_dict()),
        stats=zero_stats(c, dev),
    )


def grow_capacity(state: TrainState, new_capacity: int) -> TrainState:
    """Every (C, ...) tensor zero-padded to `new_capacity` rows: params,
    alive (False), Adam mu and nu, stats. Padded quats are [1, 0, 0, 0],
    valid rotations; opt.count and stats.initialized are kept. Returns a
    new state: no tensor of the old one is reused."""
    old_c = state.alive.shape[0]
    assert new_capacity > old_c, (new_capacity, old_c)

    def pad(x):
        out = x.new_zeros((new_capacity,) + tuple(x.shape[1:]))
        out[:old_c] = x
        return out

    params = GaussianParams(**{k: pad(v) for k, v in
                               state.params.as_dict().items()})
    params.quats[old_c:, 0] = 1.0
    s = state.stats
    return TrainState(
        params=params,
        alive=pad(state.alive),
        opt=AdamState(mu={k: pad(v) for k, v in state.opt.mu.items()},
                      nu={k: pad(v) for k, v in state.opt.nu.items()},
                      count=state.opt.count),
        stats=DensifyStats(
            xys_grad_norm=pad(s.xys_grad_norm),
            vis_counts=pad(s.vis_counts),
            max_2d_size=pad(s.max_2d_size),
            initialized=s.initialized.clone(),
        ),
    )


def state_map(fn, *states: TrainState,
              capacity_only: bool = False) -> TrainState:
    """A TrainState whose every tensor is fn of the given states' tensors
    at that place: params, alive, Adam mu and nu, and stats; with
    capacity_only, stats.initialized (0-d) is the first state's, kept.
    The Adam count is the first state's."""
    first = states[0]

    def each(get):
        return fn(*(get(s) for s in states))

    stats = DensifyStats(
        xys_grad_norm=each(lambda s: s.stats.xys_grad_norm),
        vis_counts=each(lambda s: s.stats.vis_counts),
        max_2d_size=each(lambda s: s.stats.max_2d_size),
        initialized=(first.stats.initialized if capacity_only
                     else each(lambda s: s.stats.initialized)),
    )
    return TrainState(
        params=GaussianParams(**{k: each(lambda s: getattr(s.params, k))
                                 for k in PARAM_NAMES}),
        alive=each(lambda s: s.alive),
        opt=AdamState(mu={k: each(lambda s: s.opt.mu[k]) for k in PARAM_NAMES},
                      nu={k: each(lambda s: s.opt.nu[k]) for k in PARAM_NAMES},
                      count=first.opt.count),
        stats=stats,
    )


def state_from_numpy(d: dict, device="cuda") -> TrainState:
    """TrainState from numpy leaves, e.g. those of a JAX TrainState:
    d = {"params": {name: array for PARAM_NAMES}, "alive": (C,) bool,
         "mu": {name: array}, "nu": {name: array}, "count": int,
         "stats": {"xys_grad_norm", "vis_counts", "max_2d_size",
                   "initialized"}}."""
    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    params = GaussianParams(**{k: t(np.asarray(d["params"][k], np.float32))
                               for k in PARAM_NAMES})
    opt = AdamState(
        mu={k: t(np.asarray(d["mu"][k], np.float32)) for k in PARAM_NAMES},
        nu={k: t(np.asarray(d["nu"][k], np.float32)) for k in PARAM_NAMES},
        count=int(d["count"]),
    )
    s = d["stats"]
    stats = DensifyStats(
        xys_grad_norm=t(np.asarray(s["xys_grad_norm"], np.float32)),
        vis_counts=t(np.asarray(s["vis_counts"], np.float32)),
        max_2d_size=t(np.asarray(s["max_2d_size"], np.float32)),
        initialized=t(np.asarray(s["initialized"], bool)),
    )
    return TrainState(params=params, alive=t(np.asarray(d["alive"], bool)),
                      opt=opt, stats=stats)
