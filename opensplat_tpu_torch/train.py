"""One training step and the host-side training loop.

Counterpart of opensplat_tpu/train.py (reference opensplat.cpp:151-196):
forward, L1 + SSIM loss, backward, masked Adam on the six parameter
groups, the means learning-rate schedule and the densify statistics;
refine with capacity growth every refine_every steps past warm-up; and
the inference render. Every entry point takes `renderer`: "fast" (the
port's kernels, the default), or the conformance renderers "dense" and
"tiled" (the JAX Trainer's default is "dense"). PyTorch runs eagerly, so
there is no jit and no static budget: the intersection streams are
sized exactly each step (one device-to-host read of the candidate
total), and the demand counters n_cands, n_isects and n_grads are
reported with the JAX package's meaning.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from functools import partial
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ._device import resolve_device
from .config import TrainConfig
from .models.densify import accumulate_stats, count_refine_needs, refine_step
from .models.gaussians import (PARAM_NAMES, GaussianParams, TrainState,
                               grow_capacity, round_capacity, zero_stats)
from .models.splat_model import DEFAULT_BACKGROUND, render_forward
from .ops.ssim import main_loss, psnr
from .optim.adam import adam_update, means_lr_schedule
from .utils.metrics import count, host_sync, span


def get_downscale_factor(step: int, cfg: TrainConfig) -> int:
    """2^max(num_downscales - step / resolution_schedule, 0) (model.cpp:249-251)."""
    return 2 ** max(cfg.num_downscales - step // cfg.resolution_schedule, 0)


def sh_degrees_for_step(step: int, cfg: TrainConfig) -> int:
    """min(step / sh_degree_interval, sh_degree) (model.cpp:178)."""
    return min(step // cfg.sh_degree_interval, cfg.sh_degree)


def learning_rates(cfg: TrainConfig, means_lr: float) -> dict:
    """The six parameter groups' learning rates for one step."""
    return {
        "means": means_lr,
        "scales": cfg.lr_scales,
        "quats": cfg.lr_quats,
        "features_dc": cfg.lr_features_dc,
        "features_rest": cfg.lr_features_rest,
        "opacities": cfg.lr_opacities,
    }


def leaf_grads(loss: torch.Tensor, leaves: dict, shift: torch.Tensor):
    """Gradients of `loss` for the six parameter groups (`leaves`, by
    name; zeros for a group the loss does not reach) and for the xys
    shift."""
    grads = torch.autograd.grad(loss, [leaves[k] for k in PARAM_NAMES]
                                + [shift], allow_unused=True)
    return {k: (g if g is not None else torch.zeros_like(leaves[k]))
            for k, g in zip(PARAM_NAMES, grads[:-1])}, grads[-1]


def background(device) -> torch.Tensor:
    """DEFAULT_BACKGROUND on `device`, in one blocking upload."""
    with host_sync("background", device):
        return torch.tensor(DEFAULT_BACKGROUND, dtype=torch.float32,
                            device=device)


def render_views(state: TrainState, cam_to_world: torch.Tensor, fx, fy, cx,
                 cy, height: int, width: int, sh_deg: int, renderer: str):
    """step_core's render of the step's views over `state`'s Gaussians:
    (params, xys shift, background) -> render_forward's outputs."""
    def render(params, shift, bg):
        return render_forward(
            params, state.alive, cam_to_world, fx, fy, cx, cy, height, width,
            sh_deg, bg, xys_shift=shift, renderer=renderer,
            device=state.device)
    return render


def step_core(state: TrainState, render, gt_image: torch.Tensor,
              cfg: TrainConfig, means_lr: float, fold, report, views=(),
              reduce=None, sum_grads=None):
    """The body every training step shares. Renders the parameter groups
    as leaves (`render(params, xys_shift, background)`, an output with
    .rgb and .radii), takes main_loss against `gt_image`, optionally
    `reduce`d (a camera batch's sum and scale), and the gradients of its
    sum; `sum_grads` may combine the parameter gradients over ranks
    before the masked Adam update; `fold(stats, g_xys, radii)`, unless
    None, gives the new densify statistics. `views` are the leading axes
    of the cameras that share the state's Gaussians, each with its own
    xys shift. Updates `state` in place and returns report(outputs,
    loss), taken without gradients."""
    with span("step"):
        dev = state.device
        bg = background(dev)
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in state.params.as_dict().items()}
        xys_shift = torch.zeros(tuple(views) + state.alive.shape + (2,),
                                dtype=torch.float32, device=dev,
                                requires_grad=True)
        with span("step.render"):
            out = render(GaussianParams(**leaves), xys_shift, bg)
        with span("step.loss"):
            loss = main_loss(out.rgb, gt_image, cfg.ssim_weight)
            if reduce is not None:
                loss = reduce(loss)
        with span("step.backward"):
            g_params, g_xys = leaf_grads(loss.sum() if loss.dim() else loss,
                                         leaves, xys_shift)
        if sum_grads is not None:
            g_params = sum_grads(g_params)
        with span("step.adam"):
            adam_update(state.params.as_dict(), g_params, state.opt,
                        learning_rates(cfg, means_lr), state.alive)
        with span("step.stats"):
            if fold is not None:
                state.stats = fold(state.stats, g_xys, out.radii)
            with torch.no_grad():
                return report(out, loss.detach())


def train_step_impl(
    state: TrainState,
    cam_to_world: torch.Tensor,
    fx,
    fy,
    cx,
    cy,
    gt_image: torch.Tensor,
    means_lr: float,
    height: int,
    width: int,
    sh_deg: int,
    cfg: TrainConfig,
    accumulate: bool,
    renderer: str = "fast",
):
    """One optimisation step. Updates `state` in place (parameters, Adam
    moments and count, stats) and returns (state, metrics); metrics are
    device tensors, read only when the caller asks.

    V scenes in one step, the counterpart of the JAX package's
    jax.vmap(train_step_impl): a state stacked along a leading scene
    axis (parallel/multi_scene.py::stack_states, one shared Adam count),
    cam_to_world (V, 4, 4), fx, fy, cx, cy V values each, gt_image
    (V, H, W, 3); metrics per scene, (V,). With the fast renderer every
    kernel launches once, the stream is sorted and sized once (one host
    read) and Adam updates once for all scenes; each scene's loss and
    state are the bits of its own step."""
    def report(out, loss):
        return {
            "loss": loss,
            "psnr": psnr(out.rgb, gt_image),
            "n_visible": out.mask.sum(-1),
            "n_isects": out.n_isects,
            "n_cands": out.n_cands,
            "n_grads": out.n_grads,
            "n_alive": state.alive.sum(-1),
        }
    return state, step_core(
        state, render_views(state, cam_to_world, fx, fy, cx, cy, height,
                            width, sh_deg, renderer),
        gt_image, cfg, means_lr,
        partial(accumulate_stats, height=height, width=width)
        if accumulate else None, report)


def train_step(state: TrainState, *args, device="cuda", **kwargs):
    """train_step_impl on `device` (CUDA unless the caller asks for the
    CPU); the state must already live there."""
    dev = resolve_device(device)
    if state.device.type != dev.type:
        raise ValueError(f"train_step: state is on {state.device}, "
                         f"device={device!r}")
    return train_step_impl(state, *args, **kwargs)


class InfiniteRandomSampler:
    """Reshuffling camera sampler (utils.hpp:14-38 semantics, numpy RNG).

    `draws` counts every next(), so a resumed run can fast_forward() to
    the position a checkpoint recorded and replay the uninterrupted
    run's camera order."""

    def __init__(self, n: int, seed: int = 42):
        self._rng = np.random.default_rng(seed)
        self._n = n
        self._order = self._rng.permutation(n)
        self._i = 0
        self.draws = 0

    def next(self) -> int:
        idx = int(self._order[self._i])
        self._i += 1
        self.draws += 1
        if self._i >= self._n:
            self._order = self._rng.permutation(self._n)
            self._i = 0
        return idx

    def fast_forward(self, n_draws: int) -> None:
        """Advance to the state after `n_draws` next() calls from fresh."""
        for _ in range(max(0, int(n_draws))):
            self.next()
        self.draws = max(0, int(n_draws))


def refine_generator(seed: int, step: int, device) -> torch.Generator:
    """The split noise's generator for the refine at `step`: seeded from
    (seed, step) alone, the counterpart of the JAX package's
    fold_in(key, step), so a run resumed from a checkpoint (or a PLY)
    draws the noise the uninterrupted run drew."""
    return torch.Generator(device=device).manual_seed(
        ((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF))


class StepPlan(NamedTuple):
    """What a step's number sets: the image downscale factor, the means
    learning rate, the SH degree, and whether the densify statistics
    fold (step < stop_split_at)."""
    factor: int
    means_lr: float
    sh_deg: int
    accumulate: bool


def step_plan(step: int, cfg: TrainConfig) -> StepPlan:
    """The schedules at `step` (the reference's scheduler steps after the
    optimizer, hence lr(step - 1))."""
    return StepPlan(get_downscale_factor(step, cfg),
                    means_lr_schedule(cfg.lr_means, cfg.lr_means_final,
                                      cfg.num_iters, step - 1),
                    sh_degrees_for_step(step, cfg), step < cfg.stop_split_at)


def stage_cameras(cams, factor: int, device):
    """Drawn cameras for a step or a render on `device`: (cam_to_world,
    fx, fy, cx, cy) with the intrinsics divided by `factor`. The poses go
    up in one blocking upload. One camera gives a (4, 4) pose and
    numbers; a list of V cameras gives (V, 4, 4) and lists."""
    keys = ("fx", "fy", "cx", "cy")
    if isinstance(cams, list):
        pose = np.stack([np.asarray(c.cam_to_world, np.float32)
                         for c in cams])
        intrinsics = [[getattr(c, k) / factor for c in cams] for k in keys]
    else:
        pose = np.asarray(cams.cam_to_world, np.float32)
        intrinsics = [getattr(cams, k) / factor for k in keys]
    with host_sync("pose", device):
        pose = torch.as_tensor(pose, device=device)
    return (pose, *intrinsics)


@dataclass
class StepOutcome:
    """The step's metrics as device tensors; reading a property syncs,
    so the CLI reads them only at display or metrics cadence."""

    metrics: dict

    @property
    def loss(self) -> float:
        return float(self.metrics["loss"])

    @property
    def psnr(self) -> float:
        return float(self.metrics["psnr"])

    @property
    def n_alive(self) -> int:
        return int(self.metrics["n_alive"])


class Trainer:
    """Host-side orchestration: camera sampling, resolution and SH
    schedules, the ground-truth cache, refine dispatch and capacity
    growth.

    `cameras` are objects with cam_to_world (4x4), fx, fy, cx, cy, width,
    height and get_image(factor) -> (H, W, 3) float image in [0, 1]."""

    n_local = 1  # scenes a step of this process trains

    def __init__(self, state: TrainState, cameras: List, cfg: TrainConfig,
                 renderer: str = "fast", device="cuda"):
        self.device = resolve_device(device)
        if state.device.type != self.device.type:
            raise ValueError(f"Trainer: state is on {state.device}, "
                             f"device={device!r}")
        self.state = state
        self.cameras = cameras
        self.cfg = cfg
        self.renderer = renderer
        self.sampler = InfiniteRandomSampler(len(cameras), seed=cfg.seed)
        self.d_total = 1  # cameras per step (the DP trainers raise this)
        self.last_hw = (0, 0)  # the last step's render size (refine's maxwh)
        self.refine_metrics: Optional[dict] = None
        # (state, cameras..., gt, means_lr, **the rest) -> (state, metrics)
        self._train_step = train_step_impl
        self._gt_cache: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()
        self._gt_cache_used = 0
        self._gt_cache_budget = max(0, int(cfg.gt_cache_mb)) * (1 << 20)
        self._size_queues: dict = {}  # _sample_batch's draws by image size

    def _gt_on_device(self, cam_idx: int, factor: int) -> torch.Tensor:
        """GT image on the device, cached per (camera, factor) under
        cfg.gt_cache_mb (LRU)."""
        key = (cam_idx, factor)
        hit = self._gt_cache.get(key)
        if hit is not None:
            self._gt_cache.move_to_end(key)
            count("gt.hits")
            return hit
        image = np.ascontiguousarray(self.cameras[cam_idx].get_image(factor),
                                     np.float32)
        with host_sync("gt_upload", self.device):
            arr = torch.as_tensor(image, device=self.device)
        nbytes = arr.numel() * arr.element_size()
        count("gt.misses")
        count("gt.upload_bytes", nbytes)
        if nbytes > self._gt_cache_budget:
            return arr
        while self._gt_cache and (
                self._gt_cache_used + nbytes > self._gt_cache_budget):
            _, old = self._gt_cache.popitem(last=False)
            self._gt_cache_used -= old.numel() * old.element_size()
        self._gt_cache[key] = arr
        self._gt_cache_used += nbytes
        return arr

    def _capacity_rounding(self) -> int:
        """Capacity-growth granularity; the Gaussian-sharded trainer
        rounds to a multiple of its shard count too."""
        return self.cfg.capacity_round

    def _sample_batch(self, factor: int):
        """Draw d_total same-sized cameras: ((h, w), [(camera, gt)]). The
        sampler keeps the reference's reshuffle-per-epoch order
        (utils.hpp:14-38); when the dataset mixes image sizes, draws of
        another size wait in their own size's queue, so every camera
        still appears once per epoch. Used by the DP trainers."""
        while True:
            cam_idx = self.sampler.next()
            gt = self._gt_on_device(cam_idx, factor)
            key = (int(gt.shape[0]), int(gt.shape[1]))
            q = self._size_queues.setdefault(key, [])
            q.append((self.cameras[cam_idx], gt))
            if len(q) >= self.d_total:
                self._size_queues[key] = q[self.d_total:]
                return key, q[:self.d_total]

    def full_state(self) -> TrainState:
        """The whole model (what scene files and checkpoints hold). The
        Gaussian-sharded trainer gathers it from every rank, so every
        rank of a run must call this together."""
        return self.state

    def run_step(self, step: int) -> StepOutcome:
        """One step of the host loop, which every trainer runs: the step's
        plan, this process's draw and its staging, the step function, and
        the refine at a refine boundary. A trainer differs in _draw,
        _train_step, _outcome and _refine."""
        count("trainer.steps")
        count("trainer.scene_steps", self.n_local)
        cfg = self.cfg
        with span("trainer.run_step"):
            plan = step_plan(step, cfg)
            with span("trainer.gt"):
                cams, gt = self._draw(plan.factor)
                views = stage_cameras(cams, plan.factor, self.device)
            h, w = int(gt.shape[-3]), int(gt.shape[-2])
            self.last_hw = (h, w)
            self.state, metrics = self._train_step(
                self.state, *views, gt, plan.means_lr, height=h, width=w,
                sh_deg=plan.sh_deg, cfg=cfg, accumulate=plan.accumulate,
                renderer=self.renderer)
            if step % cfg.refine_every == 0 and step > cfg.warmup_length:
                with span("trainer.refine"):
                    self._refine(step)
        return self._outcome(metrics)

    def _draw(self, factor: int):
        """The step's camera(s) for this process and their GT on the
        device: one camera from the sampler."""
        cam_idx = self.sampler.next()
        return self.cameras[cam_idx], self._gt_on_device(cam_idx, factor)

    def _outcome(self, metrics: dict) -> StepOutcome:
        return StepOutcome(metrics)

    def _refine(self, step: int):
        """The refine of model.cpp:339-494 at a refine boundary: grow
        capacity first so that no candidate is dropped, then densify and/or
        reset; on a boundary with neither, only the stats are cleared."""
        cfg = self.cfg
        reset_interval = cfg.reset_alpha_every * cfg.refine_every
        num_cameras = len(self.cameras)
        do_densification = (
            step < cfg.stop_split_at
            and step % reset_interval > num_cameras + cfg.refine_every)
        do_reset = (step < cfg.stop_split_at
                    and step % reset_interval == cfg.refine_every)
        do_cull_huge = step > cfg.refine_every * cfg.reset_alpha_every
        use_screen_size = step < cfg.stop_screen_size_at
        maxwh = float(max(self.last_hw))

        if do_densification:
            n_alive, n_free, needed = count_refine_needs(
                self.state, maxwh, cfg, use_screen_size)
            if needed > n_free:
                self.state = grow_capacity(self.state, round_capacity(
                    int((n_alive + needed) * 1.25), self._capacity_rounding()))

        if do_densification or do_reset:
            self.state, metrics = refine_step(
                self.state, maxwh, cfg, use_screen_size, do_densification,
                do_cull_huge, do_reset,
                generator=refine_generator(cfg.seed, step, self.state.device))
            with host_sync("refine", self.state.device, len(metrics)):
                self.refine_metrics = {k: int(v) for k, v in metrics.items()}
        else:
            # stats are still cleared on every refine boundary (model.cpp:482)
            self.state.stats = zero_stats(self.state.alive.shape[0],
                                          self.state.device)

    def render(self, cam, step: int) -> torch.Tensor:
        """Inference render of `cam` at the step's resolution and SH degree
        (val images, final PSNR): (H, W, 3) on the state's device. The JAX
        Trainer re-renders once when a frame overflowed its static
        intersection budget; the port sizes every stream exactly, so there
        is nothing to overflow and one render is the answer."""
        plan = step_plan(step, self.cfg)
        return self._render(
            *stage_cameras(cam, plan.factor, self.device),
            int(cam.height / plan.factor), int(cam.width / plan.factor),
            plan.sh_deg)

    def _render(self, cam_to_world, fx, fy, cx, cy, height, width, sh_deg):
        return render_image(self.state.params, self.state.alive,
                            cam_to_world, fx, fy, cx, cy, height, width,
                            sh_deg, self.renderer, device=self.device)[0]


@torch.no_grad()
def render_image(params: GaussianParams, alive: torch.Tensor,
                 cam_to_world: torch.Tensor, fx: float, fy: float, cx: float,
                 cy: float, height: int, width: int, sh_deg: int,
                 renderer: str = "fast", device="cuda"):
    """Inference render without gradients: (rgb (H, W, 3), n_cands,
    n_isects). The stream is sized exactly, so it needs no budgets."""
    dev = resolve_device(device)
    out = render_forward(
        params, alive, cam_to_world, fx, fy, cx, cy, height, width, sh_deg,
        background(dev), renderer=renderer, device=dev)
    return out.rgb, out.n_cands, out.n_isects
