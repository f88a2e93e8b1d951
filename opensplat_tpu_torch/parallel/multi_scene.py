"""Multi-scene training: S independent scenes advance one step each.

Counterpart of opensplat_tpu/parallel/multi_scene.py. Every TrainState
leaf gains a leading scene axis (one capacity for all scenes). The JAX
package vmaps one program over the scenes; the port runs one batched
step (train_step_impl on the stacked state): one launch of each kernel,
one sort and one Adam update for all scenes, each scene's loss and
state the bits of an independent Trainer's step. With a mesh the scenes
are dealt over the `data` ranks in contiguous blocks; scenes are
independent, so a step has no collective beyond gathering the metrics.
"""
from __future__ import annotations

from functools import partial
from typing import List, Optional

import torch

from ..config import TrainConfig
from ..models.gaussians import (TrainState, grow_capacity, round_capacity,
                                state_map)
from ..train import StepOutcome, Trainer, train_step_impl
from .mesh import Mesh

_FLOAT_METRICS = ("loss", "psnr")
_INT_METRICS = ("n_visible", "n_isects", "n_cands", "n_grads", "n_alive")


def stack_states(states: List[TrainState]) -> TrainState:
    """Per-scene TrainStates (one capacity, one Adam count) stacked along
    a new axis 0."""
    if len({s.opt.count for s in states}) != 1:
        raise ValueError("stack_states: the scenes' Adam counts differ")
    return state_map(lambda *xs: torch.stack(xs), *states)


def unstack_states(stacked: TrainState, n: int) -> List[TrainState]:
    """The n scenes of a stacked state, as views of its tensors."""
    return [state_map(lambda x, i=i: x[i], stacked) for i in range(n)]


def sharded_multi_scene_step(states: TrainState, cam_to_world, fx, fy, cx,
                             cy, gt_images, means_lr: float, mesh: Mesh,
                             height: int, width: int, sh_deg: int,
                             cfg: TrainConfig, accumulate: bool,
                             renderer: str = "fast"):
    """train_step_impl on this rank's block of scenes (stacked); the
    metrics come back gathered over the `data` ranks, in scene order, so
    every rank sees all S scenes'. Every rank of the mesh calls it
    together."""
    states, m = train_step_impl(
        states, cam_to_world, fx, fy, cx, cy, gt_images, means_lr, height,
        width, sh_deg, cfg, accumulate, renderer)
    floats = mesh.all_gather(torch.stack([m[k].to(torch.float32) for k in
                                          _FLOAT_METRICS], 1), "data")
    ints = mesh.all_gather(torch.stack([m[k].to(torch.int64) for k in
                                        _INT_METRICS], 1), "data")
    out = {k: floats[:, j] for j, k in enumerate(_FLOAT_METRICS)}
    out.update({k: ints[:, j] for j, k in enumerate(_INT_METRICS)})
    return states, out


class MultiSceneTrainer:
    """Trainer for S independent scenes (CLI: opensplat_tpu_torch.
    multi_scene_cli).

    One child Trainer per scene supplies the host machinery (its camera
    sampler in the reshuffle-per-epoch order, the GT cache, the refine
    and reset schedule, capacity growth) while Trainer's host loop
    (run_step) steps the stacked state: train_step_impl, or
    sharded_multi_scene_step when a mesh is given. With a mesh, `states`
    and `cameras_per_scene` are this rank's block of the S scenes
    (S / n_data of them, data index d holding scenes
    [d S/n_data, (d+1) S/n_data)). At each refine
    boundary the stack is split, every child refines exactly as a
    standalone run would (its own camera count feeds the reference's
    reset-interval guard, model.cpp:341), the capacities are aligned to
    the padded maximum over all scenes and the stack is rebuilt.
    All scenes must share image dimensions at equal downscale."""

    def __init__(self, states: List[TrainState],
                 cameras_per_scene: List[list], cfg: TrainConfig,
                 renderer: str = "fast", mesh: Optional[Mesh] = None,
                 device="cuda"):
        if not states or len(states) != len(cameras_per_scene):
            raise ValueError("MultiSceneTrainer: one camera list per scene, "
                             "at least one scene")
        self.cfg = cfg
        self.renderer = renderer
        self.mesh = mesh
        self.n_local = len(states)
        self.n_scenes = self.n_local * (mesh.shape["data"] if mesh else 1)
        self.children = [Trainer(st, cams, cfg, renderer=renderer,
                                 device=device)
                         for st, cams in zip(states, cameras_per_scene)]
        self.device = self.children[0].device
        self.refine_metrics = None
        self.last_hw = (0, 0)
        self._train_step = (train_step_impl if mesh is None else
                            partial(sharded_multi_scene_step, mesh=mesh))
        self._align_and_stack([c.state for c in self.children])

    # Trainer's host loop, over the draw, step, outcome and refine below
    run_step = Trainer.run_step

    def _align_and_stack(self, states: List[TrainState]):
        cap = max(s.alive.shape[0] for s in states)
        if self.mesh is not None:  # one capacity on every rank
            cap = int(self.mesh.pmax(torch.tensor(cap, device=self.device),
                                     "data"))
        cap = round_capacity(cap, self.cfg.capacity_round)
        self.state = stack_states([
            grow_capacity(s, cap) if s.alive.shape[0] != cap else s
            for s in states])

    def _draw(self, factor: int):
        """One camera from each scene's sampler, and the GT stacked."""
        cams, gts = [], []
        for ch in self.children:
            idx = ch.sampler.next()
            cams.append(ch.cameras[idx])
            gts.append(ch._gt_on_device(idx, factor))
        shapes = {tuple(g.shape) for g in gts}
        if len(shapes) != 1:
            raise ValueError(f"multi-scene batch needs equal image sizes "
                             f"at factor {factor}, got {sorted(shapes)}")
        return cams, torch.stack(gts)

    def _outcome(self, metrics: dict) -> StepOutcome:
        out = dict(metrics)
        out["loss"] = metrics["loss"].mean()
        out["psnr"] = metrics["psnr"].mean()
        out["n_alive"] = metrics["n_alive"].sum()
        out["loss_per_scene"] = metrics["loss"]
        return StepOutcome(out)

    def _refine(self, step: int):
        refine = []
        for ch, st in zip(self.children,
                          unstack_states(self.state, self.n_local)):
            ch.state = st
            ch.last_hw = self.last_hw
            ch._refine(step)  # the scene's camera count -> the guard
            refine.append(ch.refine_metrics)
            ch.refine_metrics = None
        self.refine_metrics = (None if all(r is None for r in refine)
                               else refine)
        self._align_and_stack([ch.state for ch in self.children])

    def scene_states(self) -> List[TrainState]:
        """Every scene's state, in scene order (e.g. to save each scene's
        PLY). With a mesh they are gathered from every rank, so every
        rank must call it together."""
        st = self.state
        if self.mesh is not None:
            st = state_map(lambda x: self.mesh.all_gather(x, "data"), st)
        return unstack_states(st, self.n_scenes)
