"""The comparison that decides `correct`.

Set-up drives the training object through its first steps (the window's
own call and feed, a different camera each). The reference (reference/)
follows them from the same initial state, cameras and images, scene by
scene where a step trains several. Compared,
each number against the cell's limit (limits/<cell>.json):

- loss_gap: the largest relative gap of a scene's loss at a step;
- psnr_gap: the largest gap of a step's PSNR of the rendered image
  against its ground truth (the mean over the step's scenes), in dB;
- grad_gap: the first gradient as the optimizer got it (its first moment
  after one step from zero, over 1 - beta1), by the worst parameter
  group: the gap between the two norms over the larger of the
  reference's norm of that group and of the median group; each norm
  leaves out the group's TRIM rows of largest reference gradient (one
  stretched Gaussian across thousands of pixels can hold most of a
  group's norm, and the order of float32 sums moves its row by up to
  5e-4);
- change_gap: the parameters' change over the steps, by the worst group
  in the same way, leaving out groups whose reference gradient is under
  a thousandth of the median group's (they move by round-off alone);
  both the worst over the scenes.

Norms are summed in float64, a block of rows at a time.
"""
from __future__ import annotations

import math
import statistics
from dataclasses import dataclass, field
from typing import Dict, List

import torch

from .reference.render import Camera
from .reference.step import (PARAMS, Adam, learning_rates, precision,
                             step_grads)

ROWS = 1 << 20
NOUGHT = 1e-3
TRIM = 16
NUMBERS = ("loss_gap", "psnr_gap", "grad_gap", "change_gap")


def leaf_norm(t: torch.Tensor, minus: torch.Tensor = None) -> float:
    """Euclidean norm of `t` (minus `minus`, on minus's device)."""
    total = 0.0
    for i in range(0, t.shape[0], ROWS):
        blk = t[i:i + ROWS]
        if minus is not None:
            blk = blk.to(minus.device) - minus[i:i + ROWS]
        total += float(blk.double().square().sum())
    return math.sqrt(total)


@dataclass
class Readings:
    """A run's readings over its checked steps, of S scenes trained
    together (S = 1 for a single scene)."""

    losses: List[float] = field(default_factory=list)  # step by step, each
    # step's scenes in order
    psnrs: List[float] = field(default_factory=list)  # a step's, the mean
    # over its scenes
    grad_norms: List[Dict[str, float]] = field(default_factory=list)  # a
    # scene's groups
    change_norms: List[Dict[str, float]] = field(default_factory=list)
    first_grads: List[Dict[str, torch.Tensor]] = field(
        default_factory=list, repr=False)  # a scene's, on the host

    def numbers(self) -> Dict:
        """The readings without the gradients themselves."""
        return {k: v for k, v in self.__dict__.items() if k != "first_grads"}


def scene_readings(params0: Dict[str, torch.Tensor], alive: torch.Tensor,
                   views, train: Dict):
    """The reference's steps of one scene from params0 over `views`
    [(Camera, ground truth (H, W, 3) on the device, step number)]:
    (losses, psnrs, the first gradient's norms, the change's norms, the
    first gradient on the host)."""
    losses, psnrs, grad_norms, first = [], [], {}, {}
    params = {k: params0[k].clone() for k in PARAMS}
    adam = Adam(params)
    for i, (cam, gt, step) in enumerate(views):
        loss, psnr, grads = step_grads(params, alive, cam, gt, train)
        losses.append(loss)
        psnrs.append(psnr)
        if i == 0:
            grad_norms = {k: leaf_norm(grads[k]) for k in PARAMS}
            first = {k: grads[k].detach().to("cpu") for k in PARAMS}
        adam.step(params, grads, learning_rates(train, step), alive)
        del grads
    change = {k: leaf_norm(params[k], params0[k]) for k in PARAMS}
    return losses, psnrs, grad_norms, change, first


def reference_readings(scenes, train: Dict, tf32: bool = False) -> Readings:
    """The reference's readings of `scenes`, an iterable of (params0,
    alive, views) in scene order, each as scene_readings takes it."""
    losses, psnrs, out = [], [], Readings()
    with precision(tf32):
        for params0, alive, views in scenes:
            ls, ps, g, c, f = scene_readings(params0, alive, views, train)
            losses.append(ls)
            psnrs.append(ps)
            out.grad_norms.append(g)
            out.change_norms.append(c)
            out.first_grads.append(f)
    out.losses = [x for step in zip(*losses) for x in step]
    out.psnrs = [statistics.fmean(step) for step in zip(*psnrs)]
    return out


def _largest(values) -> float:
    """The largest value; inf if any is not finite."""
    values = list(values)
    return (max(values) if all(math.isfinite(v) for v in values)
            else math.inf)


def _worst(prog: Dict[str, float], ref: Dict[str, float], keys) -> float:
    med = statistics.median(ref[k] for k in PARAMS)
    return _largest(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
                    for k in keys)


def trimmed_norms(grads: Dict[str, torch.Tensor],
                  ref: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each group's norm of `grads` without the TRIM rows of largest norm
    in the reference's gradient `ref` of that group."""
    out = {}
    for k in PARAMS:
        n = ref[k].shape[0]
        rows = ref[k].reshape(n, -1).square().sum(1)
        top = torch.topk(rows, min(TRIM, n)).indices
        g = grads[k]
        left = leaf_norm(g) ** 2 - float(g[top].double().square().sum())
        out[k] = math.sqrt(max(left, 0.0)) if math.isfinite(left) else left
    return out


def _moved(ref_grads: Dict[str, float]) -> List[str]:
    med = statistics.median(ref_grads[k] for k in PARAMS)
    return [k for k in PARAMS if ref_grads[k] >= NOUGHT * med]


def compare(prog: Readings, ref: Readings) -> Dict[str, float]:
    """The numbers compared, each a gap of the program from the
    reference (inf where a reading is not finite or missing); grad_gap
    and change_gap are the worst over the scenes."""
    if (len(prog.losses) != len(ref.losses)
            or len(prog.psnrs) != len(ref.psnrs)
            or len(prog.first_grads) != len(ref.first_grads)
            or len(prog.change_norms) != len(ref.change_norms)):
        return dict.fromkeys(NUMBERS, math.inf)
    trimmed = [(trimmed_norms(p, r), trimmed_norms(r, r))
               for p, r in zip(prog.first_grads, ref.first_grads)]
    return {
        "loss_gap": _largest(abs(p - r) / abs(r)
                             for p, r in zip(prog.losses, ref.losses)),
        "psnr_gap": _largest(abs(p - r)
                             for p, r in zip(prog.psnrs, ref.psnrs)),
        "grad_gap": _largest(_worst(p, r, PARAMS) for p, r in trimmed),
        "change_gap": _largest(
            _worst(p, r, _moved(g)) for p, r, g in
            zip(prog.change_norms, ref.change_norms, ref.grad_norms)),
    }


def full_grad_gap(prog: Readings, ref: Readings) -> float:
    """grad_gap over whole groups, no row left out (a reading kept beside
    the compared one)."""
    return _largest(_worst(p, r, PARAMS)
                    for p, r in zip(prog.grad_norms, ref.grad_norms))


def to_camera(cam) -> Camera:
    """The reference's camera of one of the benchmark's cameras."""
    return Camera(torch.from_numpy(cam.cam_to_world), cam.fx, cam.fy,
                  cam.cx, cam.cy, cam.width, cam.height)
