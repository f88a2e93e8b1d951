"""Device ms of one call of the program's project_gaussians
(ops/projection.py) forward and backward alone, as the step calls it
(one view, the view axis in front), at the cell's Gaussians
(scene.make_params, seed 0) and its first camera: torch.profiler over 10
calls after one (yardstick/profiling.py device_rows), the backward
taking fixed random gradients of the pixel centres and conics, the
outputs the rasterizer reads. None off the card or where the trace
recorded no kernel."""
import torch

from splatbench.scene import camera_poses, make_params
from splatbench.yardstick.profiling import device_rows

SEED = 0
CALLS = 10


def read(ctx):
    if not ctx.on_card:
        return None
    from opensplat_tpu_torch.ops.camera import camera_matrices
    from opensplat_tpu_torch.ops.projection import project_gaussians

    sc, dev = ctx.scene, ctx.device
    p = make_params(sc, SEED, dev)
    means = p["means"][None].requires_grad_()
    scales = torch.exp(p["scales"])[None].requires_grad_()
    quats = (p["quats"] / torch.linalg.norm(p["quats"], dim=-1,
                                            keepdim=True))[None]
    quats.requires_grad_()
    opac = torch.sigmoid(p["opacities"])[None]
    del p
    n = means.shape[1]
    alive = torch.ones((1, n), dtype=torch.bool, device=dev)
    fx, fy = [float(sc["fx"])], [float(sc["fy"])]
    pose = torch.from_numpy(camera_poses(sc)[0]).to(dev)[None]
    viewmat, full, _ = camera_matrices(pose, fx, fy, sc["width"],
                                       sc["height"])
    gen = torch.Generator(device=dev).manual_seed(SEED)
    grads = (torch.randn((1, n, 2), generator=gen, device=dev),
             torch.randn((1, n, 3), generator=gen, device=dev))

    def one():
        proj = project_gaussians(
            means, scales, 1.0, quats, viewmat, full, fx, fy,
            [float(sc["cx"])], [float(sc["cy"])], sc["height"], sc["width"],
            valid_mask=alive, opacities=opac)
        torch.autograd.grad((proj.xys, proj.conics), (means, scales, quats),
                            grads)

    one()
    rows = device_rows(one, CALLS)
    if not rows:
        return None
    return sum(ms * c for _, ms, c in rows) / CALLS
