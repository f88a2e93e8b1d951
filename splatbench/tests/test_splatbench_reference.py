"""The reference against itself: a permutation of the Gaussians renders
the same image and loss and permutes the gradients; and its camera,
projection and compositing on cases small enough to work out by hand."""
import math

import pytest
import torch

from splatbench.reference.render import Camera, render
from splatbench.reference.step import loss_fn, ssim, step_grads
from splatbench.scene import camera_poses, make_images, make_params

SCENE = {
    "n_gaussians": 3000, "sh_degree": 3, "width": 48, "height": 40,
    "fx": 40.0, "fy": 40.0, "cx": 24.0, "cy": 20.0,
    "cameras": {"kind": "hemisphere", "count": 4, "radius": 4.0,
                "elevation": [10.0, 60.0], "target": [0.0, 0.0, 0.0]},
    "surfaces": [{"kind": "box", "min": [-1, -1, -0.5], "max": [1, 1, 0.5],
                  "share": 0.7},
                 {"kind": "sphere", "center": [0, 0, 0.8], "radius": 0.4,
                  "share": 0.3}],
    "opacity": 0.9, "scale_spread": 0.25, "axis_spread": 0.5,
    "colour_frequencies": [1.0, 4.0],
    "pixel_noise": 0.02,
}
TRAIN = {"ssim_weight": 0.2, "background": [0.6130, 0.0101, 0.3984]}


def _view(seed=3):
    pose = camera_poses(SCENE)[1]
    gt = torch.from_numpy(make_images(SCENE, [pose], seed,
                                      TRAIN["background"], "cpu")[0])
    s = SCENE
    return Camera(torch.from_numpy(pose), s["fx"], s["fy"], s["cx"], s["cy"],
                  s["width"], s["height"]), gt


def test_permutation_invariance():
    params = make_params(SCENE, 3, "cpu")
    params["features_rest"] = 0.05 * torch.randn(
        params["features_rest"].shape, generator=torch.Generator()
        .manual_seed(0))
    cam, gt = _view()
    alive = torch.ones(SCENE["n_gaussians"], dtype=torch.bool)
    perm = torch.randperm(SCENE["n_gaussians"],
                          generator=torch.Generator().manual_seed(1))
    loss_a, psnr_a, g_a = step_grads(params, alive, cam, gt, TRAIN)
    loss_b, psnr_b, g_b = step_grads({k: v[perm] for k, v in params.items()},
                                     alive, cam, gt, TRAIN)
    assert loss_a == pytest.approx(loss_b, rel=1e-6)
    assert psnr_a == pytest.approx(psnr_b, abs=1e-4)
    for k in g_a:
        assert torch.allclose(g_a[k][perm], g_b[k], rtol=1e-4,
                              atol=1e-6 * float(g_a[k].abs().max()))
    assert float(g_a["means"].abs().sum()) > 0
    # anisotropic Gaussians: the rotations' gradient is no round-off
    norms = sorted(float(g.norm()) for g in g_a.values())
    assert float(g_a["quats"].norm()) > 1e-2 * norms[len(norms) // 2]


def test_camera_centre_projects_to_principal_point():
    c2w = torch.eye(4)
    c2w[2, 3] = 5.0
    cam = Camera(c2w, 50.0, 50.0, 8.0, 8.0, 16, 16)
    n = 1
    params = {"means": torch.zeros((n, 3)),
              "scales": torch.full((n, 3), math.log(0.02)),
              "quats": torch.tensor([[1.0, 0.0, 0.0, 0.0]]),
              "features_dc": torch.zeros((n, 3)),
              "features_rest": torch.zeros((n, 15, 3)),
              "opacities": torch.full((n, 1), 10.0)}
    with torch.no_grad():
        img, raster, fields = render(params, torch.ones(1, dtype=bool), cam,
                                     torch.zeros(3))
    # u = fx x / z + cx - 0.5: the centre lands between pixels 7 and 8
    assert float(fields[0][0]) == pytest.approx(7.5, abs=1e-4)
    assert float(fields[1][0]) == pytest.approx(7.5, abs=1e-4)
    # colour 0.5 (SH coefficients 0); the 2D variance (fx s / z)^2 + 0.3
    # = 0.34, so at the pixels half a pixel off in x and y
    # alpha = sigmoid(10) exp(-0.5 (0.25 + 0.25) / 0.34), on a black
    # background
    alpha = 1 / (1 + math.exp(-10.0)) * math.exp(-0.25 / 0.34)
    assert torch.allclose(img[7:9, 7:9], torch.full((2, 2, 3), 0.5 * alpha),
                          atol=1e-5)


def test_ssim_of_identical_images_is_one():
    x = torch.rand((24, 20, 3), generator=torch.Generator().manual_seed(0))
    assert float(ssim(x, x)) == pytest.approx(1.0, abs=1e-6)
    assert float(loss_fn(x, x, 0.2)) == pytest.approx(0.0, abs=1e-6)


def test_culled_gaussian_in_the_camera_plane_gets_no_gradient():
    # a large Gaussian at camera depth exactly 0: culled, so its gradient
    # is 0 (evaluated as it stands, its 2D covariance overflows float32)
    params = make_params(SCENE, 3, "cpu")
    cam, gt = _view()
    rot = (cam.cam_to_world[:3, :3]
           @ torch.diag(torch.tensor([1.0, -1.0, -1.0]))).T
    centre = cam.cam_to_world[:3, 3]
    for k in range(1, 1000):
        pt = centre + 0.01 * k * rot[0]
        if float((pt @ rot.T - rot @ centre)[2]) == 0.0:
            break
    else:
        pytest.fail("no point at camera depth 0")
    params["means"][0] = pt
    params["scales"][0] = torch.tensor([1.5, 1.0, 0.5])
    alive = torch.ones(SCENE["n_gaussians"], dtype=torch.bool)
    _, _, grads = step_grads(params, alive, cam, gt, TRAIN)
    for k in grads:
        assert torch.isfinite(grads[k]).all(), k
        assert not grads[k][0].any(), k
