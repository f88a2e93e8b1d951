"""opensplat_tpu_torch ops against the JAX package on the CPU: camera,
projection (outputs and VJP), spherical harmonics, SSIM and the masked
Adam. Inputs are made with numpy from a seed and handed to both; both
compute in float32, so the tolerances are float32 ones (1e-5, relative
to each output's scale where values are large)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from opensplat_tpu.ops import camera as jcam
from opensplat_tpu.ops import projection as jproj
from opensplat_tpu.ops import sh as jsh
from opensplat_tpu.ops import ssim as jssim
from opensplat_tpu.ops import tensor_math as jtm
from opensplat_tpu.optim import adam as jadam
from opensplat_tpu.models.gaussians import GaussianParams as JParams
from opensplat_tpu_torch.ops import camera as tcam
from opensplat_tpu_torch.ops import projection as tproj
from opensplat_tpu_torch.ops import sh as tsh
from opensplat_tpu_torch.ops import ssim as tssim
from opensplat_tpu_torch.ops import tensor_math as ttm
from opensplat_tpu_torch.optim import adam as tadam
from scene_utils import make_scene

# one intra-op thread per process: the suite runs one pytest-xdist
# worker per core, and a full torch thread pool in each of them
# oversubscribes the cores
torch.set_num_threads(1)


def _close(a, b, tol=1e-5, err_msg=""):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    scale = max(np.abs(b).max(), 1.0) if b.size else 1.0
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol * scale,
                               err_msg=err_msg)


def _pose(seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=4).astype(np.float32)
    R = np.asarray(jtm.quat_to_rotmat(jnp.asarray(q / np.linalg.norm(q))))
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = R
    c2w[:3, 3] = rng.uniform(-2, 2, 3)
    return c2w


def test_quat_to_rotmat_and_morton_order():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    _close(ttm.quat_to_rotmat(torch.from_numpy(q)).numpy(),
           np.asarray(jtm.quat_to_rotmat(jnp.asarray(q))))
    pts = rng.uniform(-3, 3, (500, 3)).astype(np.float32)
    np.testing.assert_array_equal(ttm.morton_order(pts), jtm.morton_order(pts))


def test_random_quat_unit_norm():
    q = ttm.random_quat(1000, torch.Generator().manual_seed(3))
    assert q.shape == (1000, 4)
    _close(torch.linalg.norm(q, dim=-1).numpy(), np.ones(1000))


@pytest.mark.parametrize("seed", [0, 1])
def test_camera_matrices(seed):
    c2w = _pose(seed)
    jv, jp, jc = jcam.camera_matrices(jnp.asarray(c2w), 70.0, 75.0, 64, 48)
    tv, tp, tc = tcam.camera_matrices(torch.from_numpy(c2w), 70.0, 75.0, 64, 48)
    for a, b, name in ((tv, jv, "viewmat"), (tp, jp, "projmat"), (tc, jc, "pos")):
        _close(a.numpy(), np.asarray(b), err_msg=name)


def _proj_inputs(seed, n=300):
    s = make_scene(n=n, seed=seed)
    names = ("means", "scales", "quats", "viewmat", "projmat", "opacities")
    return s, {k: s[k] for k in names}


@pytest.mark.parametrize("with_opac,with_valid", [(True, False),
                                                  (False, False),
                                                  (True, True)])
def test_projection_outputs(with_opac, with_valid):
    s, a = _proj_inputs(7)
    valid = np.random.default_rng(3).uniform(size=300) > 0.2
    j = jproj.project_gaussians(
        jnp.asarray(a["means"]), jnp.asarray(a["scales"]), 1.0,
        jnp.asarray(a["quats"]), jnp.asarray(a["viewmat"]),
        jnp.asarray(a["projmat"]), s["fx"], s["fy"], s["cx"], s["cy"],
        s["H"], s["W"], mode="gpu",
        valid_mask=jnp.asarray(valid) if with_valid else None,
        opacities=jnp.asarray(a["opacities"]) if with_opac else None)
    t = tproj.project_gaussians(
        torch.from_numpy(a["means"]), torch.from_numpy(a["scales"]), 1.0,
        torch.from_numpy(a["quats"]), torch.from_numpy(a["viewmat"]),
        torch.from_numpy(a["projmat"]), s["fx"], s["fy"], s["cx"], s["cy"],
        s["H"], s["W"],
        valid_mask=torch.from_numpy(valid) if with_valid else None,
        opacities=torch.from_numpy(a["opacities"]) if with_opac else None)
    for name in ("xys", "depths", "cam_depths", "conics", "cov2d"):
        _close(getattr(t, name).detach().numpy(), np.asarray(getattr(j, name)),
               err_msg=name)
    for name in ("radii", "num_tiles_hit", "tile_min", "tile_max", "mask"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)),
                                      err_msg=name)
    assert int(t.num_tiles_hit.sum()) > 0


def test_projection_vjp():
    s, a = _proj_inputs(11, n=200)
    rng = np.random.default_rng(1)
    v_xy = rng.normal(size=(200, 2)).astype(np.float32)
    v_con = rng.normal(size=(200, 3)).astype(np.float32)
    v_z = rng.normal(size=(200,)).astype(np.float32)
    cam = (s["fx"], s["fy"], s["cx"], s["cy"], s["H"], s["W"])

    def jf(m, sc, q):
        p = jproj.project_gaussians(m, sc, 1.0, q, jnp.asarray(a["viewmat"]),
                                    jnp.asarray(a["projmat"]), *cam)
        return (jnp.sum(p.xys * v_xy) + jnp.sum(p.conics * v_con)
                + jnp.sum(p.depths * v_z))

    jg = jax.grad(jf, argnums=(0, 1, 2))(
        jnp.asarray(a["means"]), jnp.asarray(a["scales"]),
        jnp.asarray(a["quats"]))
    leaves = [torch.tensor(a[k], requires_grad=True)
              for k in ("means", "scales", "quats")]
    p = tproj.project_gaussians(leaves[0], leaves[1], 1.0, leaves[2],
                                torch.from_numpy(a["viewmat"]),
                                torch.from_numpy(a["projmat"]), *cam)
    (torch.sum(p.xys * torch.from_numpy(v_xy))
     + torch.sum(p.conics * torch.from_numpy(v_con))
     + torch.sum(p.depths * torch.from_numpy(v_z))).backward()
    for leaf, g, name in zip(leaves, jg, ("means", "scales", "quats")):
        _close(leaf.grad.numpy(), np.asarray(g), err_msg=name)


def test_compute_cov2d_bounds():
    rng = np.random.default_rng(2)
    cov = np.stack([rng.uniform(0.5, 4, 50), rng.uniform(-0.4, 0.4, 50),
                    rng.uniform(0.5, 4, 50)], -1).astype(np.float32)
    cov[3] = [1.0, 1.0, 1.0]  # singular
    jc, jr, jv = jproj.compute_cov2d_bounds(jnp.asarray(cov))
    tc, tr, tv = tproj.compute_cov2d_bounds(torch.from_numpy(cov))
    _close(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
def test_spherical_harmonics(degree):
    rng = np.random.default_rng(degree)
    n = 128
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    coeffs = rng.normal(size=(n, 25, 3)).astype(np.float32)
    v = rng.normal(size=(n, 3)).astype(np.float32)
    jval, jvjp = jax.vjp(lambda c: jsh.spherical_harmonics(degree, jnp.asarray(d), c),
                         jnp.asarray(coeffs))
    tc = torch.tensor(coeffs, requires_grad=True)
    tval = tsh.spherical_harmonics(degree, torch.from_numpy(d), tc)
    (tval * torch.from_numpy(v)).sum().backward()
    _close(tval.detach().numpy(), np.asarray(jval))
    _close(tc.grad.numpy(), np.asarray(jvjp(jnp.asarray(v))[0]))
    assert tsh.num_sh_bases(degree) == jsh.num_sh_bases(degree)
    _close(tsh.rgb_to_sh(torch.tensor([0.2, 0.5, 0.9])).numpy(),
           np.asarray(jsh.rgb_to_sh(jnp.asarray([0.2, 0.5, 0.9]))))


def test_ssim_and_loss():
    rng = np.random.default_rng(4)
    a = rng.uniform(0, 1, (40, 56, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    _close(float(tssim.ssim(ta, tb)), float(jssim.ssim(ja, jb)))
    _close(float(tssim.psnr(ta, tb)), float(jssim.psnr(ja, jb)))
    _close(float(tssim.main_loss(ta, tb, 0.2)),
           float(jssim.main_loss(ja, jb, 0.2)))
    # gradient of the loss with respect to the rendered image
    tr = ta.clone().requires_grad_(True)
    tssim.main_loss(tr, tb, 0.2).backward()
    jg = jax.grad(lambda r: jssim.main_loss(r, jb, 0.2))(ja)
    _close(tr.grad.numpy(), np.asarray(jg), tol=1e-4)


def test_masked_adam_matches_jax():
    rng = np.random.default_rng(5)
    c = 16
    shapes = dict(means=(c, 3), scales=(c, 3), quats=(c, 4),
                  features_dc=(c, 3), features_rest=(c, 15, 3),
                  opacities=(c, 1))
    p = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    alive = rng.uniform(size=c) > 0.3
    lrs = dict(means=1e-3, scales=5e-3, quats=1e-3, features_dc=2.5e-3,
               features_rest=1.25e-4, opacities=0.05)
    jp = JParams(**{k: jnp.asarray(v) for k, v in p.items()})
    jopt = jadam.adam_init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    topt = tadam.adam_init(tp)
    for _ in range(3):
        g = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
        jp, jopt = jadam.adam_update(
            jp, JParams(**{k: jnp.asarray(v) for k, v in g.items()}), jopt,
            JParams(**lrs), jnp.asarray(alive))
        tadam.adam_update(tp, {k: torch.from_numpy(v) for k, v in g.items()},
                          topt, lrs, torch.from_numpy(alive))
    for k in shapes:
        _close(tp[k].numpy(), np.asarray(getattr(jp, k)), err_msg=k)
        _close(topt.mu[k].numpy(), np.asarray(getattr(jopt.mu, k)), err_msg=k)
        # dead rows are frozen
        np.testing.assert_array_equal(tp[k].numpy()[~alive], p[k][~alive])
    assert topt.count == int(jopt.count) == 3
    for step in (0, 1, 500, 30000, 40000):
        _close(tadam.means_lr_schedule(1.6e-4, 1.6e-6, 30000, step),
               float(jadam.means_lr_schedule(1.6e-4, 1.6e-6, 30000, step)))
