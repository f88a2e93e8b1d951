"""opensplat_tpu_torch.gsplat_compat against opensplat_tpu.gsplat_compat on
the CPU: each of the 11 gsplat entry points (rasterizer/gsplat/ext.cpp:
4-18) on the same numpy inputs (tests/scene_utils.make_scene, 80
Gaussians, 64x64 px).

Tolerances: projection, SH and cov2d bounds elementwise float32 math,
rtol 1e-5 (radii and tile counts exact; projection gradients rtol 1e-4
with atol 1e-5 of each output's scale, autograd and jax.vjp summing the
same chain in different orders); the renderers by the JAX suite's
renderer tolerances (images atol 1e-5 on >= 99.9% of pixels, gradients
by _assert_bulk_close, tests/test_rasterize.py:33); the intersection
keys exactly. The port returns the reference's int64 keys
(tile << 32) | depth_bits; the JAX copy (I, 2) int32 (tile, depth_bits)
pairs, so the keys are split for the comparison."""
import functools

import numpy as np
import jax.numpy as jnp
import torch

from opensplat_tpu import gsplat_compat as jgc
from opensplat_tpu_torch import gsplat_compat as tgc
from scene_utils import make_scene
from test_torch_conformance import _assert_bulk_close, _assert_image_close

# one intra-op thread per process: the suite runs one pytest-xdist
# worker per core, and a full torch thread pool in each of them
# oversubscribes the cores
torch.set_num_threads(1)

N = 80


@functools.lru_cache(maxsize=None)
def _scene():
    s = make_scene(n=N, seed=13)
    cam = (s["viewmat"], s["projmat"], s["fx"], s["fy"], s["cx"], s["cy"],
           s["H"], s["W"])
    jproj = jgc.project_gaussians_forward(
        jnp.asarray(s["means"]), jnp.asarray(s["scales"]), 1.0,
        jnp.asarray(s["quats"]), *[jnp.asarray(c) for c in cam[:2]],
        *cam[2:])
    return s, cam, tuple(np.asarray(x) for x in jproj)


def _t(a):
    return torch.from_numpy(np.array(a))


def _raster_args(ch):
    """(xys, depths, radii, conics, num_tiles_hit, colours, opacities, H,
    W, background) as numpy, and a cotangent pair, for CH channels."""
    s, _, (_, xys, depths, radii, conics, nth) = _scene()
    rng = np.random.default_rng(ch)
    colors = rng.uniform(0, 1, (N, ch)).astype(np.float32)
    bg = rng.uniform(0, 1, ch).astype(np.float32)
    cot = (rng.normal(size=(s["H"], s["W"], ch)).astype(np.float32),
           rng.normal(size=(s["H"], s["W"])).astype(np.float32))
    return ((xys, depths, radii, conics, nth, colors, s["opacities"],
             s["H"], s["W"], bg), cot)


def _call_both(name, args, **kw):
    """gsplat_compat.<name> of both packages on the same numpy args."""
    def conv(a, to):
        return to(a) if isinstance(a, np.ndarray) else a

    j = getattr(jgc, name)(*[conv(a, jnp.asarray) for a in args],
                           **{k: conv(v, jnp.asarray) for k, v in kw.items()})
    t = getattr(tgc, name)(*[conv(a, _t) for a in args],
                           **{k: conv(v, _t) for k, v in kw.items()})
    return j, t


def test_project_gaussians_forward():
    s, cam, jout = _scene()
    tout = tgc.project_gaussians_forward(
        _t(s["means"]), _t(s["scales"]), 1.0, _t(s["quats"]), _t(cam[0]),
        _t(cam[1]), *cam[2:])
    for name, a, b in zip(("cov3d", "xys", "depths", "radii", "conics",
                           "num_tiles_hit"), tout, jout):
        if name in ("radii", "num_tiles_hit"):
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
        else:
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                       atol=1e-6 * np.abs(b).max(),
                                       err_msg=name)
    assert int((jout[3] > 0).sum()) > N // 2


def test_project_gaussians_backward():
    s, cam, (cov3d, xys, depths, radii, conics, _) = _scene()
    rng = np.random.default_rng(1)
    cots = [rng.normal(size=a.shape).astype(np.float32)
            for a in (xys, depths, conics)]
    args = (s["means"], s["scales"], 1.0, s["quats"], *cam, cov3d, radii,
            conics, *cots)
    j, t = _call_both("project_gaussians_backward", args)
    for name, a, b in zip(("v_mean3d", "v_scale", "v_quat"), t, j):
        b = np.asarray(b)
        assert np.abs(b).max() > 0, name
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                   atol=1e-5 * np.abs(b).max(), err_msg=name)


def _check_images(j, t):
    for name, a, b in zip(("image", "final_T"), t, j):
        _assert_image_close(a.numpy(), np.asarray(b), name)


def _check_grads(j, t):
    for name, a, b in zip(("v_xy", "v_conic", "v_colors", "v_opacity"), t, j):
        _assert_bulk_close(a.numpy(), np.asarray(b), name=name)


def test_rasterize_forward():
    args, _ = _raster_args(3)
    _check_images(*_call_both("rasterize_forward", args))


def test_rasterize_backward():
    args, cot = _raster_args(3)
    _check_grads(*_call_both("rasterize_backward", args + cot))


def test_nd_rasterize_forward():
    args, _ = _raster_args(4)
    j, t = _call_both("nd_rasterize_forward", args)
    assert t[0].shape == (args[7], args[8], 4)
    _check_images(j, t)


def test_nd_rasterize_backward():
    args, cot = _raster_args(4)
    _check_grads(*_call_both("nd_rasterize_backward", args + cot))


def _sh_args():
    s, _, _ = _scene()
    rng = np.random.default_rng(0)
    dirs = s["means"] / np.linalg.norm(s["means"], axis=-1, keepdims=True)
    return (2, dirs.astype(np.float32),
            rng.standard_normal((N, 9, 3)).astype(np.float32))


def test_compute_sh_forward():
    j, t = _call_both("compute_sh_forward", _sh_args())
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                               atol=1e-6)


def test_compute_sh_backward():
    v = np.random.default_rng(2).normal(size=(N, 3)).astype(np.float32)
    j, t = _call_both("compute_sh_backward", _sh_args() + (v,))
    assert t.shape == (N, 9, 3)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                               atol=1e-6)


def test_compute_cov2d_bounds():
    rng = np.random.default_rng(3)
    a = rng.uniform(0.5, 4.0, N).astype(np.float32)
    c = rng.uniform(0.5, 4.0, N).astype(np.float32)
    b = (rng.uniform(-0.9, 0.9, N) * np.sqrt(a * c)).astype(np.float32)
    cov2d = np.stack([a, b, c], -1)
    cov2d[:4] = 0.0  # det == 0: invalid rows
    j, t = _call_both("compute_cov2d_bounds", (cov2d,))
    np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]), rtol=1e-5)
    np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))
    np.testing.assert_array_equal(t[2].numpy(), np.asarray(j[2]))
    assert not t[2][:4].any() and t[2][4:].all()


def _isects():
    s, _, (_, xys, depths, radii, _, nth) = _scene()
    cum = np.cumsum(nth).astype(np.int32)
    total = int(cum[-1])
    tb = (s["W"] // 16, s["H"] // 16, 1)
    # a budget past the true count: the tail holds the sentinel
    return total, (N, total + 7, xys, depths, radii, cum, tb)


def test_map_gaussian_to_intersects():
    total, args = _isects()
    (jids, jg), (tkeys, tg) = _call_both("map_gaussian_to_intersects", args)
    assert tkeys.dtype == torch.int64 and tkeys.shape == (total + 7,)
    pairs = np.stack([(tkeys >> 32).numpy(),
                      (tkeys & 0xFFFFFFFF).numpy().astype(np.uint32)
                      .view(np.int32)], -1)
    np.testing.assert_array_equal(pairs, np.asarray(jids))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    assert total > N and (np.diff(tkeys[:total].numpy()) >= 0).all()
    assert (tg[total:] == N).all()


def test_get_tile_bin_edges():
    total, args = _isects()
    (jids, _), (tkeys, _) = _call_both("map_gaussian_to_intersects", args)
    for n_tiles in (None, 16):
        j = jgc.get_tile_bin_edges(total, jids, num_tiles=n_tiles)
        t = tgc.get_tile_bin_edges(total, tkeys, num_tiles=n_tiles)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert int(t[:, 1].max()) == total
