"""opensplat_tpu_torch's conformance renderers against the JAX package
on the CPU: the dense renderer (ops/rasterize.py) and the tiled one
(ops/rasterize_tiled.py, binned by the expansion kernel's plain version,
reduced by the segment sum's), render_forward and render_depth with
them, one train_step_impl per renderer, the full-bbox binning and the
numpy oracle's backward.

The same numpy inputs (tests/scene_utils.make_scene, 64x64 px, a few
hundred Gaussians) go through both packages; the JAX renderers run as
the JAX suite runs them on the CPU (pure jnp). Tolerances: image and
final T atol 1e-5 on >= 99.9% of pixels (a knife-edge alpha or stop
flip moves a pixel further, tests/test_rasterize.py:3-10); gradients,
the background's included, by the JAX suite's renderer tolerance
_assert_bulk_close (tests/test_rasterize.py:33: rel 1e-3 on 99%, max
rel 0.05, norm within 2e-3); the train step as in
tests/test_torch_train_step.py (loss rel 1e-3, gradients atol 1e-5 of
each leaf's scale against the same JAX float32 renderer); the oracle
backward rtol 1e-6. The port's tiled stream is culled (pairs below
1/255 over the whole tile) where the JAX one is not; the image is the
same."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from opensplat_tpu.config import TrainConfig as JConfig
from opensplat_tpu.models.splat_model import render_depth as jrender_depth
from opensplat_tpu.models.splat_model import render_forward as jrender
from opensplat_tpu.ops.binning import bin_gaussians as jbin
from opensplat_tpu.ops.projection import project_gaussians as jproject
from opensplat_tpu.ops.rasterize import rasterize as jdense
from opensplat_tpu.ops.rasterize_tiled import rasterize_tiled as jtiled
from opensplat_tpu.oracle import np_oracle as joracle
from opensplat_tpu.train import train_step_impl as jstep
from opensplat_tpu_torch.config import TrainConfig
from opensplat_tpu_torch.models.gaussians import PARAM_NAMES, state_from_numpy
from opensplat_tpu_torch.models.splat_model import (DEFAULT_BACKGROUND,
                                                    render_depth,
                                                    render_forward)
from opensplat_tpu_torch.ops.binning import bin_gaussians
from opensplat_tpu_torch.ops.kernels import raster as traster
from opensplat_tpu_torch.ops.projection import ProjectedGaussians
from opensplat_tpu_torch.ops.rasterize import rasterize
from opensplat_tpu_torch.ops.rasterize_tiled import rasterize_tiled
from opensplat_tpu_torch.oracle import (np_pixel_gaussians,
                                        np_rasterize_backward,
                                        np_rasterize_forward)
from opensplat_tpu_torch.train import train_step_impl
from scene_utils import make_scene
from test_torch_train_step import STATIC, _camera, _g, _jax_state, _to_numpy

# one intra-op thread per process: the suite runs one pytest-xdist
# worker per core, and a full torch thread pool in each of them
# oversubscribes the cores
torch.set_num_threads(1)

H = W = 64
NAMES = ("xys", "conics", "colors", "opacities", "background")


def _assert_bulk_close(got, want, rel_tol=1e-3, bulk=0.99, max_rel=0.05,
                       name=""):
    """tests/test_rasterize.py::_assert_bulk_close."""
    got = np.asarray(got).reshape(np.shape(want))
    want = np.asarray(want)
    scale = np.abs(want).max() + 1e-12
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-3 * scale)
    frac_ok = (rel <= rel_tol).mean()
    assert frac_ok >= bulk, f"{name}: only {frac_ok:.4f} within rtol {rel_tol}"
    assert rel.max() <= max_rel, f"{name}: max rel err {rel.max():.4f}"
    n1, n2 = np.linalg.norm(got), np.linalg.norm(want)
    assert abs(n1 - n2) <= 2e-3 * max(n2, 1e-12), f"{name}: norms {n1}, {n2}"


def _assert_image_close(got, want, name):
    d = np.abs(np.asarray(got) - np.asarray(want))
    d = d.reshape(d.shape[0], d.shape[1], -1).max(-1)
    assert (d <= 1e-5).mean() >= 0.999, f"{name}: {(d > 1e-5).mean():.5f} off"


def _scene(n, seed, ch, spread=1.0):
    """JAX projection of make_scene (gpu mode, opacity-aware bboxes) and
    CH-channel colours, background and cotangents from the seed."""
    s = make_scene(n=n, seed=seed, spread=spread)
    proj = jproject(
        jnp.asarray(s["means"]), jnp.asarray(s["scales"]), 1.0,
        jnp.asarray(s["quats"]), jnp.asarray(s["viewmat"]),
        jnp.asarray(s["projmat"]), s["fx"], s["fy"], s["cx"], s["cy"], H, W,
        mode="gpu", opacities=jnp.asarray(s["opacities"]))
    rng = np.random.default_rng(seed + 100)
    colors = (s["colors"] if ch == 3
              else rng.uniform(0, 1, (n, ch)).astype(np.float32))
    bg = (s["background"] if ch == 3
          else rng.uniform(0, 1, ch).astype(np.float32))
    leaves = [np.asarray(proj.xys), np.asarray(proj.conics), colors,
              s["opacities"], bg]
    cot = (rng.normal(size=(H, W, ch)).astype(np.float32),
           rng.normal(size=(H, W)).astype(np.float32))
    return proj, leaves, cot


def _both(jfn, tfn, leaves, cot):
    """(outputs, gradients) of the JAX and the port's renderer."""
    def fwd_bwd(*xs):
        out, vjp = jax.vjp(jfn, *xs)
        return out, vjp(tuple(jnp.asarray(c) for c in cot))

    out_j, g_j = jax.jit(fwd_bwd)(*[jnp.asarray(a) for a in leaves])
    tl = [torch.tensor(a, requires_grad=True) for a in leaves]
    out_t = tfn(*tl)
    g_t = torch.autograd.grad(out_t, tl, [torch.from_numpy(c) for c in cot])
    return (out_j, g_j), ([o.detach() for o in out_t], g_t)


def _check(jax_side, port_side):
    (out_j, g_j), (out_t, g_t) = jax_side, port_side
    _assert_image_close(out_t[0], out_j[0], "image")
    _assert_image_close(out_t[1], out_j[1], "final_T")
    for name, a, b in zip(NAMES, g_t, g_j):
        _assert_bulk_close(a.numpy(), np.asarray(b), name=name)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("ch", [3, 5])
def test_dense_matches_jax(ch):
    proj, leaves, cot = _scene(300, 3, ch)

    def jfn(x, c, col, op, bg):
        return jdense(x, c, col, op, proj.depths, proj.mask, bg, H, W)

    def tfn(x, c, col, op, bg):
        return rasterize(x, c, col, op, _t(proj.depths), _t(proj.mask), bg,
                         H, W)

    _check(*_both(jfn, tfn, leaves, cot))


@pytest.mark.parametrize("ch,chunk,spread", [(3, 256, 1.0), (5, 256, 1.0),
                                             (3, 8, 0.15)],
                         ids=["ch3", "ch5", "ch3-chunk8-crowded"])
def test_tiled_matches_jax(ch, chunk, spread):
    """chunk 8 on a scene crowded onto the central tiles: tile runs cross
    chunk boundaries and pixels stop inside chunks (both checked on the
    port's own binning)."""
    proj, leaves, cot = _scene(300, 7, ch, spread)
    common = (proj.depths, proj.radii, proj.num_tiles_hit, proj.tile_min,
              proj.tile_max)

    def jfn(x, c, col, op, bg):
        return jtiled(x, c, col, op, *common, bg, H, W, chunk_size=chunk)

    def tfn(x, c, col, op, bg):
        return rasterize_tiled(x, c, col, op, *map(_t, common), bg, H, W,
                               chunk_size=chunk)

    _check(*_both(jfn, tfn, leaves, cot))
    if chunk == 8:
        tp = ProjectedGaussians(
            xys=_t(leaves[0]), depths=_t(proj.depths),
            cam_depths=_t(proj.depths), radii=_t(proj.radii),
            conics=_t(leaves[1]), cov2d=_t(leaves[1]),
            num_tiles_hit=_t(proj.num_tiles_hit), tile_min=_t(proj.tile_min),
            tile_max=_t(proj.tile_max), mask=_t(proj.mask))
        b = bin_gaussians(tp, H, W, _t(leaves[3]))
        _, _, fidx = traster.rasterize_forward_plain(
            b.gauss_ids, b.tile_start, b.tile_end, tp.xys, tp.conics,
            _t(leaves[3]), _t(leaves[2][:, :3]), _t(leaves[4][:3]), H, W)
        assert int((b.tile_end - b.tile_start).max()) > 4 * chunk
        stops = fidx[fidx < traster.STOP_SENTINEL].long()
        assert bool(((stops % chunk) != 0).any())


def _state():
    js = _jax_state()
    return js, state_from_numpy(_to_numpy(js), device="cpu")


def _jax_leaves(js):
    return {k: getattr(js.params, k) for k in PARAM_NAMES}


@pytest.mark.parametrize("renderer", ["dense", "tiled"])
def test_render_forward_matches_jax(renderer):
    """render_forward and the gradients of a fixed scalar of its image and
    final T with respect to every parameter leaf."""
    js, ts = _state()
    c2w, _, f = _camera()
    bg = np.asarray(DEFAULT_BACKGROUND, np.float32)
    w_img = np.random.default_rng(4).normal(size=(H, W, 3)).astype(np.float32)

    def jloss(params):
        out = jrender(js.params.replace(**params), js.alive, jnp.asarray(c2w),
                      f, f, W / 2, H / 2, H, W, 3, jnp.asarray(bg),
                      renderer=renderer)
        return (jnp.sum(out.rgb * w_img) + jnp.sum(out.final_t),
                (out.rgb, out.final_t, out.n_cands, out.n_isects))

    (_, (rgb_j, ft_j, nc_j, ni_j)), g_j = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(_jax_leaves(js))
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in ts.params.as_dict().items()}
    out = render_forward(type(ts.params)(**leaves), ts.alive,
                         torch.from_numpy(c2w), f, f, W / 2, H / 2, H, W, 3,
                         torch.from_numpy(bg), renderer=renderer,
                         device="cpu")
    loss = (torch.sum(out.rgb * torch.from_numpy(w_img))
            + torch.sum(out.final_t))
    g_t = torch.autograd.grad(loss, [leaves[k] for k in PARAM_NAMES])
    _assert_image_close(out.rgb.detach(), rgb_j, "rgb")
    _assert_image_close(out.final_t.detach(), ft_j, "final_T")
    assert int(out.n_cands) == int(nc_j) and int(out.n_isects) == int(ni_j)
    for k, g in zip(PARAM_NAMES, g_t):
        _assert_bulk_close(g.numpy(), np.asarray(g_j[k]), name=k)


@pytest.mark.parametrize("mode", ["expected", "accumulated"])
def test_render_depth_matches_jax(mode):
    js, ts = _state()
    c2w, _, f = _camera()
    d_j, a_j = jax.jit(jrender_depth, static_argnames=(
        "height", "width", "mode"))(js.params, js.alive, jnp.asarray(c2w),
                                    f, f, W / 2, H / 2, height=H, width=W,
                                    mode=mode)
    d_t, a_t = render_depth(ts.params, ts.alive, torch.from_numpy(c2w), f, f,
                            W / 2, H / 2, H, W, mode=mode, device="cpu")
    assert np.isfinite(d_t.numpy()).all() and float(a_t.max()) > 0.5
    _assert_image_close(a_t, a_j, "alpha")
    # depth is z-weighted (z ~ 3-5 here): hold it at the same relative
    # precision as the image
    _assert_image_close(d_t / 10.0, np.asarray(d_j) / 10.0, "depth")


@pytest.mark.parametrize("renderer", ["dense", "tiled"])
def test_train_step_matches_jax(renderer):
    """One step from one state in both packages through the same float32
    renderer: loss, the demand counters, every leaf's gradient (from
    Adam's first moment) and the post-Adam parameters."""
    js, ts = _state()
    start = _to_numpy(js)
    c2w, gt, f = _camera()
    cfg, tcfg = JConfig(), TrainConfig()
    lr_means = 1.6e-4
    js, jm = jax.jit(jstep, static_argnames=STATIC)(
        js, jnp.asarray(c2w), f, f, W / 2, H / 2, jnp.asarray(gt), lr_means,
        height=H, width=W, sh_deg=3, cfg=cfg, accumulate=True,
        renderer=renderer, isect_budget=16 * 320 + 256)
    ts, tm = train_step_impl(ts, torch.from_numpy(c2w), f, f, W / 2, H / 2,
                             torch.from_numpy(gt), lr_means, H, W, 3, tcfg,
                             True, renderer=renderer)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-3)
    for k in ("n_cands", "n_isects", "n_grads"):
        assert int(tm[k]) == int(jm[k]), k
    end = _to_numpy(js)
    for k in PARAM_NAMES:
        g_j = _g(end["mu"][k], start["mu"][k])
        g_t = _g(ts.opt.mu[k].numpy(), start["mu"][k])
        scale = np.abs(g_j).max()
        np.testing.assert_allclose(g_t, g_j, rtol=0, atol=1e-5 * scale,
                                   err_msg=f"grad {k}")
        p_j, p_t = end["params"][k], ts.params.as_dict()[k].numpy()
        above = np.abs(g_j) > 1e-3 * scale
        np.testing.assert_allclose(p_t[above], p_j[above],
                                   atol=4e-3 * np.abs(p_j).max(),
                                   err_msg=f"param {k}")


def _oracle_scene():
    s = make_scene(n=300, seed=3)
    xys, _, conics, cov2d, cam_depths = joracle.np_project_gaussians(
        s["means"], s["scales"], 1.0, s["quats"], s["viewmat"], s["projmat"],
        s["fx"], s["fy"], s["cx"], s["cy"], H, W)
    rng = np.random.default_rng(42)
    v_out = rng.normal(size=(H, W, 3)).astype(np.float32)
    v_oa = rng.normal(size=(H, W)).astype(np.float32)
    return s, xys, conics, cov2d, cam_depths, v_out, v_oa


def test_oracle_backward_matches_jax():
    """np_pixel_gaussians gives the JAX forward's px2gid lists, and
    np_rasterize_backward the JAX oracle backward's gradients."""
    s, xys, conics, cov2d, cam_depths, v_out, v_oa = _oracle_scene()
    img_j, T_j, px2gid_j = joracle.np_rasterize_forward(
        W, H, xys, conics, s["colors"], s["opacities"], s["background"],
        cov2d, cam_depths)
    img_t, T_t = np_rasterize_forward(W, H, xys, conics, s["colors"],
                                      s["opacities"], s["background"], cov2d,
                                      cam_depths)
    np.testing.assert_array_equal(img_t, img_j)
    np.testing.assert_array_equal(T_t, T_j)
    px2gid = np_pixel_gaussians(W, H, xys, conics, s["opacities"], cov2d,
                                cam_depths)
    assert px2gid == px2gid_j and sum(map(len, px2gid)) > 1000
    args = (H, W, xys, conics, s["colors"], s["opacities"], s["background"],
            T_t)
    got = np_rasterize_backward(*args, px2gid, v_out, v_oa)
    want = joracle.np_rasterize_backward(*args, px2gid_j, v_out, v_oa)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)


def test_dense_gradients_match_the_oracle():
    """The port's dense renderer against the port's oracle backward (the
    oracle's v_output_alpha is the cotangent of 1 - final_T, so the
    renderer's final_T takes -v_oa)."""
    s, xys, conics, cov2d, cam_depths, v_out, v_oa = _oracle_scene()
    T_o = np_rasterize_forward(W, H, xys, conics, s["colors"],
                               s["opacities"], s["background"], cov2d,
                               cam_depths)[1]
    want = np_rasterize_backward(
        H, W, xys, conics, s["colors"], s["opacities"], s["background"], T_o,
        np_pixel_gaussians(W, H, xys, conics, s["opacities"], cov2d,
                           cam_depths), v_out, v_oa)
    leaves = [torch.tensor(a, requires_grad=True) for a in
              (xys, conics, s["colors"], s["opacities"], s["background"])]
    img, ft = rasterize(*leaves[:4], torch.from_numpy(cam_depths),
                        torch.ones(300, dtype=torch.bool), leaves[4], H, W)
    g = torch.autograd.grad([img, ft], leaves, [torch.from_numpy(v_out),
                                                -torch.from_numpy(v_oa)])
    for name, a, b in zip(("v_xy", "v_conic", "v_colors", "v_opacity"), g,
                          want):
        _assert_bulk_close(a.numpy(), b, name=name)
    np.testing.assert_allclose(g[4].numpy(),
                               (T_o[..., None] * v_out).sum((0, 1)),
                               rtol=1e-3, atol=1e-3)


def test_full_bbox_binning_matches_jax():
    """bin_gaussians without opacities keeps every tile-bbox pair, as the
    JAX bin_gaussians(opacities=None): the same Gaussian ids in the same
    order in every tile range, and isect_counts = num_tiles_hit."""
    proj, leaves, _ = _scene(300, 5, 3)
    total = int(jnp.sum(proj.num_tiles_hit))
    jb = jbin(proj, H, W, -(-total // 128) * 128)
    tp = ProjectedGaussians(*[_t(getattr(proj, f))
                              for f in ProjectedGaussians._fields])
    b = bin_gaussians(tp, H, W)
    assert b.n_cands == total == int(b.n_isects) == int(b.tile_end[-1])
    np.testing.assert_array_equal(b.isect_counts.numpy(),
                                  np.asarray(proj.num_tiles_hit))
    np.testing.assert_array_equal(b.tile_start.numpy(),
                                  np.asarray(jb.tile_start))
    np.testing.assert_array_equal(b.tile_end.numpy(), np.asarray(jb.tile_end))
    np.testing.assert_array_equal(b.gauss_ids.numpy(),
                                  np.asarray(jb.gauss_ids)[:total])
    culled = bin_gaussians(tp, H, W, _t(leaves[3]))
    assert int(culled.n_isects) < total
