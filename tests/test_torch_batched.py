"""The batched multi-view step on the CPU: V views through one call of
each kernel.

The kernels' plain versions (the wrappers take them for CPU tensors)
over 3 views of 48x40 px and 320 Gaussians (one view sees none, one has
its Gaussians across the padded right edge) equal the per-view calls
bitwise: expand's keys, gids and kept counts (a view's keys offset by
its first tile, its gids by its first Gaussian), the forward's image,
final T and final_idx, the backward's rows (at the view's candidate
offset) and the segment sums. Against the JAX package (2 scenes of
tests/test_multi_scene.py: 32x32 px, SH 1, 64 Gaussians at capacity
128, scales made anisotropic as in tests/test_torch_train_step.py,
states from state_from_numpy): multi_scene_train_step against the
JAX vmapped step on its float32 tiled renderer (loss rtol 1e-5,
parameters rtol 2e-4 atol 5e-6, as tests/test_multi_scene.py), and
against the JAX vmapped renderer "pallas" in interpret mode (per-scene
loss rtol 1e-3; the batched render's images atol 4e-3, the JAX Pallas
path's colour quantisation, tests/test_pallas_raster.py:37)."""
import numpy as np
import jax
import jax.numpy as jnp
import torch

from opensplat_tpu.config import TrainConfig as JConfig
from opensplat_tpu.models.gaussians import init_model as jinit
from opensplat_tpu.models.splat_model import render_forward as jrender
from opensplat_tpu.optim.adam import means_lr_schedule
from opensplat_tpu.parallel.multi_scene import (
    multi_scene_train_step as jmulti_step)
from opensplat_tpu.parallel.multi_scene import stack_states as jstack
from opensplat_tpu_torch.config import TrainConfig
from opensplat_tpu_torch.models.gaussians import (PARAM_NAMES, init_model,
                                                  state_from_numpy)
from opensplat_tpu_torch.models.splat_model import (DEFAULT_BACKGROUND,
                                                    render_forward)
from opensplat_tpu_torch.ops.binning import bin_gaussians, num_tiles
from opensplat_tpu_torch.ops.camera import camera_matrices
from opensplat_tpu_torch.ops.kernels import expand, raster, segsum
from opensplat_tpu_torch.ops.projection import (ProjectedGaussians,
                                                project_gaussians)
from opensplat_tpu_torch.ops.sh import spherical_harmonics
from opensplat_tpu_torch.parallel.multi_scene import (multi_scene_train_step,
                                                      stack_states)

# one intra-op thread per process: the suite runs one pytest-xdist
# worker per core, and a full torch thread pool in each of them
# oversubscribes the cores
torch.set_num_threads(1)


# ---- the kernels' plain versions: a batch against its views -------------

KH, KW, KN, KCAP = 48, 40, 300, 320


def _view_inputs():
    """Per view: the projection, colours and opacities of one state
    seen by three cameras: the scene, nothing (turned away), the scene
    shifted onto the padded right edge (x = 40..47 is padding)."""
    rng = np.random.default_rng(7)
    pts = rng.uniform(-1, 1, (KN, 3)).astype(np.float32)
    rgb = rng.integers(0, 255, (KN, 3)).astype(np.uint8)
    st = init_model(pts, rgb, 1, capacity=KCAP, seed=7, device="cpu")
    p = st.params
    eyes = ((0.1, 0.0, 4.0), (0.0, 0.0, -4.0), (-1.2, 0.2, 4.0))
    out = []
    with torch.no_grad():
        opac = torch.sigmoid(p.opacities).reshape(-1)
        for eye in eyes:
            c2w = torch.eye(4)
            c2w[:3, 3] = torch.tensor(eye)
            vm, pm, pos = camera_matrices(c2w, 36.0, 36.0, KW, KH)
            proj = project_gaussians(
                p.means, torch.exp(p.scales), 1.0,
                p.quats / p.quats.norm(dim=-1, keepdim=True), vm, pm, 36.0,
                36.0, KW / 2, KH / 2, KH, KW, valid_mask=st.alive,
                opacities=opac)
            vd = torch.nn.functional.normalize(p.means - pos, dim=-1)
            col = torch.clamp(spherical_harmonics(1, vd, torch.cat(
                [p.features_dc[:, None], p.features_rest], 1)) + 0.5, min=0)
            out.append((proj, col.contiguous(), opac))
    return out


def test_plain_kernels_batch_equals_views():
    views = _view_inputs()
    nv, c = len(views), KCAP
    tb_x, tb_y = num_tiles(KH, KW)
    nt = tb_x * tb_y
    assert int(views[1][0].num_tiles_hit.sum()) == 0  # sees nothing
    edge = views[2][0].tile_max[:, 0] == tb_x  # reaches the padded column
    assert int((views[2][0].num_tiles_hit > 0)[edge].sum()) > 10
    proj_b = ProjectedGaussians(*(torch.stack(f) for f in
                                  zip(*(v[0] for v in views))))
    opac_b = torch.stack([v[2] for v in views])
    bins = [bin_gaussians(v[0], KH, KW, v[2]) for v in views]
    bb = bin_gaussians(proj_b, KH, KW, opac_b)
    assert bb.n_isects.tolist() == [int(b.n_isects) for b in bins]

    # expand: one call over the views against a call a view
    def args(proj, opac):
        cnt = proj.num_tiles_hit.reshape(-1).int()
        starts = torch.cumsum(cnt.long(), 0) - cnt.long()
        s_max = torch.log(torch.clamp(opac.reshape(-1), min=1e-12) * 255.0)
        return (cnt, starts, int(cnt.sum()),
                proj.tile_min.reshape(-1, 2).int(),
                proj.tile_max.reshape(-1, 2).int(),
                proj.depths.reshape(-1), proj.xys.reshape(-1, 2),
                proj.conics.reshape(-1, 3), s_max, tb_x, nt)
    kb, gb, keptb = expand.expand(*args(proj_b, opac_b), per_view=c)
    sent_b = ((nv * nt) << 32) | expand.INT32_MAX
    off = 0
    for v, (proj, _, opac) in enumerate(views):
        k, g, kept = expand.expand(*args(proj, opac))
        rows = slice(off, off + k.shape[0])
        keep = g < c
        assert torch.equal(keptb.reshape(nv, c)[v], kept)
        assert torch.equal(kb[rows], torch.where(
            keep, k + ((v * nt) << 32), torch.full_like(k, sent_b)))
        assert torch.equal(gb[rows], torch.where(keep, g + v * c, nv * c))
        off += k.shape[0]
    assert off == kb.shape[0] == bb.n_cands

    # the forward, backward and segment sum over the binned batch
    def fields(vs):
        """(xys, conics, colours, opacities) of views concatenated."""
        return [torch.cat(ts).contiguous() for ts in
                zip(*((v[0].xys, v[0].conics, v[1], v[2]) for v in vs))]
    bg = torch.tensor([[0.1, 0.2, 0.3], [0.0, 0.5, 1.0], [0.6, 0.0, 0.4]])
    xb, cb, colb, ob = fields(views)
    img_b, ft_b, fi_b = raster.rasterize_forward(
        bb.gauss_ids, bb.tile_start, bb.tile_end, xb, cb, ob, colb, bg, KH,
        KW, views=nv)
    gen = torch.Generator().manual_seed(3)
    v_img = torch.randn((nv, KH, KW, 3), generator=gen)
    v_ft = torch.randn((nv, KH, KW), generator=gen)
    rows_b = raster.rasterize_backward(
        bb.gauss_ids, bb.tile_start, bb.tile_end, xb, cb, ob, colb, bg,
        ft_b, fi_b, v_img, v_ft, bb.cand_index, KH, KW, views=nv)
    sums_b = segsum.segment_sum(rows_b, bb.cand_start, bb.cand_count)
    cand_off = 0
    for v, (b, view) in enumerate(zip(bins, views)):
        x, cc, col, o = fields([view])
        img, ft, fi = raster.rasterize_forward(
            b.gauss_ids, b.tile_start, b.tile_end, x, cc, o, col, bg[v], KH,
            KW)
        assert torch.equal(img_b[v], img) and torch.equal(ft_b[v], ft)
        base = int(bb.tile_start[v * nt])
        assert torch.equal(fi_b[v * nt:(v + 1) * nt], torch.where(
            fi == raster.STOP_SENTINEL, fi, fi + base))
        rows = raster.rasterize_backward(
            b.gauss_ids, b.tile_start, b.tile_end, x, cc, o, col, bg[v], ft,
            fi, v_img[v], v_ft[v], b.cand_index, KH, KW)
        assert torch.equal(rows_b[cand_off:cand_off + b.n_cands], rows)
        assert torch.equal(sums_b.reshape(nv, c, 9)[v], segsum.segment_sum(
            rows, b.cand_start, b.cand_count))
        cand_off += b.n_cands
    assert float(rows_b.abs().max()) > 0.0
    assert raster.rasterize_forward.launches == 0  # the plain versions


# ---- the batched multi-scene step against the JAX vmapped step ----------

H = W = 32
CAP = 128
CFG = JConfig(num_iters=100, capacity_round=CAP)
LR = float(means_lr_schedule(CFG.lr_means, CFG.lr_means_final,
                             CFG.num_iters, 0))


def _np_state(js):
    return {
        "params": {k: np.asarray(getattr(js.params, k)) for k in PARAM_NAMES},
        "alive": np.asarray(js.alive),
        "mu": {k: np.asarray(getattr(js.opt.mu, k)) for k in PARAM_NAMES},
        "nu": {k: np.asarray(getattr(js.opt.nu, k)) for k in PARAM_NAMES},
        "count": int(js.opt.count),
        "stats": {k: np.asarray(getattr(js.stats, k)) for k in
                  ("xys_grad_norm", "vis_counts", "max_2d_size",
                   "initialized")},
    }


def _scenes(s=2):
    """tests/test_multi_scene.py's scenes with anisotropic scales, each
    as both packages' state."""
    jstates, tstates, cams, gts = [], [], [], []
    for i in range(s):
        rng = np.random.default_rng(100 + i)
        pts = rng.uniform(-1.0, 1.0, (64, 3)).astype(np.float32)
        rgb = rng.integers(0, 255, (64, 3)).astype(np.uint8)
        js = jinit(pts, rgb, sh_degree=1, capacity=CAP, seed=i)
        # anisotropic scales, so that rotations carry real gradients
        ds = np.zeros((CAP, 3), np.float32)
        ds[:64] = rng.uniform(-0.5, 0.5, (64, 3))
        js = js.replace(params=js.params.replace(
            scales=js.params.scales + ds))
        jstates.append(js)
        tstates.append(state_from_numpy(_np_state(js), device="cpu"))
        c2w = np.eye(4, dtype=np.float32)
        c2w[2, 3] = 4.0 + 0.2 * i
        cams.append(c2w)
        gts.append(rng.uniform(0, 1, (H, W, 3)).astype(np.float32))
    return jstates, stack_states(tstates), np.stack(cams), np.stack(gts)


def _steps(renderer):
    s = 2
    jstates, tstate, cams, gts = _scenes(s)
    f, c = [40.0] * s, [W / 2.0] * s
    jnew, jm = jax.jit(jmulti_step, static_argnums=(8, 9, 10, 11, 12, 13))(
        jstack(jstates), jnp.asarray(cams), jnp.asarray(f), jnp.asarray(f),
        jnp.asarray(c), jnp.asarray(c), jnp.asarray(gts), LR, H, W, 1, CFG,
        True, renderer)
    tnew, tm = multi_scene_train_step(
        tstate, torch.from_numpy(cams), f, f, c, c, torch.from_numpy(gts),
        LR, H, W, 1, TrainConfig(num_iters=100, capacity_round=CAP), True)
    assert tm["loss"].shape == (s,)
    return jstates, jnew, jm, tnew, tm, cams


def test_multi_scene_step_matches_jax_tiled():
    _, jnew, jm, tnew, tm, _ = _steps("tiled")
    np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]),
                               rtol=1e-5)
    for k in ("means", "scales", "quats", "features_dc", "opacities"):
        np.testing.assert_allclose(getattr(tnew.params, k).numpy(),
                                   np.asarray(getattr(jnew.params, k)),
                                   rtol=2e-4, atol=5e-6, err_msg=k)
    assert tnew.opt.count == 1
    np.testing.assert_array_equal(tm["n_visible"].numpy(),
                                  np.asarray(jm["n_visible"]))


def test_multi_scene_step_matches_jax_pallas():
    jstates, _, jm, _, tm, cams = _steps("pallas")
    np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]),
                               rtol=1e-3)
    # the batched render of the start states against the vmapped Pallas
    # forward
    bg = jnp.asarray(DEFAULT_BACKGROUND, jnp.float32)
    jimg = jax.jit(jax.vmap(lambda st, c2w: jrender(
        st.params, st.alive, c2w, 40.0, 40.0, W / 2, H / 2, H, W, 1, bg,
        renderer="pallas").rgb))(jstack(jstates), jnp.asarray(cams))
    tstate = stack_states([state_from_numpy(_np_state(js), device="cpu")
                           for js in jstates])
    with torch.no_grad():
        out = render_forward(tstate.params, tstate.alive,
                             torch.from_numpy(cams), [40.0] * 2, [40.0] * 2,
                             [W / 2] * 2, [H / 2] * 2, H, W, 1,
                             torch.tensor(DEFAULT_BACKGROUND), device="cpu")
    assert out.rgb.shape == (2, H, W, 3)
    np.testing.assert_allclose(out.rgb.numpy(), np.asarray(jimg), atol=4e-3)
