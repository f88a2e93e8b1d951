"""opensplat_tpu_torch.rasterize_fast against the JAX package's
rasterize_pallas (Pallas kernels in interpret mode) on the CPU.

Tolerances are the JAX package's own cross-renderer ones
(tests/test_pallas_raster.py:37-38,59): the JAX records carry colours as
10-bit fixed point (step 1/256) and gradients as bf16, while the port
keeps float32 throughout — image atol 4e-3, final_t atol 1e-5, gradients
atol 4e-3 * scale and rtol 4e-3. Intersection counts are exact."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from opensplat_tpu.ops.pallas import raster as jraster
from opensplat_tpu.ops.pallas.integration import rasterize_pallas
from opensplat_tpu.ops.projection import project_gaussians as jproject
from opensplat_tpu.ops.rasterize_tiled import _image_to_tiles, _tiles_to_image
from opensplat_tpu_torch.ops.binning import bin_gaussians
from opensplat_tpu_torch.ops.kernels import raster as traster
from opensplat_tpu_torch.ops.kernels.integration import rasterize_fast
from opensplat_tpu_torch.ops.projection import ProjectedGaussians
from scene_utils import make_scene

# one intra-op thread per process: the suite runs one pytest-xdist
# worker per core, and a full torch thread pool in each of them
# oversubscribes the cores
torch.set_num_threads(1)


def _setup(n, seed, height=None, width=None, spread=1.0):
    s = make_scene(n=n, seed=seed, spread=spread)
    h = height or s["H"]
    w = width or s["W"]
    opac = jnp.asarray(s["opacities"])
    proj = jproject(
        jnp.asarray(s["means"]), jnp.asarray(s["scales"]), 1.0,
        jnp.asarray(s["quats"]), jnp.asarray(s["viewmat"]),
        jnp.asarray(s["projmat"]), s["fx"], s["fy"], s["cx"], s["cy"], h, w,
        mode="gpu", opacities=opac)
    jargs = [proj.xys, proj.conics, jnp.asarray(s["colors"]), opac]
    common = [proj.depths, proj.radii, proj.num_tiles_hit, proj.tile_min,
              proj.tile_max]
    budget = int(jnp.sum(proj.num_tiles_hit)) + 256
    return s, h, w, jargs, common, budget


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


@pytest.mark.parametrize(
    "n,seed,height,width,spread",
    [(200, 2, None, None, 1.0), (250, 3, 50, 70, 1.0),
     (300, 7, None, None, 0.15)],
    ids=["200-2-None-None", "250-3-50-70", "dense"])
def test_forward_matches_pallas(n, seed, height, width, spread):
    """The dense case crowds the scene onto the four central tiles: each
    holds more records than four of the CUDA kernel's 64-record chunks,
    and pixels stop inside a chunk past the first (both checked on the
    port's own binning)."""
    s, h, w, jargs, common, budget = _setup(n, seed, height, width, spread)
    bg = jnp.asarray(s["background"])
    img_j, ft_j, ni_j, ng_j = rasterize_pallas(
        *jargs, *common, bg, h, w, max_isects=budget, return_isects=True)
    img_t, ft_t, ni_t, ng_t = rasterize_fast(
        *[_t(a) for a in jargs], *[_t(c) for c in common],
        _t(s["background"]), h, w, return_isects=True, device="cpu")
    assert img_t.shape == (h, w, 3) and ft_t.shape == (h, w)
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), atol=4e-3)
    np.testing.assert_allclose(ft_t.numpy(), np.asarray(ft_j), atol=1e-5)
    assert int(ni_t) == int(ni_j) > 0
    assert int(ng_t) == int(ng_j) > 0
    if spread < 1.0:
        b, args = _backward_inputs(n, seed, spread)
        fidx = args[9].long()
        counts = b.tile_end - b.tile_start
        assert int(counts.max()) > 4 * 64
        stopped = fidx < traster.STOP_SENTINEL
        assert float(stopped[int(counts.argmax())].float().mean()) > 0.2
        into = (fidx - b.tile_start.long()[:, None])[stopped]
        assert bool(((into > 64) & (into % 64 != 63)).any())


def test_backward_matches_pallas():
    s, h, w, jargs, common, budget = _setup(150, 5)
    rng = np.random.default_rng(0)
    vi = rng.normal(size=(h, w, 3)).astype(np.float32)
    vt = rng.normal(size=(h, w)).astype(np.float32)

    def f(a, b, c, d, bg):
        return rasterize_pallas(a, b, c, d, *common, bg, h, w,
                                max_isects=budget)

    _, vjp = jax.vjp(f, *jargs, jnp.asarray(s["background"]))
    g_j = vjp((jnp.asarray(vi), jnp.asarray(vt)))
    leaves = [_t(a, grad=True) for a in jargs + [s["background"]]]
    img, ft = rasterize_fast(*leaves[:4], *[_t(c) for c in common],
                             leaves[4], h, w, device="cpu")
    ((img * torch.from_numpy(vi)).sum()
     + (ft * torch.from_numpy(vt)).sum()).backward()
    for name, leaf, b in zip(["xys", "conics", "colors", "opac", "bg"],
                             leaves, g_j):
        a, b = leaf.grad.numpy(), np.asarray(b)
        scale = np.abs(b).max() + 1e-12
        np.testing.assert_allclose(a, b, atol=4e-3 * scale, rtol=4e-3,
                                   err_msg=name)


def _backward_inputs(n, seed, spread=1.0):
    """The port's binning of a JAX-projected scene, its plain forward, and
    random cotangents: (binned, backward args without out_index)."""
    s, h, w, jargs, common, _ = _setup(n, seed, spread=spread)
    xys, conics, colors, opac = [_t(a) for a in jargs]
    depths, radii, nth, tmin, tmax = [_t(c) for c in common]
    proj = ProjectedGaussians(
        xys=xys, depths=depths, cam_depths=depths, radii=radii,
        conics=conics, cov2d=conics, num_tiles_hit=nth, tile_min=tmin,
        tile_max=tmax, mask=radii > 0)
    b = bin_gaussians(proj, h, w, opac)
    bg = _t(s["background"])
    fwd = (b.gauss_ids, b.tile_start, b.tile_end, xys, conics, opac, colors,
           bg, h, w)
    _, final_t, fidx = traster.rasterize_forward_plain(*fwd)
    rng = np.random.default_rng(seed)
    v_img = torch.from_numpy(rng.normal(size=(h, w, 3)).astype(np.float32))
    v_ft = torch.from_numpy(rng.normal(size=(h, w)).astype(np.float32))
    return b, fwd[:8] + (final_t, fidx, v_img, v_ft)


def test_backward_rows_land_at_cand_index():
    """Record i's row lands at row cand_index[i]: gathered back by
    cand_index the rows equal the stream-order rows exactly, and the
    culled candidates' rows (the stream's tail past the last tile) are
    zero."""
    b, args = _backward_inputs(150, 5)
    h, w = args[8].shape
    n = b.gauss_ids.shape[0]
    stream_rows = traster.rasterize_backward_plain(
        *args, torch.arange(n, dtype=torch.int32), h, w)
    rows = traster.rasterize_backward_plain(*args, b.cand_index, h, w)
    assert torch.equal(rows[b.cand_index.long()], stream_rows)
    kept = int(b.n_isects)
    assert 0 < kept < n  # the scene has culled candidates
    assert int(b.tile_end[-1]) == kept
    assert not bool(rows[b.cand_index[kept:].long()].any())
    assert bool(stream_rows[:kept].any())
    # Gaussian g's rows are its candidate segment
    assert torch.equal(b.cand_start, torch.cumsum(b.cand_count.long(), 0)
                       - b.cand_count.long())


def test_backward_moments_match_direct():
    """The plain backward's moment reduction (the kernel's algebra)
    against the direct nine-term sums in float64, at the card check's
    tolerance, rtol 1e-3 + atol 1e-5 * max|g|: the moments are float32
    sums recombined in tile-local coordinates, whose cancellation costs a
    few float32 ulps of the largest term, far inside it; a wrong sign,
    factor or tile centre is not."""
    b, args = _backward_inputs(150, 5)
    h, w = args[8].shape
    n = b.gauss_ids.shape[0]
    rows = torch.arange(n, dtype=torch.int32)
    got = traster.rasterize_backward_plain(*args, rows, h, w).double()
    ref = traster.rasterize_backward_direct(*args, rows, h, w)
    assert bool((ref != 0).any(dim=0).all())  # every term is exercised
    scale = float(ref.abs().max())
    bad = (got - ref).abs() > 1e-3 * ref.abs() + 1e-5 * scale
    assert not bool(bad.any()), (
        f"{int(bad.sum())} of {bad.numel()} values; max err "
        f"{float((got - ref).abs().max())}, scale {scale}")


def test_empty_scene():
    s, h, w, jargs, common, _ = _setup(16, 0)
    radii0 = np.zeros_like(np.asarray(common[1]))
    nth0 = np.zeros_like(np.asarray(common[2]))
    img, ft, n_isects, n_grads = rasterize_fast(
        *[_t(a) for a in jargs], _t(common[0]), _t(radii0), _t(nth0),
        _t(common[3]), _t(common[4]), _t(s["background"]), h, w,
        return_isects=True, device="cpu")
    np.testing.assert_allclose(
        img.numpy(), np.broadcast_to(s["background"], (h, w, 3)), atol=1e-6)
    np.testing.assert_allclose(ft.numpy(), 1.0, atol=1e-7)
    assert int(n_isects) == 0 and int(n_grads) == 0


def test_compact_grad_layout_matches_jax():
    rng = np.random.default_rng(1)
    n_tiles = 12
    counts = rng.integers(0, 700, n_tiles)
    counts[3] = 0
    ends = np.cumsum(counts).astype(np.int32)
    starts = (ends - counts).astype(np.int32)
    fidx = np.full((n_tiles, 256), 2**30, np.int32)
    for t in range(n_tiles):
        if counts[t]:
            stop = rng.uniform(size=256) < 0.7
            fidx[t, stop] = starts[t] + rng.integers(0, counts[t], stop.sum())
    jc, jn = jraster.compact_grad_layout(
        jnp.asarray(starts), jnp.asarray(ends),
        jnp.asarray(fidx.reshape(n_tiles, 1, 256)))
    tc, tn = traster.compact_grad_layout(
        torch.from_numpy(starts), torch.from_numpy(ends),
        torch.from_numpy(fidx))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert int(tn) == int(jn)


def test_tile_image_layout_matches_jax():
    rng = np.random.default_rng(2)
    h, w = 40, 56
    tb_x, tb_y = (w + 15) // 16, (h + 15) // 16
    img = rng.normal(size=(h, w, 3)).astype(np.float32)
    jt = np.asarray(_image_to_tiles(jnp.asarray(img), tb_x, tb_y, h, w))
    tt = traster.image_to_tiles(torch.from_numpy(img), tb_x, tb_y, h, w)
    np.testing.assert_array_equal(tt.numpy(), jt)
    back = traster.tiles_to_image(tt, tb_x, tb_y, h, w)
    np.testing.assert_array_equal(back.numpy(), img)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(_tiles_to_image(jnp.asarray(jt), tb_x, tb_y,
                                                 h, w)))
