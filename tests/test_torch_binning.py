"""opensplat_tpu_torch binning against the JAX package on the CPU.

Both sides get the same projected Gaussians (the JAX projection's
outputs, as numpy), so the expansion's cull must keep bit-identical sets:
kept counts, the unsorted candidate stream, the sorted gauss_ids and the
tile ranges are compared exactly, as tests/test_expand.py demands of the
JAX package's own two paths. The port's expansion here is its plain
PyTorch version (the CUDA kernel runs only on the card)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from opensplat_tpu.ops.binning import bin_gaussians as jbin
from opensplat_tpu.ops.binning import count_isects as jcount
from opensplat_tpu.ops.pallas.expand import pallas_expand_bin
from opensplat_tpu.ops.projection import project_gaussians as jproject
from opensplat_tpu.ops.rasterize import ALPHA_THRESH
from opensplat_tpu_torch.ops import binning as tbin
from opensplat_tpu_torch.ops.kernels import expand as texpand
from opensplat_tpu_torch.ops.projection import ProjectedGaussians
from scene_utils import make_scene

# one intra-op thread per process: the suite runs one pytest-xdist
# worker per core, and a full torch thread pool in each of them
# oversubscribes the cores
torch.set_num_threads(1)


def _projected(seed, n=400, spread=1.0):
    sc = make_scene(n=n, seed=seed, spread=spread)
    opac = jnp.asarray(sc["opacities"])
    proj = jproject(
        jnp.asarray(sc["means"]), jnp.asarray(sc["scales"]), 1.0,
        jnp.asarray(sc["quats"]), jnp.asarray(sc["viewmat"]),
        jnp.asarray(sc["projmat"]), sc["fx"], sc["fy"], sc["cx"], sc["cy"],
        sc["H"], sc["W"], opacities=opac,
    )
    tproj = ProjectedGaussians(*(torch.from_numpy(np.array(f))
                                 for f in proj))
    return sc, proj, tproj, opac


def _budget(proj):
    total = int(jnp.sum(proj.num_tiles_hit))
    return ((total + 127) // 128) * 128 + 128


@pytest.mark.parametrize("seed", [3, 8])
def test_expand_matches_pallas_kernel(seed):
    sc, proj, tp, opac = _projected(seed)
    n_rows = _budget(proj)
    s_max = jnp.log(jnp.maximum(opac, 1e-12) / ALPHA_THRESH)
    depth_bits = jax.lax.bitcast_convert_type(proj.depths, jnp.int32)
    jt, jd, jg, jk = pallas_expand_bin(
        proj.num_tiles_hit, proj.tile_min, proj.tile_max, depth_bits,
        sc["H"], sc["W"], n_rows, xys=proj.xys, conics=proj.conics,
        s_max=s_max, cull=True, interpret=True)
    cnt = tp.num_tiles_hit.to(torch.int32)
    starts = torch.cumsum(cnt.long(), 0) - cnt.long()
    total = int(cnt.sum())
    tb_x, tb_y = tbin.num_tiles(sc["H"], sc["W"])
    keys, gids, kept = texpand.expand(
        cnt, starts, total, tp.tile_min, tp.tile_max, tp.depths, tp.xys,
        tp.conics, torch.tensor(np.asarray(s_max)), tb_x, tb_x * tb_y)
    assert texpand.expand.launches == 0  # CPU tensors: the plain version
    np.testing.assert_array_equal(kept.numpy(), np.asarray(jk))
    # the candidate streams are Gaussian-major on both sides: row for row
    tile = (keys >> 32).numpy()
    depth = (keys & 0xFFFFFFFF).numpy().astype(np.uint32).view(np.int32)
    np.testing.assert_array_equal(tile, np.asarray(jt)[:total])
    np.testing.assert_array_equal(depth, np.asarray(jd)[:total])
    np.testing.assert_array_equal(gids.numpy(), np.asarray(jg)[:total])
    assert 0 < int(kept.sum()) < total  # the cull dropped some pairs


@pytest.mark.parametrize("seed,spread", [(3, 1.0), (5, 2.5)])
def test_bin_gaussians_matches_jax(seed, spread):
    sc, proj, tp, opac = _projected(seed, spread=spread)
    ref = jbin(proj, sc["H"], sc["W"], _budget(proj), opacities=opac,
               alpha_thresh=ALPHA_THRESH)
    got = tbin.bin_gaussians(tp, sc["H"], sc["W"], torch.tensor(
        np.asarray(opac)))
    n_isects = int(ref.n_isects)
    assert int(got.n_isects) == n_isects
    assert got.n_cands == int(jnp.sum(proj.num_tiles_hit))
    np.testing.assert_array_equal(got.isect_counts.numpy(),
                                  np.asarray(ref.isect_counts))
    np.testing.assert_array_equal(got.gauss_ids.numpy()[:n_isects],
                                  np.asarray(ref.gauss_ids)[:n_isects])
    # culled rows sort to the tail with the sentinel id on both sides
    assert (got.gauss_ids.numpy()[n_isects:] == proj.xys.shape[0]).all()
    assert (np.asarray(ref.gauss_ids)[n_isects:] == proj.xys.shape[0]).all()
    np.testing.assert_array_equal(got.tile_start.numpy(),
                                  np.asarray(ref.tile_start))
    np.testing.assert_array_equal(got.tile_end.numpy(),
                                  np.asarray(ref.tile_end))


def test_cull_keeps_every_contributing_pair():
    """Every (Gaussian, tile) pair with some pixel at alpha >= 1/255 (the
    rasterizer's own test) survives the cull."""
    sc, proj, tp, opac = _projected(4, n=300)
    got = tbin.bin_gaussians(tp, sc["H"], sc["W"],
                             torch.tensor(np.asarray(opac)))
    tb_x, tb_y = tbin.num_tiles(sc["H"], sc["W"])
    xys = np.asarray(proj.xys)
    con = np.asarray(proj.conics)
    op = np.asarray(opac)
    ly, lx = np.mgrid[0:16, 0:16].astype(np.float32)
    gid = got.gauss_ids.numpy()
    kept_pairs = set()
    for t in range(tb_x * tb_y):
        for i in range(int(got.tile_start[t]), int(got.tile_end[t])):
            kept_pairs.add((int(gid[i]), t))
    n_contrib = 0
    nth = np.asarray(proj.num_tiles_hit)
    tmin = np.asarray(proj.tile_min)
    tmax = np.asarray(proj.tile_max)
    for g in np.nonzero(nth > 0)[0]:
        for ty in range(tmin[g, 1], tmax[g, 1]):
            for tx in range(tmin[g, 0], tmax[g, 0]):
                dx = xys[g, 0] - (tx * 16 + lx)
                dy = xys[g, 1] - (ty * 16 + ly)
                A, B, C = con[g]
                sigma = 0.5 * (A * dx * dx + C * dy * dy) + B * dx * dy
                alpha = op[g] * np.exp(-sigma)
                if ((sigma >= 0) & (alpha >= np.float32(ALPHA_THRESH))).any():
                    n_contrib += 1
                    assert (int(g), ty * tb_x + tx) in kept_pairs, (g, tx, ty)
    assert n_contrib > 100
    assert len(kept_pairs) >= n_contrib


def test_count_isects():
    sc, proj, tp, _ = _projected(6)
    total, padded = jcount(proj, sc["H"], sc["W"], align=1)
    assert int(tbin.count_isects(tp)) == int(total) == int(padded) > 0
