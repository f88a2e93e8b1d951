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


def _stress_inputs(seed, n=300, size=128):
    """Expansion inputs that stress a candidate-row-parallel kernel: three
    Gaussians span every tile of a size x size frame (one has more rows
    than a warp has lanes), 60% have no rows, one has a saturated mean,
    and small tile boxes lie between them. Numpy fields from a seed."""
    rng = np.random.default_rng(seed)
    tb = (size + 15) // 16
    tmin = rng.integers(0, tb, (n, 2))
    tmax = np.minimum(tmin + rng.integers(1, 4, (n, 2)), tb)
    zero = rng.uniform(size=n) < 0.6
    tmax[zero] = tmin[zero]
    span = [2, n // 2, n - 1]
    tmin[span] = 0
    tmax[span] = tb
    cnt = np.prod(tmax - tmin, 1).astype(np.int32)
    xys = rng.uniform(-20.0, size + 20.0, (n, 2)).astype(np.float32)
    a = np.exp(rng.uniform(np.log(0.002), np.log(2.0), (n, 2)))
    rho = rng.uniform(-0.9, 0.9, n)
    conics = np.stack([a[:, 0], rho * np.sqrt(a[:, 0] * a[:, 1]), a[:, 1]],
                      1).astype(np.float32)
    conics[span[0]] = [2e-4, 0.0, 3e-4]  # wide: keeps most of its rows
    xys[span[0]] = size / 2.0
    xys[5] = 1e5  # saturated: every row keeps
    opac = rng.uniform(0.005, 1.0, n).astype(np.float32)
    depths = rng.uniform(0.5, 20.0, n).astype(np.float32)
    return dict(cnt=cnt, tile_min=tmin.astype(np.int32),
                tile_max=tmax.astype(np.int32), depths=depths, xys=xys,
                conics=conics, opac=opac, H=size, W=size)


def _scene_inputs(seed):
    sc, proj, _, opac = _projected(seed)
    return dict(cnt=np.asarray(proj.num_tiles_hit).astype(np.int32),
                tile_min=np.asarray(proj.tile_min).astype(np.int32),
                tile_max=np.asarray(proj.tile_max).astype(np.int32),
                depths=np.asarray(proj.depths), xys=np.asarray(proj.xys),
                conics=np.asarray(proj.conics), opac=np.asarray(opac),
                H=sc["H"], W=sc["W"])


@pytest.mark.parametrize("seed", [3, 8, "stress"])
def test_expand_matches_pallas_kernel(seed):
    """The stream row for row and the kept counts, exactly, on projected
    scenes and on the stress inputs (Gaussians spanning every tile beside
    zero-count ones)."""
    stress = seed == "stress"
    d = _stress_inputs(5) if stress else _scene_inputs(seed)
    j = {k: jnp.asarray(v) for k, v in d.items() if k not in ("H", "W")}
    total = int(d["cnt"].sum())
    n_rows = ((total + 127) // 128) * 128 + 128
    s_max = jnp.log(jnp.maximum(j["opac"], 1e-12) / ALPHA_THRESH)
    depth_bits = jax.lax.bitcast_convert_type(j["depths"], jnp.int32)
    jt, jd, jg, jk = pallas_expand_bin(
        j["cnt"], j["tile_min"], j["tile_max"], depth_bits, d["H"], d["W"],
        n_rows, xys=j["xys"], conics=j["conics"], s_max=s_max, cull=True,
        interpret=True)
    t = {k: torch.from_numpy(np.array(v)) for k, v in d.items()
         if k not in ("H", "W")}
    cnt = t["cnt"]
    starts = torch.cumsum(cnt.long(), 0) - cnt.long()
    tb_x, tb_y = tbin.num_tiles(d["H"], d["W"])
    keys, gids, kept = texpand.expand(
        cnt, starts, total, t["tile_min"], t["tile_max"], t["depths"],
        t["xys"], t["conics"], torch.tensor(np.asarray(s_max)), tb_x,
        tb_x * tb_y)
    assert texpand.expand.launches == 0  # CPU tensors: the plain version
    np.testing.assert_array_equal(kept.numpy(), np.asarray(jk))
    # the candidate streams are Gaussian-major on both sides: row for row
    tile = (keys >> 32).numpy()
    depth = (keys & 0xFFFFFFFF).numpy().astype(np.uint32).view(np.int32)
    np.testing.assert_array_equal(tile, np.asarray(jt)[:total])
    np.testing.assert_array_equal(depth, np.asarray(jd)[:total])
    np.testing.assert_array_equal(gids.numpy(), np.asarray(jg)[:total])
    assert 0 < int(kept.sum()) < total  # the cull dropped some pairs
    if stress:
        assert int(cnt.max()) == tb_x * tb_y > 32
        assert int(kept.max()) > 32  # one Gaussian keeps > a warp of rows
        assert float((cnt == 0).float().mean()) > 0.5


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
