"""The ablation bench's plain variants against the JAX bench on the CPU.

Each variant of opensplat_tpu_torch.ops.kernels.raster_variants (plain
PyTorch on CPU tensors) against tools/kbench_raster.py::build_variant(name)
run in interpret mode (pl.pallas_call patched with interpret=True for the
test), on make_stream(n_tiles=4, per_tile=300, tb_x=2) and on the same
records with uneven tile ranges (an empty tile, a one-chunk tile, a tile
spanning four chunks). Tolerances, those chip_smoke.py holds the CUDA
kernel to: full, nomatmul and nostop rgb atol 2e-4 (colours reach 4.0;
the JAX prefix is a float32 matmul, the port's a cumulative sum);
notrans, whose rgb goes negative and grows, rgb within 1e-4 of its
largest |value|; T atol 1e-5 in all four; skeleton exactly. The `real` case holds the main path's
rasterize_forward_plain to pallas_rasterize_forward(interpret=True) with
tests/test_torch_raster.py's tolerances: image atol 4e-3, final T atol
1e-5. `full` is also held to the forward that runs (rasterize_forward_plain,
zero background) at chip_smoke.py's tolerances for that pair (final_idx
equal on >= 99.9% of pixels; where it agrees, rgb atol 2e-4, T atol
1e-5), and the kernel's warp cull (warp_masks) must keep every record a
warp's pixels reach above 1/255.
"""
import functools
import importlib.util
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

from opensplat_tpu.ops.pallas import raster as R
from opensplat_tpu_torch.ops.kernels import raster, raster_variants
from opensplat_tpu_torch.tools import kbench_raster as tkb
from opensplat_tpu_torch.tools import sass_report

# one intra-op thread per process: the suite runs one pytest-xdist
# worker per core, and a full torch thread pool in each of them
# oversubscribes the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_TILES, PER_TILE, TB_X = 4, 300, 2


def _jax_bench():
    spec = importlib.util.spec_from_file_location(
        "jax_kbench_raster", os.path.join(REPO, "tools", "kbench_raster.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jkb():
    return _jax_bench()


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _streams(jkb, uneven):
    recs, ts, te = jkb.make_stream(n_tiles=N_TILES, per_tile=PER_TILE,
                                   tb_x=TB_X)
    st = tkb.make_stream(N_TILES, PER_TILE, TB_X, device="cpu")
    if uneven:  # the same records under tkb.UNEVEN's tile ranges
        ts = jnp.asarray(tkb.UNEVEN[0], jnp.int32)
        te = jnp.asarray(tkb.UNEVEN[1], jnp.int32)
        st = tkb.uneven_stream("cpu")
    return (recs, ts, te), st


def test_stream_matches_jax(jkb):
    (recs, ts, te), st = _streams(jkb, False)
    recs = np.asarray(recs)
    n = st.n_records
    np.testing.assert_array_equal(st.xys.numpy().T, recs[0:2, :n])
    np.testing.assert_array_equal(st.conics.numpy().T, recs[2:5, :n])
    np.testing.assert_array_equal(st.opac.numpy(), recs[5, :n])
    # the JAX kernels' 10-bit decode (raster.py::_chunk_fields)
    col = np.asarray(R._chunk_fields(jnp.asarray(recs))[6])
    np.testing.assert_array_equal(st.colors.numpy().T, col[:, :n])
    np.testing.assert_array_equal(st.tile_start.numpy(), np.asarray(ts))
    np.testing.assert_array_equal(st.tile_end.numpy(), np.asarray(te))


@pytest.mark.parametrize("uneven", [False, True], ids=["even", "uneven"])
@pytest.mark.parametrize("name", raster_variants.VARIANTS)
def test_variant_matches_jax(jkb, interpret, name, uneven):
    (recs, ts, te), st = _streams(jkb, uneven)
    acc_j = np.asarray(jkb.build_variant(name)(recs, ts, te, TB_X,
                                               N_TILES // TB_X))
    before = raster_variants.rasterize_variant.launches
    acc_t, fidx_t = raster_variants.rasterize_variant(
        name, *tkb.variant_args(st))
    assert raster_variants.rasterize_variant.launches == before
    acc_t = acc_t.numpy()
    assert acc_t.shape == acc_j.shape == (N_TILES, 8, 256)
    assert fidx_t.shape == (N_TILES, 256) and fidx_t.dtype == torch.int32
    if name == "skeleton":
        np.testing.assert_array_equal(acc_t, acc_j)
        return
    if name == "notrans":
        scale = np.abs(acc_j[:, :3]).max()
        assert scale > 1.0  # it does go large
        np.testing.assert_allclose(acc_t[:, :3], acc_j[:, :3], rtol=0,
                                   atol=1e-4 * scale)
    else:
        np.testing.assert_allclose(acc_t[:, :3], acc_j[:, :3], rtol=0,
                                   atol=2e-4)
    np.testing.assert_allclose(acc_t[:, 3], acc_j[:, 3], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(acc_t[:, 4:], 0.0)
    stopped = (fidx_t < raster_variants.STOP_SENTINEL).float().mean()
    if name == "nostop":
        assert float(stopped) == 0.0
    elif not uneven:
        assert float(stopped) > 0.1  # the stop test is exercised


@pytest.mark.parametrize("uneven", [False, True], ids=["even", "uneven"])
def test_real_matches_pallas(jkb, uneven):
    (recs, ts, te), st = _streams(jkb, uneven)
    tb_y = N_TILES // TB_X
    acc_j, fidx_j = R.pallas_rasterize_forward(recs, ts, te, TB_X, tb_y,
                                               interpret=True)
    args = list(tkb.real_args(st))
    args[7] = torch.zeros(3)  # no background: the image is the rgb sum
    img, ft, fidx = raster.rasterize_forward_plain(*args)
    acc_j = np.array(acc_j)
    h, w = args[8], args[9]
    rgb_j = raster.tiles_to_image(torch.from_numpy(acc_j[:, :3]).transpose(1, 2),
                                  TB_X, tb_y, h, w).numpy()
    t_j = raster.tiles_to_image(torch.from_numpy(acc_j[:, 3]), TB_X, tb_y,
                                h, w).numpy()
    np.testing.assert_allclose(img.numpy(), rgb_j, rtol=0, atol=4e-3)
    np.testing.assert_allclose(ft.numpy(), t_j, rtol=0, atol=1e-5)


@pytest.mark.parametrize("uneven", [False, True], ids=["even", "uneven"])
def test_full_matches_real(jkb, uneven):
    _, st = _streams(jkb, uneven)
    acc, fidx_f = raster_variants.rasterize_variant_plain(
        "full", *tkb.variant_args(st))
    args = list(tkb.real_args(st))
    args[7] = torch.zeros(3)  # no background: the image is the rgb sum
    img, final_t, fidx_r = raster.rasterize_forward_plain(*args)
    h, w = args[8], args[9]
    rgb = raster.image_to_tiles(img, st.tb_x, st.tb_y, h, w)
    t_r = raster.image_to_tiles(final_t, st.tb_x, st.tb_y, h, w)
    same = fidx_f == fidx_r
    assert float(same.float().mean()) >= 0.999
    d_rgb = (acc[:, :3].transpose(1, 2) - rgb).abs().amax(-1)
    assert float(torch.where(same, d_rgb, 0.0).max()) <= 2e-4
    d_t = (acc[:, 3] - t_r).abs()
    assert float(torch.where(same, d_t, 0.0).max()) <= 1e-5
    assert float((fidx_f < raster.STOP_SENTINEL).float().mean()) > 0.1


@pytest.mark.parametrize("notrans", [False, True], ids=["exp", "notrans"])
def test_warp_masks_keep_every_reaching_record(notrans):
    xy, con, op = tkb.cull_records(4000, 3)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)
    xys, conics, opac = f32(xy + 7.5), f32(con), f32(op)  # around tile 0
    n = xys.shape[0]
    g = torch.arange(n)[None]
    quad = [v[None, :, None] for v in raster_variants._pixel_quad("cpu")]
    centre = torch.tensor([[7.5]])
    sigma = raster_variants._sigma(g, xys, conics, centre, centre, quad)[0]
    op = opac[None, :]
    if notrans:
        alpha = torch.clamp(op * (1.0 - 0.05 * sigma), max=0.999)
    else:
        alpha = torch.clamp(op * torch.exp(-sigma), max=0.999)
    reach = (alpha >= raster_variants.ALPHA_THRESH).reshape(8, 32, n).any(1)
    masks = raster_variants.warp_masks(
        xys[:, 0] - 7.5, xys[:, 1] - 7.5, conics[:, 0], conics[:, 1],
        conics[:, 2], opac, notrans=notrans)
    kept = ((masks[None, :] >> torch.arange(8)[:, None]) & 1).bool()
    assert int(reach.sum()) > 1000  # records do reach the tile
    assert not bool((reach & ~kept).any())
    assert float(kept.float().mean()) < 0.5  # and the cull drops many
    # the conics it cannot bound (here B^2 > A C) reach every warp
    no_ellipse = (conics[:, 1] ** 2 > conics[:, 0] * conics[:, 2]) & (
        opac >= raster_variants.ALPHA_THRESH)
    assert int(no_ellipse.sum()) > 100
    assert bool((masks[no_ellipse] == 0xFF).all())


def test_warp_steps_on_small_stream():
    st = tkb.make_stream(8, 600, 4, device="cpu")
    args = tkb.variant_args(st)
    _, fidx = raster_variants.rasterize_variant_plain("full", *args)
    steps = raster_variants.warp_steps(
        st.tile_start, st.tile_end, st.xys, st.conics, st.opac, st.tb_x, fidx)
    # each warp runs to its last stop: no fewer steps than its tile's
    # longest pixel replay, summed over the tile's eight warps
    per_pixel = raster._pixel_replay(st.tile_start, st.tile_end, fidx)
    assert steps["replay"] >= int(per_pixel.amax(1).sum())
    assert 0 < steps["used"] <= steps["listed"] <= steps["replay"]
    assert steps["alpha"] % raster_variants.ALPHA_BLOCK == 0
    assert steps["used"] <= steps["alpha"]


def test_sass_report_counts_loops():
    listing = """
                Function : _Z6kernelPf
        /*0000*/                   LDC R1, c[0x0][0x28] ;
                                                          /* 0x000fe200 */
.L_x_1:
        /*0010*/                   FMUL R0, R1, R2 ;
        /*0020*/                   MUFU.EX2 R0, R0 ;
        /*0030*/                   NOP ;
        /*0040*/               @P0 BRA `(.L_x_1) ;
        /*0050*/                   EXIT ;
"""
    funcs = sass_report.parse(listing)
    info = sass_report.summary(funcs["_Z6kernelPf"])
    assert info["instructions"] == 5  # the NOP left out
    assert info["classes"] == {"FMUL": 1, "MUFU": 1, "BRA": 1}
    assert info["loops"] == [dict(start="0x10", end="0x40", instructions=3,
                                  mufu=1)]


def test_replay_counts():
    """The bounds' work counts: per tile its longest pixel replay, and
    per pixel its own, a pixel that never stopped replaying its tile."""
    ts = torch.tensor([0, 10, 30], dtype=torch.int32)
    te = torch.tensor([10, 30, 30], dtype=torch.int32)
    fidx = torch.full((3, 256), raster.STOP_SENTINEL, dtype=torch.int32)
    fidx[0, 0] = 3  # tile 0: one pixel stops after 3, the rest never
    fidx[1] = 15  # tile 1: every pixel after 5 records but one after 2
    fidx[1, 7] = 12
    assert raster.records_replayed(ts, te, fidx) == 10 + 5 + 0
    assert raster.pairs_replayed(ts, te, fidx) == (3 + 255 * 10) + (
        2 + 255 * 5)


def test_bench_entry_point_on_cpu(capsys):
    times = tkb.main(["--cpu", "--tiles", "2", "--per-tile", "60",
                      "--tb-x", "2", "--iters", "1"])
    assert set(times) == set(tkb.BENCH_NAMES)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == len(tkb.BENCH_NAMES)
    assert all("ms/call" in ln and "cpu" in ln for ln in lines)


def test_unknown_variant_raises():
    st = tkb.make_stream(2, 10, 2, device="cpu")
    with pytest.raises(ValueError, match="unknown variant"):
        raster_variants.rasterize_variant("fast", *tkb.variant_args(st))
