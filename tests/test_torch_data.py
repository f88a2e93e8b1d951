"""opensplat_tpu_torch's data layer against the JAX package on the CPU:
every project loader on the project builders of test_data_loaders.py,
the point-cloud readers and writers, the native points3D.bin parser
against its numpy path, the PNG reader and the area resize against
OpenCV (which the JAX package uses), image loading with downscaling and
undistortion, and cameras.json. Host-side numpy on both sides, so most
comparisons are exact; the area resize sums in float64 where OpenCV
uses float32 (uint8 within 1, float32 within 1e-6)."""
import json
import os
import struct
import sys
import zlib

import cv2
import numpy as np
import pytest
import torch

from opensplat_tpu.data import dataset as jds
from opensplat_tpu.data import point_io as jpio
from opensplat_tpu_torch.data import _image
from opensplat_tpu_torch.data import dataset as tds
from opensplat_tpu_torch.data import point_io as tpio
from opensplat_tpu_torch.native import loader as tnative
from test_data_loaders import (_write_cameras_bin, _write_images_bin,
                               _write_las, _write_ply, _write_points3d_bin)

# one intra-op thread per process: the suite runs one pytest-xdist
# worker per core, and a full torch thread pool in each of them
# oversubscribes the cores
torch.set_num_threads(1)


# ---------------------------------------------------------------- projects
# the projects of tests/test_data_loaders.py, one builder per loader

def _colmap(root):
    sparse = root / "sparse" / "0"
    sparse.mkdir(parents=True)
    _write_cameras_bin(str(sparse / "cameras.bin"))
    q1 = np.array([1.0, 0.0, 0.0, 0.0])
    q2 = np.array([np.cos(np.pi / 8), 0.0, np.sin(np.pi / 8), 0.0])
    _write_images_bin(
        str(sparse / "images.bin"),
        [(q1, np.array([0.5, -0.2, 2.0]), 1, "img_001.png"),
         (q2, np.array([-1.0, 0.3, 1.5]), 2, "img_002.png")],
    )
    rng = np.random.default_rng(2)
    _write_points3d_bin(str(sparse / "points3D.bin"),
                        rng.standard_normal((20, 3)),
                        rng.integers(0, 255, (20, 3)), [0] * 20)
    return root


def _nerfstudio(root):
    pts = np.array([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.5, -0.5, 2.0]],
                   np.float32)
    cols = np.array([[255, 0, 0], [0, 255, 0], [0, 0, 255]], np.uint8)
    _write_ply(str(root / "sparse.ply"), pts, cols)
    m2 = np.eye(4)
    m2[:3, 3] = [2.0, 0.0, 1.0]
    transforms = {
        "camera_model": "OPENCV",
        "w": 100, "h": 80, "fl_x": 90.0, "fl_y": 91.0, "cx": 50.0,
        "cy": 40.0, "k1": 0.01, "ply_file_path": "sparse.ply",
        "frames": [
            {"file_path": "images/b.png", "transform_matrix": m2.tolist(),
             "fl_x": 95.0},
            {"file_path": "images/a.png",
             "transform_matrix": np.eye(4).tolist()},
        ],
    }
    (root / "transforms.json").write_text(json.dumps(transforms))
    return root


def _opensfm(root):
    rec = [{
        "cameras": {"cam0": {"projection_type": "perspective",
                             "width": 200, "height": 100, "focal": 0.8,
                             "k1": -0.05, "k2": 0.01}},
        "shots": {
            "shot_a.jpg": {"camera": "cam0", "rotation": [0.0, 0.0, 0.0],
                           "translation": [0.0, 0.0, 4.0]},
            "shot_b.jpg": {"camera": "cam0", "rotation": [0.0, 0.3, 0.0],
                           "translation": [1.0, 0.0, 3.0]},
        },
        "points": {
            "1": {"coordinates": [0.0, 1.0, 2.0], "color": [255, 128, 0]},
            "2": {"coordinates": [1.0, -1.0, 3.0], "color": [0, 128, 255]},
        },
    }]
    (root / "reconstruction.json").write_text(json.dumps(rec))
    (root / "image_list.txt").write_text(
        "images/shot_a.jpg\nimages/shot_b.jpg\n")
    return root


def _odm(root):
    (root / "opensfm").mkdir()
    _opensfm(root / "opensfm")
    return root


def _openmvg(root):
    _write_ply(str(root / "colorized.ply"),
               np.array([[0.0, 0.0, 1.0], [1.0, 2.0, 3.0]], np.float32),
               np.array([[9, 8, 7], [1, 2, 3]], np.uint8))
    intr = {"polymorphic_name": "pinhole_brown_t2", "ptr_wrapper": {"data": {
        "width": 400, "height": 300, "focal_length": 350.0,
        "principal_point": [200.0, 150.0],
        "disto_t2": [0.1, 0.01, 0.001, 0.0001, 0.00001]}}}

    def view(i):
        return {"key": i, "value": {"ptr_wrapper": {"data": {
            "filename": f"v{i}.jpg", "width": 400, "height": 300,
            "id_view": i, "id_intrinsic": 0, "id_pose": i}}}}

    sfm = {
        "root_path": "/data/images",
        "intrinsics": [{"key": 0, "value": intr}],
        "views": [view(0), view(1)],
        "extrinsics": [
            {"key": 0, "value": {"rotation": np.eye(3).tolist(),
                                 "center": [0.0, 0.0, 5.0]}},
            {"key": 1, "value": {"rotation": np.eye(3).tolist(),
                                 "center": [2.0, 1.0, 4.0]}},
        ],
    }
    (root / "sfm_data.json").write_text(json.dumps(sfm))
    return root


_CAMERA_FIELDS = ("width", "height", "fx", "fy", "cx", "cy", "k1", "k2",
                  "k3", "p1", "p2", "file_path", "cam_id")


def _assert_same_input_data(t, j):
    assert len(t.cameras) == len(j.cameras)
    for tc, jc in zip(t.cameras, j.cameras):
        for f in _CAMERA_FIELDS:
            assert getattr(tc, f) == getattr(jc, f), f
        np.testing.assert_array_equal(tc.cam_to_world, jc.cam_to_world)
        assert tc.cam_to_world.dtype == jc.cam_to_world.dtype
    assert t.scale == j.scale
    np.testing.assert_array_equal(t.translation, j.translation)
    for name in ("points_xyz", "points_rgb"):
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("build", [_colmap, _nerfstudio, _opensfm, _odm,
                                   _openmvg])
def test_loaders_match_jax(build, tmp_path):
    root = str(build(tmp_path))
    _assert_same_input_data(tds.input_data_from_x(root),
                            jds.input_data_from_x(root))


def test_dispatch_error(tmp_path):
    with pytest.raises(RuntimeError, match="Invalid project folder"):
        tds.input_data_from_x(str(tmp_path))


@pytest.mark.parametrize("keep_crs", [False, True])
def test_cameras_json_byte_identical(keep_crs, tmp_path):
    root = str(_colmap(tmp_path / "proj"))
    t_path, j_path = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    tds.input_data_from_x(root).save_cameras(t_path, keep_crs)
    jds.input_data_from_x(root).save_cameras(j_path, keep_crs)
    assert open(t_path, "rb").read() == open(j_path, "rb").read()


# ------------------------------------------------------------ point clouds

def _cloud_files(tmp_path):
    rng = np.random.default_rng(0)
    pts = rng.standard_normal((17, 3)).astype(np.float32)
    cols = rng.integers(0, 255, (17, 3)).astype(np.uint8)
    _write_ply(str(tmp_path / "bin.ply"), pts, cols, extra_alpha=True)
    _write_ply(str(tmp_path / "ascii.ply"), pts, cols, ascii_fmt=True)
    _write_las(str(tmp_path / "f7.las"), pts.astype(np.float64) * 30, cols,
               fmt=7, version=(1, 4))
    _write_points3d_bin(str(tmp_path / "points3D.bin"), pts, cols,
                        [0, 3, 1, 7, 2, 0, 5, 1, 4] * 2)
    return ("bin.ply", "ascii.ply", "f7.las", "points3D.bin")


def test_point_readers_match_jax(tmp_path):
    for name in _cloud_files(tmp_path):
        a = tpio.read_point_set(str(tmp_path / name))
        b = jpio.read_point_set(str(tmp_path / name))
        for f in ("points", "colors", "normals", "views"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), (name, f)
            if x is not None:
                np.testing.assert_array_equal(x, y, err_msg=f"{name} {f}")


@pytest.mark.parametrize("ext", [".ply", ".las"])
def test_point_writers_byte_identical(ext, tmp_path):
    rng = np.random.default_rng(3)
    pts = rng.uniform(-80, 80, (300, 3)).astype(np.float32)
    rgb = rng.integers(0, 256, (300, 3)).astype(np.uint8)
    extra = dict(normals=pts * 0.5) if ext == ".ply" else {}
    t_path, j_path = str(tmp_path / f"t{ext}"), str(tmp_path / f"j{ext}")
    tpio.save_point_set(tpio.PointSet(points=pts, colors=rgb, **extra), t_path)
    jpio.save_point_set(jpio.PointSet(points=pts, colors=rgb, **extra), j_path)
    assert open(t_path, "rb").read() == open(j_path, "rb").read()


def _points3d(tmp_path, n=500, seed=5):
    rng = np.random.default_rng(seed)
    p = str(tmp_path / "points3D.bin")
    _write_points3d_bin(p, rng.standard_normal((n, 3)),
                        rng.integers(0, 255, (n, 3)),
                        rng.integers(0, 9, n).tolist())
    return p


def test_native_points3d_equals_numpy(tmp_path, monkeypatch):
    assert tnative.get_lib() is not None, "g++ could not build point_io.cpp"
    lib = tnative.lib_path()
    assert lib.parent.parent.name == "_build", lib  # never the source tree
    p = _points3d(tmp_path)
    native = tpio.read_colmap_points3d(p)
    jax_side = jpio.read_colmap_points3d(p)
    monkeypatch.setattr(tpio, "_native_colmap_points3d", lambda buf: None)
    numpy_side = tpio.read_colmap_points3d(p)
    for r in (numpy_side, jax_side):
        np.testing.assert_array_equal(native.points, r.points)
        np.testing.assert_array_equal(native.colors, r.colors)


def test_native_points3d_rejects_truncated(tmp_path):
    p = _points3d(tmp_path, n=10, seed=1)
    raw = open(p, "rb").read()
    open(p, "wb").write(raw[:-20])  # truncate mid-record
    with pytest.raises(RuntimeError, match="Malformed"):
        tpio.read_colmap_points3d(p)


# ------------------------------------------------------------------ images

def _filter_rows(img, ftypes):
    """Raw PNG scanlines of img (H, W, C) uint8 with each row's filter."""
    h, w, bpp = img.shape
    rows = img.reshape(h, w * bpp).astype(np.int32)
    out = np.zeros((h, 1 + w * bpp), np.uint8)
    prev = np.zeros(w * bpp, np.int32)
    for r, f in enumerate(ftypes):
        x = rows[r]
        a = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        p = a + prev - c
        pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, prev, c))
        pred = [0, a, prev, (a + prev) >> 1, paeth][f]
        out[r, 0] = f
        out[r, 1:] = (x - pred) & 255
        prev = x
    return out


def _png_bytes(img, ctype, ftypes, palette=None):
    h, w = img.shape[:2]

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    data = _image.PNG_SIGNATURE + chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
    if palette is not None:
        data += chunk(b"PLTE", palette.tobytes())
    rows = _filter_rows(img, ftypes)
    return (data + chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + chunk(b"IEND", b""))


# colour type -> samples a pixel: gray, RGB, palette, gray+alpha, RGBA
@pytest.mark.parametrize("ctype,bpp", [(0, 1), (2, 3), (3, 1), (4, 2),
                                       (6, 4)])
def test_png_reader_equals_cv2(ctype, bpp, tmp_path):
    """Every colour type, with all five filter types among the rows (the
    anti-diagonal path) and with None/Sub/Up only (the row path)."""
    rng = np.random.default_rng(ctype)
    h, w = 37, 53
    palette = rng.integers(0, 256, (20, 3)).astype(np.uint8) \
        if ctype == 3 else None
    for ftypes in (np.arange(h) % 5, rng.integers(0, 3, h)):
        img = rng.integers(0, 20 if ctype == 3 else 256,
                           (h, w, bpp)).astype(np.uint8)
        p = str(tmp_path / f"f{ftypes.max()}.png")
        with open(p, "wb") as f:
            f.write(_png_bytes(img, ctype, ftypes, palette))
        ref = cv2.cvtColor(cv2.imread(p, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
        np.testing.assert_array_equal(_image.imread_rgb(p), ref)


def test_png_writer_and_cv2_files(tmp_path):
    """cv2 reads what the port writes, and the port reads what cv2
    writes (libpng's adaptive filters), both exactly."""
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (64, 80, 3)).astype(np.uint8)
    img[20:40] = 60  # flat rows: libpng picks other filters there
    ours, theirs = str(tmp_path / "ours.png"), str(tmp_path / "cv2.png")
    _image.write_png(ours, img)
    cv2.imwrite(theirs, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    np.testing.assert_array_equal(
        cv2.cvtColor(cv2.imread(ours), cv2.COLOR_BGR2RGB), img)
    np.testing.assert_array_equal(_image.imread_rgb(theirs), img)


@pytest.mark.parametrize("hw", [(250, 250), (255, 255), (37, 53)])
def test_area_resize_equals_cv2(hw):
    """get_image's form (dsize; 255 -> 127 is not a whole factor) on
    float32 images and load_image's (fx = fy = 1/factor, round(w/f)
    wide) on uint8, at factors 2-4 and 1.5."""
    h, w = hw
    rng = np.random.default_rng(h + w)
    u8 = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    f32 = u8.astype(np.float32) / 255.0
    for f in (2, 3, 4):
        ref = cv2.resize(f32, (w // f, h // f), interpolation=cv2.INTER_AREA)
        got = _image.resize_area(f32, (w // f, h // f))
        assert got.dtype == np.float32 and got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    for f in (2, 3, 4, 1.5):
        ref = cv2.resize(u8, (0, 0), fx=1 / f, fy=1 / f,
                         interpolation=cv2.INTER_AREA)
        got = _image.resize_area(u8, factor=1 / f)
        assert got.dtype == np.uint8 and got.shape == ref.shape
        assert np.abs(got.astype(int) - ref).max() <= 1


def _camera_pair(path, **kw):
    args = dict(width=160, height=120, fx=150.0, fy=150.0, cx=80.0, cy=60.0,
                file_path=path, **kw)
    return tds.Camera(**args), jds.Camera(**args)


@pytest.mark.parametrize("factor,dist", [(1.0, {}), (2.0, {}),
                                         (1.0, dict(k1=-0.2, k2=0.05))])
def test_load_image_matches_jax(factor, dist, tmp_path):
    """Declared 160x120, stored 2x as large (intrinsics rescale), then the
    downscale (within 1 of 255 before /255) or undistortion (exact: both
    use cv2 for it); then the pyramid level 2 (get_image)."""
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (240, 320, 3)).astype(np.uint8)
    p = str(tmp_path / "img.png")
    cv2.imwrite(p, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    t, j = _camera_pair(p, **dist)
    t.load_image(factor)
    j.load_image(factor)
    assert (t.width, t.height) == (j.width, j.height)
    for f in ("fx", "fy", "cx", "cy"):
        assert getattr(t, f) == getattr(j, f), f
    atol = 1.0 / 255.0 + 1e-7 if factor > 1 else 0.0
    np.testing.assert_allclose(t.image, j.image, rtol=0, atol=atol)
    np.testing.assert_allclose(t.get_image(2), j.get_image(2), rtol=0,
                               atol=atol + 1e-6)
    with pytest.raises(RuntimeError, match="already called"):
        t.load_image()


def test_cv2_missing_names_file_and_cv2(tmp_path, monkeypatch):
    """Without cv2, PNG images load and JPEG or undistortion raise an
    error naming the file and cv2 — never a distorted image."""
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (24, 32, 3)).astype(np.uint8)
    png, jpg = str(tmp_path / "a.png"), str(tmp_path / "b.jpg")
    _image.write_png(png, img)
    cv2.imwrite(jpg, img)
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 fails
    cam = tds.Camera(width=32, height=24, fx=30.0, fy=30.0, cx=16.0,
                     cy=12.0, file_path=png)
    cam.load_image()
    np.testing.assert_array_equal(cam.image, img.astype(np.float32) / 255.0)
    for path, kw in ((jpg, {}), (png, dict(k1=-0.1))):
        cam = tds.Camera(width=32, height=24, fx=30.0, fy=30.0, cx=16.0,
                         cy=12.0, file_path=path, **kw)
        with pytest.raises(RuntimeError, match="cv2") as e:
            cam.load_image()
        assert path in str(e.value)
        assert cam.image is None


def test_pose_helpers_and_sh_to_rgb_match_jax():
    """The loaders' pose helpers and sh_to_rgb, on the port's numpy
    copies and on tensors, equal the JAX package's."""
    import jax.numpy as jnp

    from opensplat_tpu.ops import sh as jsh
    from opensplat_tpu.ops import tensor_math as jtm
    from opensplat_tpu_torch.ops import sh as tsh
    from opensplat_tpu_torch.ops import tensor_math as ttm

    rng = np.random.default_rng(11)
    poses = np.tile(np.eye(4, dtype=np.float32), (5, 1, 1))
    poses[:, :3, 3] = rng.uniform(-3, 3, (5, 3))
    for a, b in zip(ttm.auto_scale_and_center_poses(poses),
                    jtm.auto_scale_and_center_poses(poses)):
        np.testing.assert_array_equal(a, b)
    for r in (rng.normal(size=3), np.zeros(3), [0.0, np.pi, 0.0]):
        np.testing.assert_array_equal(ttm.rodrigues_to_rotation(r),
                                      jtm.rodrigues_to_rotation(r))
    for a, b in ((rng.normal(size=3), rng.normal(size=3)),
                 ([0.0, 0.0, 1.0], [0.0, 0.0, -1.0]),  # anti-parallel
                 ([1.0, 0.0, 0.0], [-1.0, 0.0, 0.0])):
        got = ttm.rotation_matrix(a, b)
        np.testing.assert_array_equal(got, jtm.rotation_matrix(a, b))
        np.testing.assert_allclose(
            got @ (np.asarray(a) / np.linalg.norm(a)),
            np.asarray(b) / np.linalg.norm(b), atol=1e-6)
    sh = rng.normal(0, 2, (50, 3)).astype(np.float32)
    ref = np.asarray(jsh.sh_to_rgb(jnp.asarray(sh)))
    np.testing.assert_allclose(tsh.sh_to_rgb(torch.from_numpy(sh)).numpy(),
                               ref, rtol=0, atol=1e-7)
    np.testing.assert_allclose(tsh.sh_to_rgb(sh), ref, rtol=0, atol=1e-7)


def test_png_bench_times_each_path():
    """tools/png_bench decodes each file it writes back to its image (it
    raises otherwise) and times the row path only where no row uses
    Average or Paeth."""
    from opensplat_tpu_torch.tools import png_bench

    recs = png_bench.bench(16, 24, reps=1)
    by_file = {r["file"].split()[0]: r for r in recs}
    assert set(by_file["filter"]["filters"]) == {0}
    assert "unfilter_rows_ms" in by_file["filter"]
    assert set(by_file["adaptive"]["filters"]) & {3, 4}
    assert "unfilter_rows_ms" not in by_file["adaptive"]
    assert all(r["decode_png_ms"] > 0 and r["unfilter_wavefront_ms"] > 0
               for r in recs)
