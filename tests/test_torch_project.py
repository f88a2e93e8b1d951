"""The EWA projection kernel pair (opensplat_tpu_torch/ops/kernels/
project.py, csrc/project.cu) and its selection in ops/projection.py.

On the CPU: project_gaussians takes the plain version and counts
project.calls, never project.fused; the per-row math of the kernels
(csrc/project_row.cuh, which includes nothing of CUDA), built for the
host with g++, against the plain version's outputs and against its
autograd for every combination of output gradients, on a random camera
with rows planted in the clip slab, behind the camera, past both FOV
limits and as degenerate lines whose 2D determinant rounds to 0; and the
wrapper's argument packing: per-view scalars rounded as the plain
version's per-view columns, row and view strides of sliced inputs and
gradients, absent gradients as null pointers, a batch wider than a
launch split into launches. Tests marked `cuda` hold the kernels to the
plain version on the card and skip without one (on the chip: python3 -m
pytest --noconftest tests/test_torch_project.py -m cuda). This file
imports no JAX."""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from opensplat_tpu_torch.ops import projection as tproj
from opensplat_tpu_torch.ops.camera import camera_matrices
from opensplat_tpu_torch.ops.kernels import _lib
from opensplat_tpu_torch.ops.kernels import project as kproject
from opensplat_tpu_torch.utils.metrics import counts

# one intra-op thread per process: the suite runs one pytest-xdist
# worker per core
torch.set_num_threads(1)

N = 256  # a multiple of 64: the CPU's vector tails fall alike
H, W = 48, 64
PLANTED = 6  # rows 0-5: clip slab (2), behind, past the FOV limits (3)
DEGENERATE = slice(PLANTED, PLANTED + 10)  # lines: det may round to 0
FIELDS = ("u", "v", "z", "cam_z", "conic0", "conic1", "conic2", "a", "b",
          "c")
INT_FIELDS = ("radii", "num_tiles_hit", "tmin_x", "tmin_y", "tmax_x",
              "tmax_y", "mask", "front")
GRAD_SETS = {
    "training": ("xys", "conics"),
    "all": ("xys", "depths", "cam_depths", "conics", "cov2d"),
    "depths": ("depths",),
    "cov2d": ("cov2d",),
    "centres": ("xys", "cam_depths"),
}

_SHIM = r"""
#include "project_row.cuh"
using namespace osk_project;
extern "C" void host_fwd(int n, const float* m, const float* s,
                         const float* q, const float* V, const float* P,
                         const float* vw, const float* fr, int tb_x,
                         int tb_y, const float* opac,
                         const unsigned char* valid, float* fo, int* io) {
  const ViewScalars view{vw[0], vw[1], vw[2], vw[3], vw[4], vw[5]};
  const Frame f{fr[0], fr[1], fr[2], fr[3], fr[4], fr[5], tb_x, tb_y};
  for (int i = 0; i < n; ++i) {
    RowOut o;
    project_row(m + 3 * i, s + 3 * i, q + 4 * i, V, P, view, f,
                opac != nullptr, opac ? opac[i] : 0.0f,
                valid ? valid[i] != 0 : true, o);
    float* a = fo + 10 * i;
    a[0] = o.u; a[1] = o.v; a[2] = o.z; a[3] = o.cam_z;
    for (int k = 0; k < 3; ++k) { a[4 + k] = o.conic[k]; a[7 + k] = o.cov[k]; }
    int* b = io + 8 * i;
    b[0] = o.radius; b[1] = o.tiles; b[2] = o.tmin_x; b[3] = o.tmin_y;
    b[4] = o.tmax_x; b[5] = o.tmax_y; b[6] = o.mask; b[7] = o.front;
  }
}
extern "C" void host_vjp(int n, const float* m, const float* s,
                         const float* q, const float* V, const float* P,
                         const float* vw, const float* fr, const float* g,
                         const int* has, float* out) {
  const ViewScalars view{vw[0], vw[1], vw[2], vw[3], vw[4], vw[5]};
  const Frame f{fr[0], fr[1], fr[2], fr[3], fr[4], fr[5], 0, 0};
  for (int i = 0; i < n; ++i) {
    const float* x = g + 11 * i;
    RowGrad r;
    r.xy[0] = x[0]; r.xy[1] = x[1]; r.z = x[2]; r.cam_z = x[3];
    for (int k = 0; k < 3; ++k) { r.conic[k] = x[4 + k]; r.cov[k] = x[7 + k]; }
    r.has_xy = has[0]; r.has_z = has[1]; r.has_cam_z = has[2];
    r.has_conic = has[3]; r.has_cov = has[4];
    float* o = out + 10 * i;
    project_row_vjp(m + 3 * i, s + 3 * i, q + 4 * i, V, P, view, f, r, o,
                    o + 3, o + 6);
  }
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The kernels' row math built for the host: each float op rounded on
    its own (no contraction into FMAs), as nvcc's --fmad=false builds
    it."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the row math for the host")
    d = tmp_path_factory.mktemp("project_row")
    (d / "shim.cpp").write_text(_SHIM)
    lib = d / "libproject_row.so"
    subprocess.run(["g++", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
                    "-I", str(_lib.CSRC), str(d / "shim.cpp"), "-o",
                    str(lib)], check=True, capture_output=True, timeout=120)
    return ctypes.CDLL(str(lib))


def _scene(seed, h=H, w=W):
    """N Gaussians in front of a random camera pose (camera depths 2-9),
    rows 0-5 planted in the clip slab (depths 0.004, -0.003), behind it
    and past the FOV limits, rows 6-15 lines of 1e4 x 1e-3 x 1e-3 whose
    2D determinant can round to 0, every 7th quaternion unnormalised."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    qw, qx, qy, qz = q
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = [
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz),
         2 * (qx * qz + qw * qy)],
        [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz),
         2 * (qy * qz - qw * qx)],
        [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx),
         1 - 2 * (qx * qx + qy * qy)]]
    c2w[:3, 3] = rng.uniform(-2, 2, 3)
    fx, fy = 70.0 + seed, 75.5
    viewmat, projmat, _ = camera_matrices(torch.from_numpy(c2w), fx, fy, w,
                                          h)
    cam = np.concatenate([rng.uniform(-1.5, 1.5, (N, 2)),
                          rng.uniform(2, 9, (N, 1))], -1)
    cam[:PLANTED] = [[0.3, -0.2, 0.004], [0.3, -0.2, -0.003],
                     [0.1, 0.2, -3.0], [9.0, 0.1, 2.0], [-9.0, -8.0, 2.0],
                     [0.2, 12.0, 3.0]]
    inv = np.linalg.inv(viewmat.numpy().astype(np.float64))
    means = (cam @ inv[:3, :3].T + inv[:3, 3]).astype(np.float32)
    scales = np.exp(rng.uniform(-2.5, -0.5, (N, 3))).astype(np.float32)
    scales[DEGENERATE] = [1e4, 1e-3, 1e-3]
    quats = rng.normal(size=(N, 4)).astype(np.float32)
    quats[::7] *= 3.0
    return dict(
        means=means, scales=scales, quats=quats,
        opac=(1 / (1 + np.exp(-rng.normal(0, 1.5, N)))).astype(np.float32),
        valid=rng.uniform(size=N) > 0.1, viewmat=viewmat, projmat=projmat,
        fx=fx, fy=fy, cx=w / 2 + 0.25, cy=h / 2 - 0.5, h=h, w=w)


CASES = {
    "opac_valid": dict(opac=True, valid=True),
    "bare": dict(opac=False, valid=False),
    "opac": dict(opac=True, valid=False),
    "band": dict(opac=True, valid=True, fov_height=96, row_offset=32),
}


def _plain(s, case, leaves=None):
    c = CASES[case]
    leaves = leaves or [torch.from_numpy(s[k]) for k in
                        ("means", "scales", "quats")]
    return tproj.project_gaussians(
        leaves[0], leaves[1], 1.0, leaves[2], s["viewmat"], s["projmat"],
        s["fx"], s["fy"], s["cx"], s["cy"], s["h"], s["w"],
        valid_mask=torch.from_numpy(s["valid"]) if c["valid"] else None,
        opacities=torch.from_numpy(s["opac"]) if c["opac"] else None,
        fov_height=c.get("fov_height"), row_offset=c.get("row_offset"))


def _setup(s, case):
    c = CASES[case]
    return kproject.setup(1, N, 1.0, [s["fx"]], [s["fy"]], [s["cx"]],
                          [s["cy"]], s["h"], s["w"], 0.01, 1.0 / 255.0, None,
                          c.get("fov_height"), c.get("row_offset"))


def _ptr(a):
    return None if a is None else a.ctypes.data_as(ctypes.c_void_p)


def _mats(s):
    return (np.ascontiguousarray(s["viewmat"].numpy(), np.float32),
            np.ascontiguousarray(s["projmat"].numpy(), np.float32))


def _host_forward(lib, s, case):
    c, st = CASES[case], _setup(s, case)
    vm, pm = _mats(s)
    fo = np.zeros((N, 10), np.float32)
    io = np.zeros((N, 8), np.int32)
    lib.host_fwd(N, _ptr(s["means"]), _ptr(s["scales"]), _ptr(s["quats"]),
                 _ptr(vm), _ptr(pm),
                 _ptr(np.array(st.view_floats[0], np.float32)),
                 _ptr(np.array(st.floats, np.float32)), st.tb_x, st.tb_y,
                 _ptr(s["opac"]) if c["opac"] else None,
                 _ptr(s["valid"].astype(np.uint8)) if c["valid"] else None,
                 _ptr(fo), _ptr(io))
    return fo, io


def _close(a, b, rtol, atol_frac, label):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    scale = max(np.abs(b).max(), 1.0)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol_frac * scale,
                               err_msg=label)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_row_math_matches_plain_version(host_lib, seed, case):
    s = _scene(seed)
    p = _plain(s, case)
    fo, io = _host_forward(host_lib, s, case)
    plain_f = torch.cat([p.xys, p.depths[:, None], p.cam_depths[:, None],
                         p.conics, p.cov2d], 1).numpy()
    plain_i = torch.cat([p.radii[:, None], p.num_tiles_hit[:, None],
                         p.tile_min, p.tile_max, p.mask[:, None],
                         (p.depths > 0.01)[:, None]], 1).numpy()
    regular = np.ones(N, bool)
    regular[DEGENERATE] = False
    for j, name in enumerate(FIELDS):
        _close(fo[regular, j], plain_f[regular, j], 1e-5, 1e-5, name)
    for j, name in enumerate(INT_FIELDS):
        np.testing.assert_array_equal(io[regular, j], plain_i[regular, j],
                                      err_msg=name)
    # the planted rows: culled in the slab and behind, finite everywhere
    assert not io[:3, 6].any() and not io[:3, 7].any()
    assert np.isfinite(fo).all()
    # a line whose determinant is 0 in both takes det = 1 and is culled
    det_plain = plain_f[:, 7] * plain_f[:, 9] - plain_f[:, 8] ** 2
    det_host = fo[:, 7] * fo[:, 9] - fo[:, 8] ** 2
    both = (det_plain == 0) & (det_host == 0)
    assert both.any()
    assert not io[both, 6].any() and not plain_i[both, 6].any()
    np.testing.assert_array_equal(fo[both, 4:7], fo[both][:, [9, 8, 7]]
                                  * np.array([1, -1, 1], np.float32))


@pytest.mark.parametrize("grads", list(GRAD_SETS))
@pytest.mark.parametrize("case", ["opac_valid", "band"])
def test_row_vjp_matches_autograd(host_lib, case, grads):
    """The hand-derived backward against autograd through the plain
    version, rtol 1e-4 and 1e-6 of the largest entry, on every row but
    the degenerate lines (ill-conditioned: their determinant cancels)."""
    s = _scene(3)
    leaves = [torch.tensor(s[k], requires_grad=True)
              for k in ("means", "scales", "quats")]
    p = _plain(s, case, leaves)
    rng = np.random.default_rng(4)
    g = rng.normal(size=(N, 11)).astype(np.float32)
    cols = {"xys": g[:, 0:2], "depths": g[:, 2], "cam_depths": g[:, 3],
            "conics": g[:, 4:7], "cov2d": g[:, 7:10]}
    names = GRAD_SETS[grads]
    got = torch.autograd.grad([getattr(p, k) for k in names], leaves,
                              [torch.from_numpy(cols[k]) for k in names],
                              allow_unused=True)
    want = np.concatenate([(torch.zeros_like(x) if a is None else a).numpy()
                           for a, x in zip(got, leaves)], 1)
    st = _setup(s, case)
    vm, pm = _mats(s)
    has = np.array([k in names for k in kproject.GRADS], np.int32)
    out = np.zeros((N, 10), np.float32)
    host_lib.host_vjp(N, _ptr(s["means"]), _ptr(s["scales"]),
                      _ptr(s["quats"]), _ptr(vm), _ptr(pm),
                      _ptr(np.array(st.view_floats[0], np.float32)),
                      _ptr(np.array(st.floats, np.float32)), _ptr(g),
                      _ptr(has), _ptr(out))
    regular = np.ones(N, bool)
    regular[DEGENERATE] = False
    for name, cols_ in (("means", slice(0, 3)), ("scales", slice(3, 6)),
                        ("quats", slice(6, 10))):
        a, b = out[regular, cols_], want[regular, cols_]
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-6 * float(np.abs(b).max()),
                                   err_msg=name)
    # rows in the clip slab and behind the camera get gradient from the
    # outputs like any other row (the rasterizer culls them, not this)
    assert np.isfinite(out).all()


def test_cpu_takes_the_plain_version():
    s = _scene(5)
    before, launches = counts(), kproject.run_forward.launches
    p = _plain(s, "opac_valid")
    after = counts()
    assert after.get("project.calls", 0) - before.get("project.calls", 0) == 1
    assert after.get("project.fused", 0) == before.get("project.fused", 0)
    assert after.get("project.rows", 0) - before.get("project.rows", 0) == N
    assert kproject.run_forward.launches == launches
    front = tproj.take_in_front(p.depths)
    assert torch.equal(front, p.depths[None] > 0.01)


def test_kernel_wrapper_refuses_cpu_tensors():
    s = _scene(6)
    with pytest.raises(ValueError, match="CUDA"):
        kproject.project(
            torch.from_numpy(s["means"])[None],
            torch.from_numpy(s["scales"])[None], 1.0,
            torch.from_numpy(s["quats"])[None], s["viewmat"][None],
            s["projmat"][None], [s["fx"]], [s["fy"]], [s["cx"]], [s["cy"]],
            H, W, 0.01, None, None, 1.0 / 255.0, None, None, None)


@pytest.mark.parametrize("fov", [None, (200, 150)])
def test_view_scalars_round_as_the_plain_columns(fov):
    """Each view's fx, fy, cx, cy and FOV limits are the float32 values of
    the plain version's per-view columns (`_view_col`), from Python
    floats, numpy float64 and float32 alike."""
    fx = [71.3, np.float64(512.123456789), np.float32(33.3)]
    fy = [70.1, 90.7, np.float32(40.03)]
    cx, cy = [32.1, 40.0, 17.77], [24.4, 31.0, np.float64(9.99)]
    fov_w, fov_h = fov or (None, None)
    st = kproject.setup(3, 5, 0.8, fx, fy, cx, cy, 48, 64, 0.01, 1.0 / 255.0,
                        fov_w, fov_h, None)
    wf, hf = fov_w or 64, fov_h or 48
    cols = [tproj._view_col(v, "cpu")[:, 0].tolist() for v in (
        fx, fy, cx, cy, (1.3 * (0.5 * wf / f) for f in fx),
        (1.3 * (0.5 * hf / f) for f in fy))]
    assert [list(v) for v in st.view_floats] == [list(c) for c in
                                                 zip(*cols)]
    assert st.floats[:5] == tuple(float(np.float32(x)) for x in
                                  (0.8, 0.01, 32.0, 24.0, 0.0))
    # PyTorch's CUDA division by a host scalar: a multiply by the float32
    # reciprocal of its float32 value
    assert st.floats[5] == float(np.float32(1.0) / np.float32(1.0 / 255.0))
    assert (st.tb_x, st.tb_y) == (4, 3)


def test_band_scalars():
    st = kproject.setup(1, 5, 1.0, [50.0], [50.0], [32.0], [48.0], 32, 64,
                        0.01, 1.0 / 255.0, None, 96, 32)
    assert st.floats[2:5] == (32.0, 48.0, 32.0)  # half_w, half_h, row_off
    assert (st.tb_x, st.tb_y) == (4, 2)


def _outputs(views, n):
    return {k: torch.empty((views, n) + tail, dtype=dt)
            for k, (tail, dt) in kproject.OUTPUTS.items()}


def _named(launch, names):
    ptrs, ints, floats = launch
    return dict(zip(names, ptrs)), dict(zip(kproject.INTS, ints)), floats


def test_forward_packing_reads_inputs_where_they_lie():
    """Means as columns 2-4 of (V, N, 8) rows, one state's scales for
    every view, opacities (V, N, 1), one state's valid mask: each read in
    place at its row and view strides."""
    v, n = 3, 10
    big = torch.randn(v, n, 8)
    means, scales = big[..., 2:5], torch.rand(1, n, 3)
    quats, opac = torch.randn(v, n, 4), torch.rand(v, n, 1)
    valid = torch.ones(1, n, dtype=torch.bool)
    vm, pm = torch.randn(v, 4, 4), torch.randn(v, 4, 4)
    st = kproject.setup(v, n, 1.0, [50.0] * v, [51.0] * v, [8.0] * v,
                        [9.0] * v, 32, 32, 0.01, 1.0 / 255.0, None, None,
                        None)
    outs = _outputs(v, n)
    launches, keep = kproject.forward_launches(means, scales, quats, vm, pm,
                                               valid, opac, outs, st)
    assert len(launches) == 1
    ptrs, ints, floats = _named(launches[0], kproject.FWD_PTRS)
    assert ptrs["means"] == big.data_ptr() + 2 * 4
    assert (ints["s_means"], ints["vs_means"]) == (8, 8 * n)
    assert ptrs["scales"] == scales.data_ptr()
    assert (ints["s_scales"], ints["vs_scales"]) == (3, 0)
    assert (ints["s_quats"], ints["vs_quats"]) == (4, 4 * n)
    assert ptrs["opac"] == opac.data_ptr()
    assert (ints["s_opac"], ints["vs_opac"]) == (1, n)
    assert ptrs["valid"] == valid.data_ptr() and ints["vs_valid"] == 0
    assert (ptrs["viewmat"], ptrs["projmat"]) == (vm.data_ptr(),
                                                  pm.data_ptr())
    for k, t in outs.items():
        assert ptrs[k] == t.data_ptr(), k
    assert (ints["n"], ints["views"]) == (n, v)
    assert floats == st.floats + tuple(x for vf in st.view_floats
                                       for x in vf)
    assert all(k.data_ptr() != 0 for k in keep)


def test_forward_packing_absent_inputs_and_copies():
    """No valid mask or opacities: null pointers. Rows that do not lie at
    one stride (a transposed tensor) are read from a contiguous copy."""
    v, n = 1, 6
    means = torch.randn(3, n).t()[None]
    scales, quats = torch.rand(1, n, 3), torch.randn(1, n, 4)
    st = kproject.setup(v, n, 1.0, [50.0], [51.0], [8.0], [9.0], 32, 32,
                        0.01, 1.0 / 255.0, None, None, None)
    launches, keep = kproject.forward_launches(
        means, scales, quats, torch.eye(4)[None], torch.eye(4)[None], None,
        None, _outputs(v, n), st)
    ptrs, ints, _ = _named(launches[0], kproject.FWD_PTRS)
    assert ptrs["valid"] == 0 and ptrs["opac"] == 0
    assert ints["s_means"] == 3 and ptrs["means"] != means.data_ptr()
    assert any(k.data_ptr() == ptrs["means"] and torch.equal(k, means)
               for k in keep)


def test_wide_batch_takes_several_launches():
    v, n = kproject.MAX_VIEWS + 8, 5
    means = torch.randn(v, n, 3)
    scales, quats = torch.rand(1, n, 3), torch.randn(v, n, 4)
    vm = torch.randn(v, 4, 4)
    fx = [40.0 + i for i in range(v)]
    st = kproject.setup(v, n, 1.0, fx, fx, [8.0] * v, [9.0] * v, 32, 32,
                        0.01, 1.0 / 255.0, None, None, None)
    outs = _outputs(v, n)
    launches, _ = kproject.forward_launches(means, scales, quats, vm, vm,
                                            None, None, outs, st)
    assert len(launches) == 2
    first = _named(launches[0], kproject.FWD_PTRS)
    second = _named(launches[1], kproject.FWD_PTRS)
    m = kproject.MAX_VIEWS
    assert (first[1]["views"], second[1]["views"]) == (m, 8)
    assert second[0]["means"] == means.data_ptr() + 4 * m * n * 3
    assert second[0]["scales"] == scales.data_ptr()  # one state, shared
    assert second[0]["quats"] == quats.data_ptr() + 4 * m * n * 4
    assert second[0]["viewmat"] == vm.data_ptr() + 64 * m
    assert second[0]["xys"] == outs["xys"].data_ptr() + 4 * m * n * 2
    assert second[0]["mask"] == outs["mask"].data_ptr() + m * n
    assert second[2][len(kproject.FLOATS)] == float(np.float32(fx[m]))


def test_backward_packing_reads_gradients_where_they_lie():
    """The rasterizer's gradients of xys and conics as columns of one
    (V * N, 9) row array, read in place at stride 9; absent gradients as
    null pointers; an expanded scalar at stride 0; a transposed gradient
    from a contiguous copy."""
    v, n = 2, 7
    acc = torch.randn(v * n, 9)
    grads = {"xys": acc[:, 0:2].view(v, n, 2),
             "conics": acc[:, 2:5].view(v, n, 3),
             "depths": torch.ones(()).expand(v, n)}
    means, scales, quats = (torch.randn(v, n, 3), torch.rand(v, n, 3),
                            torch.randn(v, n, 4))
    outs = {"means": torch.empty(v, n, 3), "scales": None,
            "quats": torch.empty(v, n, 4)}
    st = kproject.setup(v, n, 1.0, [50.0] * v, [51.0] * v, [8.0] * v,
                        [9.0] * v, 32, 32, 0.01, 1.0 / 255.0, None, None,
                        None)
    launches, keep = kproject.backward_launches(
        means, scales, quats, torch.eye(4).expand(v, 4, 4).contiguous(),
        torch.eye(4).expand(v, 4, 4).contiguous(), grads, outs, st)
    ptrs, ints, _ = _named(launches[0], kproject.BWD_PTRS)
    assert ptrs["v_xys"] == acc.data_ptr() and ints["s_v_xys"] == 9
    assert ptrs["v_conics"] == acc.data_ptr() + 2 * 4
    assert ints["s_v_conics"] == 9
    assert ptrs["v_cam_depths"] == 0 and ptrs["v_cov2d"] == 0
    # an expanded scalar: every row read from the one float, stride 0
    assert ptrs["v_depths"] == grads["depths"].data_ptr()
    assert ints["s_v_depths"] == 0
    # a gradient whose rows do not lie at one stride: a contiguous copy
    grads["cov2d"] = torch.randn(v, 3, n).transpose(1, 2)
    launches, keep = kproject.backward_launches(
        means, scales, quats, torch.eye(4).expand(v, 4, 4).contiguous(),
        torch.eye(4).expand(v, 4, 4).contiguous(), grads, outs, st)
    ptrs, ints, _ = _named(launches[0], kproject.BWD_PTRS)
    assert ints["s_v_cov2d"] == 3
    assert any(k.data_ptr() == ptrs["v_cov2d"]
               and torch.equal(k, grads["cov2d"]) for k in keep)
    assert ptrs["v_means"] == outs["means"].data_ptr()
    assert ptrs["v_scales"] == 0
    assert ptrs["v_quats"] == outs["quats"].data_ptr()


# ---- on the card ----------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_plain_on_the_card(card, case):
    s = _scene(7)
    c = CASES[case]
    dev = {k: torch.from_numpy(s[k]).to(card).requires_grad_()
           for k in ("means", "scales", "quats")}

    def run(plain):
        args = (dev["means"], dev["scales"], 1.0, dev["quats"],
                s["viewmat"].to(card), s["projmat"].to(card), s["fx"],
                s["fy"], s["cx"], s["cy"], s["h"], s["w"])
        kw = dict(valid_mask=torch.from_numpy(s["valid"]).to(card)
                  if c["valid"] else None,
                  opacities=torch.from_numpy(s["opac"]).to(card)
                  if c["opac"] else None,
                  fov_height=c.get("fov_height"),
                  row_offset=c.get("row_offset"))
        if not plain:
            return tproj.project_gaussians(*args, **kw)
        x = [t[None] for t in (dev["means"], dev["scales"], dev["quats"])]
        return tproj.ProjectedGaussians(*(t[0] for t in tproj._project_views(
            x[0], x[1], 1.0, x[2], args[4][None], args[5][None], [s["fx"]],
            [s["fy"]], [s["cx"]], [s["cy"]], s["h"], s["w"], 0.01,
            None if kw["valid_mask"] is None else kw["valid_mask"][None],
            None if kw["opacities"] is None else kw["opacities"][None],
            1.0 / 255.0, None, kw["fov_height"], kw["row_offset"])))

    launches = kproject.run_forward.launches
    k, p = run(False), run(True)
    assert kproject.run_forward.launches == launches + 1
    regular = torch.ones(N, dtype=torch.bool, device=card)
    regular[DEGENERATE] = False
    for name in ("xys", "depths", "cam_depths", "conics", "cov2d"):
        _close(getattr(k, name)[regular].detach().cpu(),
               getattr(p, name)[regular].detach().cpu(), 1e-5, 1e-5, name)
    for name in ("radii", "num_tiles_hit", "tile_min", "tile_max", "mask"):
        assert torch.equal(getattr(k, name)[regular],
                           getattr(p, name)[regular]), name
    gen = torch.Generator(device=card).manual_seed(1)
    gx = torch.randn((N, 2), generator=gen, device=card)
    gc = torch.randn((N, 3), generator=gen, device=card)
    leaves = list(dev.values())
    gk = torch.autograd.grad((k.xys, k.conics), leaves, (gx, gc))
    gp = torch.autograd.grad((p.xys, p.conics), leaves, (gx, gc))
    for name, a, b in zip(dev, gk, gp):
        b = b[regular]
        torch.testing.assert_close(a[regular], b, rtol=1e-4,
                                   atol=1e-6 * float(b.abs().max()),
                                   msg=name)


@pytest.mark.cuda
def test_kernel_batch_views_are_their_own_calls(card):
    """Three cameras over one state and three stacked states: each view's
    outputs equal to its own single-view call, bitwise."""
    scenes = [_scene(seed) for seed in (8, 9, 10)]
    s0 = scenes[0]
    m = torch.from_numpy(s0["means"]).to(card)
    sc = torch.from_numpy(s0["scales"]).to(card)
    q = torch.from_numpy(s0["quats"]).to(card)
    vms = torch.stack([s["viewmat"] for s in scenes]).to(card)
    pms = torch.stack([s["projmat"] for s in scenes]).to(card)
    cam = [[s[k] for s in scenes] for k in ("fx", "fy", "cx", "cy")]
    batch = tproj.project_gaussians(m[None], sc[None], 1.0, q[None], vms,
                                    pms, *cam, H, W)
    for i, s in enumerate(scenes):
        one = tproj.project_gaussians(m, sc, 1.0, q, vms[i], pms[i], s["fx"],
                                      s["fy"], s["cx"], s["cy"], H, W)
        for name, a, b in zip(one._fields, batch, one):
            assert torch.equal(a[i], b), (i, name)
