"""The render's SH colours (opensplat_tpu_torch/ops/sh.py render_colours)
and the SH kernel pair (ops/kernels/sh.py, csrc/sh.cu).

On the CPU: render_colours takes the plain version, which is the chain
render_forward ran inline before (view directions from the detached
means, the coefficients' `cat`, spherical_harmonics, + 0.5, the clamp)
bit for bit, colours and both coefficient gradients, for one view, V
stacked states and one state under V cameras, and counts sh.calls,
never sh.fused; the kernel wrapper raises on a wrong dtype, shape or
device; the per-row math of the kernels (csrc/sh_row.cuh, which includes
nothing of CUDA), built for the host with g++, against the plain version
and its autograd at degrees 0-4 and with degrees_to_use below the
degree; the reader splatbench/metrics/sh.fused_share.py. Every case
plants a row at a camera centre (the direction's 1e-12 clamp), a row
whose pre-clamp colour is exactly 0 (the clamp passes its gradient) and
one whose colour is negative (it does not). Tests marked `cuda` hold the
kernel pair to the plain version on the card, and each view of a batch
to its own call bitwise, and skip without one (on the chip: python3 -m
pytest --noconftest tests/test_torch_sh.py -m cuda). This file imports
no JAX."""
import ctypes
import shutil
import subprocess
from collections import Counter

import numpy as np
import pytest
import torch

from opensplat_tpu_torch.ops import sh as tsh
from opensplat_tpu_torch.ops.kernels import _lib
from opensplat_tpu_torch.ops.kernels import sh as ksh
from opensplat_tpu_torch.utils import metrics

# one intra-op thread per process: the suite runs one pytest-xdist
# worker per core
torch.set_num_threads(1)

N = 256  # a multiple of 64: the CPU's vector tails fall alike
EPS = float(np.finfo(np.float32).eps)
# the float32 features_dc whose product with float32(SH_C0) rounds to
# -0.5: that row's colour is exactly 0 before the clamp
ZERO_DC = np.float32(-0.5 / float(np.float32(tsh.SH_C0)))
assert np.float32(np.float32(tsh.SH_C0) * ZERO_DC) == np.float32(-0.5)
AT_CAMERA, AT_ZERO, NEGATIVE = 0, 1, 2  # the planted rows
# (bases, degrees_to_use): every degree's whole basis and one below it
DEGREES = [(1, 0), (4, 1), (4, 0), (9, 2), (9, 1), (16, 3), (16, 1),
           (25, 4), (25, 2)]
# (views, states): one view, V stacked states, one state under V cameras
LAYOUTS = {"one": (1, 1), "stacked4": (4, 4), "cams3": (3, 1)}
# how far a basis entry of the kernel may lie from the plain version's
# (_check)
BASIS_ATOL, BASIS_RTOL = 32 * EPS, 8 * EPS


def _inputs(seed, bases, views, states, device="cpu"):
    """means (states, N, 3), cam_pos (views, 3), features_dc (states, N,
    3), features_rest (states, N, bases - 1, 3), the planted rows in
    every state: AT_CAMERA at its view's camera centre (view 0's where
    one state serves every view), AT_ZERO's colour exactly 0 before the
    clamp and NEGATIVE's below it in every view."""
    rng = np.random.default_rng(seed)
    cam = rng.uniform(-2, 2, (views, 3)).astype(np.float32)
    means = rng.normal(0, 3, (states, N, 3)).astype(np.float32)
    dc = rng.normal(0, 1, (states, N, 3)).astype(np.float32)
    rest = rng.normal(0, 0.4, (states, N, bases - 1, 3)).astype(np.float32)
    for s in range(states):
        means[s, AT_CAMERA] = cam[s if states > 1 else 0]
    dc[:, AT_ZERO], dc[:, NEGATIVE] = ZERO_DC, -4.0
    rest[:, AT_ZERO] = rest[:, NEGATIVE] = 0.0
    return [torch.from_numpy(a).to(device)
            for a in (means, cam, dc, rest)]


def _todays_chain(deg, means, cam_pos, dc, rest):
    """render_forward's SH lines before the kernel pair, verbatim."""
    viewdirs = means.detach() - cam_pos[:, None, :]
    viewdirs = viewdirs / torch.clamp(
        torch.linalg.norm(viewdirs, dim=-1, keepdim=True), min=1e-12)
    coeffs = torch.cat([dc[..., None, :], rest], dim=-2)
    return torch.clamp(
        tsh.spherical_harmonics(deg, viewdirs, coeffs) + 0.5, min=0.0)


def _colours_and_grads(fn, deg, means, cam, dc, rest, v_rgb):
    leaves = [t.detach().clone().requires_grad_() for t in (dc, rest)]
    rgb = fn(deg, means, cam, *leaves)
    return (rgb,) + torch.autograd.grad(rgb, leaves, v_rgb)


def _v_rgb(views, device="cpu", seed=1):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((views, N, 3), generator=gen, device=device)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_cpu_takes_the_plain_version_which_is_the_old_chain(layout):
    views, states = LAYOUTS[layout]
    x = _inputs(3, 16, views, states)
    v_rgb = _v_rgb(views)
    before, launches = metrics.counts(), ksh.run_forward.launches
    got = _colours_and_grads(tsh.render_colours, 3, *x, v_rgb)
    after = metrics.counts()
    want = _colours_and_grads(_todays_chain, 3, *x, v_rgb)
    for name, a, b in zip(("rgb", "v_dc", "v_rest"), got, want):
        assert a.shape == b.shape and torch.equal(a, b), name
    assert after["sh.calls"] - before.get("sh.calls", 0) == 1
    assert after.get("sh.fused", 0) == before.get("sh.fused", 0)
    assert ksh.run_forward.launches == launches
    rgb = got[0]
    assert bool((rgb[:, AT_ZERO] == 0).all() & (rgb[:, NEGATIVE] == 0).all())
    assert bool(torch.isfinite(rgb).all())


def _valid_cpu():
    means, cam, dc, rest = _inputs(4, 16, 2, 2)
    return dict(means=means, cam_pos=cam, features_dc=dc,
                features_rest=rest)


@pytest.mark.parametrize("change, error, match", [
    (dict(features_dc=lambda x: x.double()), TypeError, "features_dc"),
    (dict(means=lambda x: x.half()), TypeError, "means"),
    (dict(features_rest=lambda x: x[:, :, :14]), ValueError,
     "features_rest"),
    (dict(features_dc=lambda x: x[:, :-1]), ValueError, "features_dc"),
    (dict(means=lambda x: torch.cat([x, x])), ValueError, "states"),
    (dict(cam_pos=lambda x: x[:, :2]), ValueError, "cam_pos"),
    (dict(n_used=25), ValueError, "bases used"),
    ({}, ValueError, "CUDA"),
], ids=["dtype", "half_means", "bases", "rows", "states", "cam_pos",
        "degree", "device"])
def test_kernel_wrapper_refuses(change, error, match):
    args = dict(_valid_cpu(), n_used=16)
    for k, f in change.items():
        args[k] = f(args[k]) if callable(f) else f
    with pytest.raises(error, match=match):
        ksh.sh_colours(args["n_used"], args["means"],
                       args["cam_pos"], args["features_dc"],
                       args["features_rest"])


def test_reader_fused_share(monkeypatch):
    from splatbench import harness

    read = harness.load_reader("sh.fused_share")
    monkeypatch.setattr(metrics, "_counts", Counter())
    assert read(None) is None
    metrics.count("sh.calls", 4)
    metrics.count("sh.fused", 3)
    assert read(None) == pytest.approx(75.0)


# ---- the row math, built for the host ------------------------------------

_SHIM = r"""
#include "sh_row.cuh"
using namespace osk_sh;
template <int B>
void fwd(int n, int n_used, const float* m, const float* e, const float* dc,
         const float* rest, float* rgb, unsigned char* bits, float* bs) {
  for (int i = 0; i < n; ++i) {
    float dir[3], b[B];
    view_dir(m + 3 * i, e, dir);
    basis<B>(dir, n_used, b);
    bits[i] = colour<B>(b, n_used, dc + 3 * i, rest + 3 * (B - 1) * i,
                        rgb + 3 * i);
    for (int k = 0; k < B; ++k) bs[B * i + k] = b[k];
  }
}
template <int B>
void bwd(int n, int n_used, const float* m, const float* e,
         const unsigned char* bits, const float* g, float* v_dc,
         float* v_rest) {
  for (int i = 0; i < n; ++i) {
    float dir[3], b[B], gm[3];
    view_dir(m + 3 * i, e, dir);
    basis<B>(dir, n_used, b);
    masked(g + 3 * i, bits[i], gm);
    coeff_grad<B>(b, gm, false, v_dc + 3 * i, v_rest + 3 * (B - 1) * i);
  }
}
#define CASES(F, ...) switch (B) { \
  case 1: F<1>(__VA_ARGS__); break; case 4: F<4>(__VA_ARGS__); break; \
  case 9: F<9>(__VA_ARGS__); break; case 16: F<16>(__VA_ARGS__); break; \
  default: F<25>(__VA_ARGS__); }
extern "C" void host_fwd(int B, int n, int n_used, const float* m,
                         const float* e, const float* dc, const float* rest,
                         float* rgb, unsigned char* bits, float* bs) {
  CASES(fwd, n, n_used, m, e, dc, rest, rgb, bits, bs)
}
extern "C" void host_bwd(int B, int n, int n_used, const float* m,
                         const float* e, const unsigned char* bits,
                         const float* g, float* v_dc, float* v_rest) {
  CASES(bwd, n, n_used, m, e, bits, g, v_dc, v_rest)
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The kernels' row math built for the host: each float op rounded on
    its own (no contraction into FMAs), as nvcc's --fmad=false builds
    it; fmaf stays a fused multiply-add."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the row math for the host")
    d = tmp_path_factory.mktemp("sh_row")
    (d / "shim.cpp").write_text(_SHIM)
    lib = d / "libsh_row.so"
    subprocess.run(["g++", "-std=c++17", "-O2", "-ffp-contract=off",
                    "-shared", "-fPIC", "-I", str(_lib.CSRC),
                    str(d / "shim.cpp"), "-o", str(lib)], check=True,
                   capture_output=True, timeout=120)
    return ctypes.CDLL(str(lib))


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _plain_basis(deg, means, cam, dc, rest):
    """The plain version's basis (views, N, B) and its coefficients
    (states, N, B, 3)."""
    d = means.detach() - cam[:, None, :]
    d = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True),
                        min=1e-12)
    bs = tsh.eval_sh_basis(tsh.deg_from_sh(rest.shape[-2] + 1), deg, d)
    return bs, torch.cat([dc[..., None, :], rest], dim=-2)


def _check(label, bases, deg, x, got, want, v_rgb):
    """got and want: (rgb, v_dc, v_rest) of V views, held to each other in
    float64. Each used basis entry of the two sides parts by at most
    BASIS_ATOL + BASIS_RTOL |basis_b| =: e_b: the direction's norm is
    summed in another order (an ulp or two of the direction, times the
    basis' slope, up to ~15 at degree 4), and a column that cancels
    (2 zz - xx - yy) keeps the rounding of its terms, not of its value.
    The colours further differ by the order of two float32 sums of
    `bases` products, at most 2 bases eps times sum_b |basis_b
    coeff_bc|: the colour's tolerance is that (+ 0.5 for the last add)
    plus sum_b e_b |coeff_bc|. A coefficient gradient is one product
    basis_b g_c a view: e_b |g_c| + eps |basis_b g_c| a view, summed
    over the views, plus 2 eps a view of sum_v |basis_b g_c| where one
    state adds every view's. The clamp's mask agrees wherever the plain
    version's pre-clamp colour lies past the colour's tolerance; a
    channel within it (at most 4) is left out of the gradients' check
    (the planted zero is exact on both sides)."""
    means, cam, dc, rest = x
    views, states = cam.shape[0], dc.shape[0]
    bs, coeffs = _plain_basis(deg, means, cam, dc, rest)
    bs = bs.double().cpu()
    coeffs = coeffs.double().cpu().expand((views,) + coeffs.shape[1:])
    used = torch.arange(bases) < tsh.num_sh_bases(deg)
    err = (BASIS_ATOL + BASIS_RTOL * bs.abs()) * used
    terms = torch.einsum("vnb,vnbc->vnc", bs.abs(), coeffs.abs())
    tol = 2 * bases * EPS * (terms + 0.5) + torch.einsum(
        "vnb,vnbc->vnc", err, coeffs.abs())
    rgb_k, rgb_p = (t.detach().double().cpu() for t in (got[0], want[0]))
    bad = (rgb_k - rgb_p).abs() > tol
    assert not bool(bad.any()), (label, "rgb", int(bad.sum()),
                                 float((rgb_k - rgb_p).abs().max()))
    for v in range(views):
        assert float(rgb_k[v, [AT_ZERO, NEGATIVE]].abs().max()) == 0.0, (
            label, v)
    # the plain version's pre-clamp colour, and the channels whose mask
    # either side may set
    pre = torch.einsum("vnb,vnbc->vnc", bs, coeffs) + 0.5
    # AT_ZERO's product rounds to -0.5 on both sides: its colour is 0 in
    # float32, not the float64 sum's few ulp of -0.5 + 0.5
    pre[:, AT_ZERO] = 0.0
    unsure = pre.abs() <= tol
    unsure[:, AT_ZERO] = False
    assert int(unsure.sum()) <= 4, (label, int(unsure.sum()))
    g = torch.where(pre >= 0, v_rgb.double().cpu(), 0.0).abs()[:, :, None]
    prod = bs.abs()[..., None] * g
    gtol = err[..., None] * g + EPS * prod  # (views, N, B, 3)
    keep = ~unsure
    if states == 1:  # every view's gradient added into one state's
        gtol = gtol.sum(0, keepdim=True) + 2 * views * EPS * prod.sum(
            0, keepdim=True)
        keep = keep.all(0, keepdim=True)
    for name, k, p, sl in (("v_dc", got[1], want[1], slice(0, 1)),
                           ("v_rest", got[2], want[2], slice(1, None))):
        k = k.double().cpu().reshape(states, N, -1, 3)
        p = p.double().cpu().reshape(states, N, -1, 3)
        over = ((k - p).abs() - gtol[:, :, sl]) * keep[:, :, None, :]
        assert not bool((over > 0).any()), (label, name,
                                            float((k - p).abs().max()))


@pytest.mark.parametrize("bases, deg", DEGREES)
def test_row_math_matches_plain_version(host_lib, bases, deg):
    means, cam, dc, rest = _inputs(10 + bases + deg, bases, 1, 1)
    n_used = tsh.num_sh_bases(deg)
    rgb = torch.empty((N, 3))
    bits = torch.empty((N,), dtype=torch.uint8)
    bs = torch.empty((N, bases))
    host_lib.host_fwd(bases, N, n_used, _ptr(means), _ptr(cam), _ptr(dc),
                      _ptr(rest), _ptr(rgb), _ptr(bits), _ptr(bs))
    v_rgb = _v_rgb(1)
    v_dc = torch.empty((N, 3))
    v_rest = torch.empty((N, bases - 1, 3))
    host_lib.host_bwd(bases, N, n_used, _ptr(means), _ptr(cam), _ptr(bits),
                      _ptr(v_rgb.contiguous()), _ptr(v_dc), _ptr(v_rest))
    want = _colours_and_grads(tsh.render_colours_plain, deg, means, cam, dc,
                              rest, v_rgb)
    plain_bs = _plain_basis(deg, means, cam, dc, rest)[0][0]
    torch.testing.assert_close(bs, plain_bs, rtol=BASIS_RTOL,
                               atol=BASIS_ATOL)
    assert bool((bs[:, n_used:] == 0).all())
    # the mask bits are the colour's own: set where it passed the clamp
    on = (bits[:, None].long() >> torch.arange(3)) & 1 == 1
    assert bool(on[rgb > 0].all()) and bool((rgb[~on] == 0).all())
    assert int(bits[AT_ZERO]) == 7 and int(bits[NEGATIVE]) == 0
    _check(f"host B={bases} deg={deg}", bases, deg,
           (means, cam, dc, rest), (rgb[None], v_dc[None], v_rest[None]),
           want, v_rgb)


# ---- on the card ----------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("bases, deg", DEGREES)
def test_kernel_matches_plain_on_the_card(card, bases, deg, layout):
    views, states = LAYOUTS[layout]
    x = _inputs(20 + bases + deg, bases, views, states, card)
    v_rgb = _v_rgb(views, card)
    before = (ksh.run_forward.launches, ksh.run_backward.launches)
    calls = metrics.counts()
    got = _colours_and_grads(tsh.render_colours, deg, *x, v_rgb)
    assert (ksh.run_forward.launches, ksh.run_backward.launches) == (
        before[0] + 1, before[1] + 1)
    after = metrics.counts()
    assert after["sh.fused"] - calls.get("sh.fused", 0) == 1
    want = _colours_and_grads(tsh.render_colours_plain, deg, *x, v_rgb)
    _check(f"card B={bases} deg={deg} {layout}", bases, deg, x, got, want,
           v_rgb)


@pytest.mark.cuda
def test_kernel_batch_views_are_their_own_calls(card):
    """Four stacked states: each view's colours and gradients equal its
    own single-view call's, bitwise. Three cameras over one state: each
    view's colours equal its own call's, and the state's gradient is the
    single views' gradients summed in view order."""
    for views, states in ((4, 4), (3, 1)):
        means, cam, dc, rest = _inputs(40 + views, 16, views, states, card)
        v_rgb = _v_rgb(views, card)
        batch = _colours_and_grads(tsh.render_colours, 3, means, cam, dc,
                                   rest, v_rgb)
        singles = []
        for v in range(views):
            s = v if states > 1 else 0
            one = _colours_and_grads(
                tsh.render_colours, 3, means[s:s + 1], cam[v:v + 1],
                dc[s:s + 1], rest[s:s + 1], v_rgb[v:v + 1])
            assert torch.equal(batch[0][v], one[0][0]), (views, v)
            singles.append(one)
        for k in (1, 2):
            if states > 1:
                want = torch.cat([one[k] for one in singles])
            else:
                want = singles[0][k]
                for one in singles[1:]:
                    want = want + one[k]
            assert torch.equal(batch[k], want), (views, k)
