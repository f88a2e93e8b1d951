"""SSIM's plain version (opensplat_tpu_torch/ops/kernels/ssim.py: the
11-tap stencil as shifted slices, the explicit backward through the
flipped window) on the CPU, against the JAX package's ssim and jax.grad
of its main_loss, and against the float64 direct 2-D convolution of the
reference's formula (ssim_direct) with autograd (the JAX package's
banded matrices need at least 5 rows and columns, so a 1-row image is
held to that alone). Tolerances are test_torch_ops.py::test_ssim_and_loss's: the
value 1e-5 relative, the gradient 1e-4 of its largest entry. The images
are random, so the window's asymmetry shows: a backward with the
unflipped window misses the gradient by far more."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from opensplat_tpu.ops import ssim as jssim
from opensplat_tpu_torch.ops import ssim as tssim
from opensplat_tpu_torch.ops.kernels import ssim as kssim

# one intra-op thread per process: the suite runs one pytest-xdist
# worker per core
torch.set_num_threads(1)

SHAPES = [(40, 56), (37, 29), (7, 9), (1, 16), (64, 48)]
W_SSIM = 0.2


def _images(h, w, seed=4):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    return a, b


def _rel(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _direct_loss_grad(a, b):
    """main_loss's value and gradient in the rendered image, float64."""
    r = torch.from_numpy(a).double().requires_grad_(True)
    gt = torch.from_numpy(b).double()
    loss = ((1 - W_SSIM) * (gt - r).abs().mean()
            + W_SSIM * (1 - kssim.ssim_direct(r, gt)))
    loss.backward()
    return float(kssim.ssim_direct(r.detach(), gt)), r.grad.numpy()


@pytest.mark.parametrize("h,w", SHAPES)
def test_plain_ssim_forward_and_backward(h, w):
    a, b = _images(h, w)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    value = float(kssim.ssim_forward_plain(tb, ta))
    direct_value, direct_grad = _direct_loss_grad(a, b)
    _rel(value, direct_value, 1e-5)
    # the loss's gradient through the explicit backward
    tr = ta.clone().requires_grad_(True)
    tssim.main_loss(tr, tb, W_SSIM).backward()
    _rel(tr.grad.numpy(), direct_grad, 1e-4)
    # SSIM's part alone, through ssim_backward_plain directly
    one = torch.tensor(1.0)
    g_ssim = kssim.ssim_backward_plain(tb, ta, one).numpy()
    if min(h, w) >= 5:
        ja, jb = jnp.asarray(a), jnp.asarray(b)
        _rel(value, float(jssim.ssim(ja, jb)), 1e-5)
        jg = jax.grad(lambda r: jssim.main_loss(r, jb, W_SSIM))(ja)
        _rel(tr.grad.numpy(), np.asarray(jg), 1e-4)
        jg_ssim = jax.grad(lambda r: jssim.ssim(r, jb))(ja)
        _rel(g_ssim, np.asarray(jg_ssim), 1e-4)


def test_backward_is_the_transpose_of_the_forward():
    """<v, B f> = <B^T v, f> for the plain blur and its flipped
    transpose, and the explicit backward equals autograd through the
    plain forward (float64, so rounding does not hide a wrong tap)."""
    rng = np.random.default_rng(7)
    f = torch.from_numpy(rng.normal(size=(13, 21, 3)))
    v = torch.from_numpy(rng.normal(size=(13, 21, 3)))
    lhs = float((v * kssim._blur(f)).sum())
    rhs = float((kssim._blur(v, True) * f).sum())
    assert abs(lhs - rhs) <= 1e-12 * max(abs(lhs), 1.0)
    a, b = (torch.from_numpy(x).double() for x in _images(13, 21, seed=8))
    r = a.clone().requires_grad_(True)
    kssim.ssim_forward_plain(b, r).backward()
    # 1 / (H W 3) enters as a float32, hence 1e-6
    one = torch.tensor(1.0, dtype=torch.float64)
    got = kssim.ssim_backward_plain(b, a, one)
    _rel(got.numpy(), r.grad.numpy(), 1e-6)


def test_batched_main_loss_is_each_views_own_call():
    """main_loss over (V, H, W, 3) gives each view the bits of its own
    call: the values and the gradients."""
    views = [_images(24, 40, seed=s) for s in range(3)]
    r = torch.from_numpy(np.stack([a for a, _ in views])).requires_grad_(True)
    gt = torch.from_numpy(np.stack([b for _, b in views]))
    losses = tssim.main_loss(r, gt, W_SSIM)
    losses.sum().backward()
    for v, (a, b) in enumerate(views):
        rv = torch.from_numpy(a).requires_grad_(True)
        lv = tssim.main_loss(rv, torch.from_numpy(b), W_SSIM)
        lv.backward()
        assert torch.equal(losses[v].detach(), lv.detach())
        assert torch.equal(r.grad[v], rv.grad)


def test_cpu_wrappers_take_the_plain_versions():
    """The kernel wrappers, given CPU tensors, return the plain versions'
    results and count no launch; no_grad needs no backward."""
    before = (kssim.ssim_forward.launches, kssim.ssim_backward.launches)
    a, b = (torch.from_numpy(x) for x in _images(20, 36))
    one = torch.tensor(0.5)
    assert torch.equal(kssim.ssim_forward(b, a),
                       kssim.ssim_forward_plain(b, a))
    assert torch.equal(kssim.ssim_backward(b, a, one),
                       kssim.ssim_backward_plain(b, a, one))
    with torch.no_grad():
        assert torch.equal(tssim.ssim(a, b), kssim.ssim_forward_plain(b, a))
    assert (kssim.ssim_forward.launches,
            kssim.ssim_backward.launches) == before


def test_ground_truth_that_requires_grad_raises():
    a, b = (torch.from_numpy(x) for x in _images(12, 12))
    with pytest.raises(ValueError, match="ground truth"):
        tssim.ssim(a, b.clone().requires_grad_(True))
