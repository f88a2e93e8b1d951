"""Degenerate splats give finite gradients through the port's fast path,
one view and a batch of two (the port's counterpart of
tests/test_grad_sanitize.py).

The JAX suite's canary: 16 of 1024 splats with the log-scales (-15.1,
-1.78, -8.55) (axis ratios ~1e5) and the opacity logit 12 observed on
the offenders of a long 1080p run. Their per-record backward terms can
overflow float32; the port zeroes nonfinite terms where they are
emitted (csrc/raster_bwd.cu, ops/kernels/raster.py::moment_terms), so
render_forward + main_loss must give finite gradients for every leaf.
Like the JAX test it is a canary: at this size no term overflows (the
test passes with the zeroing removed), it pins that these splats stay
finite. On the CPU the kernels' plain versions run; chip_smoke.py runs
the same state through the CUDA backward."""
import numpy as np
import pytest
import torch

from opensplat_tpu_torch.models.gaussians import PARAM_NAMES, init_model
from opensplat_tpu_torch.models.splat_model import (DEFAULT_BACKGROUND,
                                                    GaussianParams,
                                                    render_forward)
from opensplat_tpu_torch.ops.ssim import main_loss

# one intra-op thread per process: the suite runs one pytest-xdist
# worker per core, and a full torch thread pool in each of them
# oversubscribes the cores
torch.set_num_threads(1)

H = W = 64


def degenerate_state(n=1024, n_bad=16, seed=0, device="cpu"):
    """tests/test_grad_sanitize.py's scene: n points at z in [-8, -4]
    in front of an identity camera, n_bad of them degenerate."""
    rng = np.random.default_rng(seed)
    pts = np.concatenate(
        [rng.uniform(-1.0, 1.0, (n, 2)), rng.uniform(-8.0, -4.0, (n, 1))],
        axis=-1).astype(np.float32)
    rgb = rng.integers(0, 255, (n, 3)).astype(np.uint8)
    state = init_model(pts, rgb, sh_degree=1, capacity=n, seed=seed,
                       device=device)
    bad = rng.choice(n, n_bad, replace=False)
    bad_t = torch.as_tensor(bad, device=state.device)
    state.params.scales[bad_t] = torch.tensor([-15.1, -1.78, -8.55],
                                              device=state.device)
    state.params.opacities[bad_t] = 12.0
    return state, bad


def degenerate_grads(state, views, device="cpu"):
    """The six leaves' gradients of main_loss through render_forward
    (fast): one identity camera, or `views` cameras at small offsets
    rendered as one batch over the state."""
    gt = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 1, (H, W, 3)).astype(np.float32)).to(device)
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in state.params.as_dict().items()}
    c2w = torch.eye(4, device=device)
    bg = torch.tensor(DEFAULT_BACKGROUND, device=device)
    if views is None:
        out = render_forward(GaussianParams(**leaves), state.alive, c2w,
                             80.0, 80.0, W / 2, H / 2, H, W, 1, bg,
                             device=device)
        loss = main_loss(out.rgb, gt, 0.2)
    else:
        c2w = c2w.repeat(views, 1, 1)
        c2w[:, 0, 3] = 0.05 * torch.arange(views, device=device)
        f = [80.0] * views
        out = render_forward(GaussianParams(**leaves), state.alive, c2w, f,
                             f, [W / 2] * views, [H / 2] * views, H, W, 1, bg,
                             device=device)
        loss = main_loss(out.rgb, gt.expand(views, H, W, 3), 0.2).sum()
    grads = torch.autograd.grad(loss, [leaves[k] for k in PARAM_NAMES],
                                allow_unused=True)
    return dict(zip(PARAM_NAMES, grads))


@pytest.mark.parametrize("views", [None, 2], ids=["one", "batch2"])
def test_degenerate_splats_finite_grads(views):
    state, _ = degenerate_state()
    g = degenerate_grads(state, views)
    for name in ("means", "scales", "quats", "features_dc", "opacities"):
        v = g[name]
        bad_rows = (~torch.isfinite(v.reshape(v.shape[0], -1))).any(1)
        assert not bad_rows.any(), (
            f"nonfinite {name} grads at rows "
            f"{torch.nonzero(bad_rows)[:8, 0].tolist()}")
    # the scene still renders and produces useful signal
    assert float(g["means"].abs().max()) > 0.0
