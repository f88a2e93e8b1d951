"""opensplat_tpu_torch training step against the JAX package on the CPU.

Both packages start every step from one state (state_from_numpy of the
JAX TrainState's leaves), render 64x64 px with about 300 Gaussians and SH
degree 3, and take one step each. The JAX trajectory runs its main path,
renderer="pallas" (Pallas kernels in interpret mode); from each start the
JAX package's float32 tiled renderer takes the same step as a second
reference. The JAX Pallas path rounds colours to 1/256 and per-record
gradients to bf16, so its gradients differ from its own float32 renderer
by up to ~4e-3 of each leaf's scale, while the port keeps float32.
Checks: loss rel 1e-3 and the intersection counts exactly against
pallas; the final image atol 4e-3 (tests/test_pallas_raster.py:37);
gradients atol 1e-5 * scale against the float32 renderer, and against
pallas no further than the float32 renderer is; post-Adam parameters
atol 4e-3 * the leaf's scale for rows whose gradient is above the leaf's
noise floor (1e-3 of its largest) — below it Adam scales rounding noise
to a full step, and such rows are held to two steps' length."""
import numpy as np
import jax
import jax.numpy as jnp
import torch

from opensplat_tpu.config import TrainConfig as JConfig
from opensplat_tpu.models.gaussians import init_model as jinit
from opensplat_tpu.models.splat_model import render_forward as jrender
from opensplat_tpu.train import train_step_impl as jstep
from opensplat_tpu_torch.config import TrainConfig
from opensplat_tpu_torch.models.gaussians import (PARAM_NAMES, init_model,
                                                  state_from_numpy)
from opensplat_tpu_torch.models.splat_model import (DEFAULT_BACKGROUND,
                                                    render_forward)
from opensplat_tpu_torch.optim.adam import BETA1
from opensplat_tpu_torch.train import Trainer, train_step_impl

# one intra-op thread per process: the suite runs one pytest-xdist
# worker per core, and a full torch thread pool in each of them
# oversubscribes the cores
torch.set_num_threads(1)

H = W = 64
N, CAP = 300, 320
STATIC = ("height", "width", "sh_deg", "cfg", "accumulate", "renderer",
          "isect_budget", "layout_budget", "grad_budget")


def _points(seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    rgb = rng.integers(0, 255, (N, 3)).astype(np.uint8)
    return pts, rgb


def _jax_state():
    pts, rgb = _points()
    js = jinit(pts, rgb, sh_degree=3, capacity=CAP, seed=0)
    # anisotropic scales, so that rotations carry real gradients
    rng = np.random.default_rng(1)
    ds = np.zeros((CAP, 3), np.float32)
    ds[:N] = rng.uniform(-0.5, 0.5, (N, 3))
    return js.replace(params=js.params.replace(scales=js.params.scales + ds))


def _to_numpy(js):
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


def _camera():
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.1, -0.05, 4.0]
    gt = np.random.default_rng(2).uniform(0, 1, (H, W, 3)).astype(np.float32)
    return c2w, gt, 0.9 * W


def _g(mu_new, mu_old):
    """This step's gradient, recovered from Adam's first moment."""
    return (mu_new - BETA1 * mu_old) / (1.0 - BETA1)


def test_three_steps_match_jax():
    c2w, gt, f = _camera()
    cfg, tcfg = JConfig(), TrainConfig()
    jfn = jax.jit(jstep, static_argnames=STATIC)
    lr_means = 1.6e-4
    lrs = dict(means=lr_means, scales=cfg.lr_scales, quats=cfg.lr_quats,
               features_dc=cfg.lr_features_dc,
               features_rest=cfg.lr_features_rest,
               opacities=cfg.lr_opacities)
    js = _jax_state()
    for step in range(1, 4):
        start = _to_numpy(js)
        ts = state_from_numpy(start, device="cpu")
        args = (jnp.asarray(c2w), f, f, W / 2, H / 2, jnp.asarray(gt),
                lr_means)
        kw = dict(height=H, width=W, sh_deg=3, cfg=cfg, accumulate=True,
                  isect_budget=CAP * 16 + 256)
        js_f32, _ = jfn(js, *args, renderer="tiled", **kw)
        js, jm = jfn(js, *args, renderer="pallas", **kw)
        ts, tm = train_step_impl(ts, torch.from_numpy(c2w), f, f, W / 2,
                                 H / 2, torch.from_numpy(gt), lr_means, H, W,
                                 3, tcfg, True)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-3)
        for k in ("n_cands", "n_isects"):
            assert int(tm[k]) == int(jm[k]), k
        end, end_f32 = _to_numpy(js), _to_numpy(js_f32)
        for k in PARAM_NAMES:
            g_p = _g(end["mu"][k], start["mu"][k])
            g_f = _g(end_f32["mu"][k], start["mu"][k])
            g_t = _g(ts.opt.mu[k].numpy(), start["mu"][k])
            g_scale = np.abs(g_f).max()
            np.testing.assert_allclose(g_t, g_f, rtol=0, atol=1e-5 * g_scale,
                                       err_msg=f"grad {k} vs float32")
            assert (np.abs(g_t - g_p)
                    <= np.abs(g_f - g_p) + 1e-5 * g_scale).all(), k
            p_f = end_f32["params"][k]
            p_t = ts.params.as_dict()[k].numpy()
            above = np.abs(g_f) > 1e-3 * g_scale
            np.testing.assert_allclose(p_t[above], p_f[above],
                                       atol=4e-3 * np.abs(p_f).max(),
                                       err_msg=f"param {k}")
            assert np.abs(p_t - p_f)[~above].max(initial=0) <= 2.0 * lrs[k]
        s_f, s_t = end_f32["stats"], ts.stats
        nscale = np.abs(s_f["xys_grad_norm"]).max()
        np.testing.assert_allclose(s_t.xys_grad_norm.numpy(),
                                   s_f["xys_grad_norm"], rtol=0,
                                   atol=1e-5 * nscale)
        for k in ("vis_counts", "max_2d_size"):
            np.testing.assert_array_equal(getattr(s_t, k).numpy(), end["stats"][k])
    # the image of the final state
    jo = jrender(js.params, js.alive, jnp.asarray(c2w), f, f, W / 2, H / 2,
                 H, W, 3, jnp.asarray(DEFAULT_BACKGROUND, jnp.float32),
                 renderer="pallas", isect_budget=CAP * 16 + 256)
    ts = state_from_numpy(_to_numpy(js), device="cpu")
    with torch.no_grad():
        to = render_forward(ts.params, ts.alive, torch.from_numpy(c2w), f, f,
                            W / 2, H / 2, H, W, 3,
                            torch.tensor(DEFAULT_BACKGROUND), device="cpu")
    np.testing.assert_allclose(to.rgb.numpy(), np.asarray(jo.rgb), atol=4e-3)
    np.testing.assert_array_equal(to.radii.numpy(), np.asarray(jo.radii))


class _Cam:
    def __init__(self, c2w, gt, f):
        self.cam_to_world = c2w
        self.fx = self.fy = f
        self.cx, self.cy = W / 2, H / 2
        self.width, self.height = W, H
        self._gt = gt

    def get_image(self, factor):
        return self._gt[::factor, ::factor]


def _trainer(**cfg_kw):
    pts, rgb = _points()
    state = init_model(pts, rgb, sh_degree=1, capacity=CAP, seed=0,
                       device="cpu")
    c2w, gt, f = _camera()
    cfg = TrainConfig(num_downscales=0, sh_degree=1, **cfg_kw)
    return Trainer(state, [_Cam(c2w, gt, f)], cfg, device="cpu")


def test_trainer_steps_and_demand():
    tr = _trainer(sh_degree_interval=1)
    outs = [tr.run_step(s) for s in range(1, 6)]
    losses = [o.loss for o in outs]
    assert np.all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    # the largest [n_cands, n_isects, n_grads] over the steps
    demand = [max(int(o.metrics[k]) for o in outs)
              for k in ("n_cands", "n_isects", "n_grads")]
    assert demand[0] >= demand[1] > 0 and demand[2] > 0
    assert int(tr.state.opt.count) == 5
    assert bool(tr.state.stats.initialized)


def test_trainer_refine_boundary_raises():
    """The refine boundary, which raised NotImplementedError before refine
    was ported, now refines: step 2 of refine_every=2 resets alpha (its
    step % reset_interval == refine_every) and clears the stats."""
    tr = _trainer(warmup_length=1, refine_every=2)
    tr.run_step(1)
    tr.run_step(2)
    assert tr.refine_metrics == {"n_alive": N}
    reset_logit = float(np.log(np.float32(0.2) / np.float32(0.8)))
    assert float(tr.state.params.opacities.max()) <= reset_logit + 1e-6
    assert not bool(tr.state.stats.initialized)
    assert not tr.state.stats.vis_counts.any()
    assert not tr.state.opt.mu["opacities"].any()


def test_init_model_matches_jax():
    pts, rgb = _points(3)
    js = jinit(pts, rgb, sh_degree=2, capacity=CAP, seed=0)
    ts = init_model(pts, rgb, sh_degree=2, capacity=CAP, seed=0,
                    device="cpu")
    for k in PARAM_NAMES:
        a = ts.params.as_dict()[k].numpy()
        b = np.asarray(getattr(js.params, k))
        assert a.shape == b.shape, k
        if k == "quats":  # different generators: unit norm, same dead rows
            np.testing.assert_allclose(np.linalg.norm(a, axis=-1), 1.0,
                                       atol=1e-6)
            np.testing.assert_array_equal(a[N:], b[N:])
        else:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(ts.alive.numpy(), np.asarray(js.alive))


def test_state_from_numpy_round_trip():
    d = _to_numpy(_jax_state())
    ts = state_from_numpy(d, device="cpu")
    for k in PARAM_NAMES:
        np.testing.assert_array_equal(ts.params.as_dict()[k].numpy(),
                                      d["params"][k])
        np.testing.assert_array_equal(ts.opt.nu[k].numpy(), d["nu"][k])
    assert ts.opt.count == d["count"]
    assert ts.alive.dtype == torch.bool and ts.alive.shape == (CAP,)
