"""opensplat_tpu_torch.parallel on the CPU: the band projection, the
camera batch, camera-DP over gloo ranks and the distributed bootstrap.

Against the JAX package: project_gaussians and render_forward with
fov_height (a band of a larger frame), Trainer._sample_batch's draw
order on a mixed-size camera set, accumulate_stats_batched and
batched_train_step with D = 2 (the JAX renderer "tiled", float32; the
tolerances of tests/test_parallel.py:73-83). Against the port's own
single-process steps: the densify-stat folds against D sequential
accumulations (split and duplicate masks equal), dp_train_step on 2
gloo ranks against batched_train_step (tests/test_dp_trainer.py's
tolerances), and DPTrainer on 2 ranks against one rank with d_local = 2
through an alpha reset and a densifying refine (loss rtol 5e-4 a step,
alive masks and refine metrics equal, final state rtol 5e-3 atol 5e-5,
tests/test_dp_trainer.py:183-192). Sizes: 64x64 px, 300 Gaussians.
Ranks are processes started by parallel/launch.py with a file:// store,
one torch thread each and a time limit; a failing or late rank stops
them all."""
import inspect
import os
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from opensplat_tpu.config import TrainConfig as JConfig
from opensplat_tpu.models.gaussians import init_model as jinit
from opensplat_tpu.models.splat_model import render_forward as jrender
from opensplat_tpu.ops.camera import camera_matrices as jcamera
from opensplat_tpu.ops.projection import project_gaussians as jproject
from opensplat_tpu.parallel.sharded_train import (
    accumulate_stats_batched as jaccumulate_batched)
from opensplat_tpu.parallel.sharded_train import (
    batched_train_step as jbatched_step)
from opensplat_tpu.train import Trainer as JTrainer
from opensplat_tpu_torch.config import TrainConfig
from opensplat_tpu_torch.data.dataset import Camera
from opensplat_tpu_torch.models.densify import (_split_dup_masks,
                                                accumulate_stats)
from opensplat_tpu_torch.models.gaussians import (PARAM_NAMES, init_model,
                                                  state_from_numpy,
                                                  zero_stats)
from opensplat_tpu_torch.models.splat_model import (DEFAULT_BACKGROUND,
                                                    render_forward)
from opensplat_tpu_torch.ops.camera import camera_matrices
from opensplat_tpu_torch.ops.projection import project_gaussians
from opensplat_tpu_torch.parallel.distributed import initialize_from_env
from opensplat_tpu_torch.parallel.dp_trainer import DPTrainer, _fold_stats_dp
from opensplat_tpu_torch.parallel.launch import RankFailure, run_ranks
from opensplat_tpu_torch.parallel.mesh import make_mesh
from opensplat_tpu_torch.parallel.sharded_train import (
    accumulate_stats_batched, batched_train_step)
from opensplat_tpu_torch.train import Trainer

# one intra-op thread per process, ranks included: the suite runs one
# pytest-xdist worker per core
torch.set_num_threads(1)
RANK_ENV = dict(os.environ, OMP_NUM_THREADS="1")

H = W = 64
N, CAP = 300, 320
F = 0.9 * W
LR = 1.6e-4


def run_function(fn, world, *args, **kwargs):
    """fn(*args) in `world` rank processes (parallel/launch.py's
    run_ranks; keyword arguments go there). fn stands alone: imports
    inside, literal arguments; its source runs, nothing is pickled, so
    a rank imports torch and the port, never JAX."""
    src = textwrap.dedent(inspect.getsource(fn))
    code = f"{src}\n{fn.__name__}(*{args!r})\n"
    return run_ranks([sys.executable, "-c", code], world, **kwargs)


def _look_at(eye):
    eye = np.asarray(eye, np.float64)
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, [0, 1, 0])
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, -fwd, eye
    return c2w


def _scene(n_cams, seed=0):
    """Points, colours, a ring of cameras and random ground truths."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    rgb = rng.integers(0, 255, (N, 3)).astype(np.uint8)
    c2w = np.stack([_look_at((4 * np.sin(a), 0.5, 4 * np.cos(a))) for a in
                    np.linspace(0, 0.6, n_cams)])
    gts = rng.uniform(0, 1, (n_cams, H, W, 3)).astype(np.float32)
    return pts, rgb, c2w, gts


def _numpy_state(js):
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


def _assert_state_close(got, want, rtol, atol, names=PARAM_NAMES):
    for k in names:
        np.testing.assert_allclose(np.asarray(getattr(got.params, k)),
                                   np.asarray(getattr(want.params, k)),
                                   rtol=rtol, atol=atol, err_msg=k)


def test_band_projection_and_render_match_jax():
    """A 16-row band of the 64-row frame (cy shifted by 32, fov_height =
    64, as the JAX package renders a band): the port's projection equals
    the JAX one's, and its band render (fast) the JAX band render
    (tiled, float32) and the rows of the whole frame's render. With
    row_offset (the port's bands: cy the frame's) the band equals the
    whole frame's rows bit for bit."""
    pts, rgb, c2w, _ = _scene(1)
    js = jinit(pts, rgb, sh_degree=3, capacity=CAP, seed=0)
    ts = state_from_numpy(_numpy_state(js), device="cpu")
    band_h, top = 16, 32
    cy = H / 2 - top
    p = ts.params
    vm, pm, _ = camera_matrices(torch.from_numpy(c2w[0]), F, F, W, band_h)
    got = project_gaussians(
        p.means, torch.exp(p.scales), 1.0,
        p.quats / torch.linalg.norm(p.quats, dim=-1, keepdim=True), vm, pm,
        F, F, W / 2, cy, band_h, W, valid_mask=ts.alive, fov_height=H)
    jvm, jpm, _ = jcamera(jnp.asarray(c2w[0]), F, F, W, band_h)
    jp = js.params
    want = jproject(
        jp.means, jnp.exp(jp.scales), 1.0,
        jp.quats / jnp.linalg.norm(jp.quats, axis=-1, keepdims=True), jvm,
        jpm, F, F, W / 2, cy, band_h, W, valid_mask=js.alive, fov_height=H)
    for k in ("xys", "conics", "cov2d", "depths"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    for k in ("radii", "mask", "num_tiles_hit", "tile_min", "tile_max"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)), k)
    # the clamp is the whole frame's: without fov_height it differs
    narrow = project_gaussians(
        p.means, torch.exp(p.scales), 1.0,
        p.quats / torch.linalg.norm(p.quats, dim=-1, keepdim=True), vm, pm,
        F, F, W / 2, cy, band_h, W, valid_mask=ts.alive)
    assert not torch.equal(narrow.cov2d, got.cov2d)

    bg = torch.tensor(DEFAULT_BACKGROUND)
    band = render_forward(ts.params, ts.alive, torch.from_numpy(c2w[0]), F, F,
                          W / 2, cy, band_h, W, 3, bg, device="cpu",
                          fov_height=H).rgb
    jband = jrender(js.params, js.alive, jnp.asarray(c2w[0]), F, F, W / 2,
                    cy, band_h, W, 3, jnp.asarray(DEFAULT_BACKGROUND),
                    renderer="tiled", fov_height=H).rgb
    np.testing.assert_allclose(band.numpy(), np.asarray(jband), rtol=1e-5,
                               atol=1e-5)
    whole = render_forward(ts.params, ts.alive, torch.from_numpy(c2w[0]), F,
                           F, W / 2, H / 2, H, W, 3, bg, device="cpu").rgb
    np.testing.assert_allclose(band.numpy(), whole[top:top + band_h].numpy(),
                               rtol=1e-5, atol=1e-5)
    exact = render_forward(ts.params, ts.alive, torch.from_numpy(c2w[0]), F,
                           F, W / 2, H / 2, band_h, W, 3, bg, device="cpu",
                           fov_height=H, row_offset=top).rgb
    assert torch.equal(exact, whole[top:top + band_h])


class _SizedCam:
    """A camera whose image size is all _sample_batch looks at."""

    def __init__(self, i, size):
        self.i = i
        self._img = np.zeros((size, size, 3), np.float32)

    def get_image(self, factor):
        return self._img


def test_sample_batch_matches_jax_draw_order():
    """On a camera set of two image sizes, d_total = 3: the batches' sizes
    and cameras, in the JAX Trainer's order, over several epochs."""
    cams = [_SizedCam(i, 16 if i % 3 else 24) for i in range(7)]
    pts, rgb, _, _ = _scene(1)
    cfg = TrainConfig()
    tr = Trainer(init_model(pts, rgb, 0, capacity=CAP, device="cpu"), cams,
                 cfg, device="cpu")
    jt = JTrainer(jinit(pts, rgb, sh_degree=0, capacity=CAP, seed=0), cams,
                  JConfig())
    tr.d_total = jt.d_total = 3
    for _ in range(9):
        (hw, batch), (jhw, jbatch) = tr._sample_batch(1), jt._sample_batch(1)
        assert hw == jhw
        assert [c.i for c, _ in batch] == [c.i for c, _ in jbatch]
        assert all(tuple(g.shape[:2]) == hw for _, g in batch)
    assert tr.sampler.draws == jt.sampler.draws


def test_accumulate_stats_batched_matches_jax():
    """Random per-camera gradients and radii (a third invisible), twice:
    the uninitialized (post-refine) fold, then the accumulating one."""
    rng = np.random.default_rng(5)
    d = 4
    stats = zero_stats(CAP, "cpu")
    from opensplat_tpu.models.gaussians import zero_stats as jzero

    jstats = jzero(CAP)
    for _ in range(2):
        g = rng.normal(0, 2e-4, (d, CAP, 2)).astype(np.float32)
        radii = (rng.integers(0, 3, (d, CAP))
                 * rng.integers(1, 9, (d, CAP))).astype(np.int32)
        stats = accumulate_stats_batched(stats, torch.from_numpy(g),
                                         torch.from_numpy(radii), H, W)
        jstats = jaccumulate_batched(jstats, jnp.asarray(g),
                                     jnp.asarray(radii), H, W)
        np.testing.assert_allclose(stats.xys_grad_norm.numpy(),
                                   np.asarray(jstats.xys_grad_norm),
                                   rtol=1e-6, atol=1e-12)
        for k in ("vis_counts", "max_2d_size", "initialized"):
            np.testing.assert_array_equal(getattr(stats, k).numpy(),
                                          np.asarray(getattr(jstats, k)), k)


def test_batched_train_step_matches_jax():
    """batched_train_step, D = 2 cameras, the port (fast) against the JAX
    package (tiled, float32): loss rtol 1e-5, params rtol 2e-4 atol
    5e-6, xys_grad_norm rtol 2e-4 atol 1e-8 (tests/test_parallel.py)."""
    d = 2
    pts, rgb, c2w, gts = _scene(d)
    js = jinit(pts, rgb, sh_degree=3, capacity=CAP, seed=0)
    ts = state_from_numpy(_numpy_state(js), device="cpu")
    cfg, jcfg = TrainConfig(), JConfig()
    jnew, jm = jbatched_step(
        js, jnp.asarray(c2w), jnp.full((d,), F), jnp.full((d,), F),
        jnp.full((d,), W / 2), jnp.full((d,), H / 2), jnp.asarray(gts), LR,
        H, W, 3, jcfg, True, renderer="tiled")
    tnew, tm = batched_train_step(
        ts, torch.from_numpy(c2w), [F] * d, [F] * d, [W / 2] * d,
        [H / 2] * d, torch.from_numpy(gts), LR, H, W, 3, cfg, True)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["psnr"]), float(jm["psnr"]),
                               rtol=1e-5)
    assert int(tm["n_visible"]) == int(jm["n_visible"])
    _assert_state_close(tnew, jnew, 2e-4, 5e-6,
                        ("means", "scales", "quats", "features_dc",
                         "opacities"))
    np.testing.assert_allclose(tnew.stats.xys_grad_norm.numpy(),
                               np.asarray(jnew.stats.xys_grad_norm),
                               rtol=2e-4, atol=1e-8)
    np.testing.assert_array_equal(tnew.stats.vis_counts.numpy(),
                                  np.asarray(jnew.stats.vis_counts))


def test_dp_stats_match_sequential_steps():
    """A D = 4 batch's stats, by accumulate_stats_batched and by
    _fold_stats_dp (one rank, d_local = 4), against four sequential
    accumulate_stats calls on the undivided gradients, through the
    post-refine and the accumulating fold; the split and duplicate masks
    from either are equal."""
    rng = np.random.default_rng(5)
    d = 4
    mesh = make_mesh()
    seq, bat, dp = (zero_stats(CAP, "cpu") for _ in range(3))
    for _ in range(2):
        g = torch.from_numpy(rng.normal(0, 2e-4, (d, CAP, 2))
                             .astype(np.float32))
        radii = torch.from_numpy((rng.integers(0, 3, (d, CAP))
                                  * rng.integers(1, 9, (d, CAP)))
                                 .astype(np.int32))
        for k in range(d):
            seq = accumulate_stats(seq, g[k], radii[k], H, W)
        bat = accumulate_stats_batched(bat, g / d, radii, H, W)
        dp = _fold_stats_dp(dp, g / d, radii, H, W, d, mesh)
        for got in (bat, dp):
            np.testing.assert_allclose(got.xys_grad_norm.numpy(),
                                       seq.xys_grad_norm.numpy(),
                                       rtol=1e-5, atol=1e-12)
            np.testing.assert_array_equal(got.vis_counts.numpy(),
                                          seq.vis_counts.numpy())
            np.testing.assert_allclose(got.max_2d_size.numpy(),
                                       seq.max_2d_size.numpy(), rtol=1e-6)
    pts, rgb, _, _ = _scene(1)
    st = init_model(pts, rgb, 1, capacity=CAP, device="cpu")
    st.params.scales[::2] = float(np.log(0.005))  # small ones duplicate
    cfg = TrainConfig()
    for use_ss in (False, True):
        want = _split_dup_masks(st.params, seq, st.alive, float(W), cfg,
                                use_ss)
        assert want[0].any() and want[1].any()
        for got in (bat, dp):
            masks = _split_dup_masks(st.params, got, st.alive, float(W), cfg,
                                     use_ss)
            for a, b in zip(masks, want):
                assert torch.equal(a, b)


def _dp_step_rank(data, out):
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from opensplat_tpu_torch.config import TrainConfig
    from opensplat_tpu_torch.models.gaussians import init_model
    from opensplat_tpu_torch.parallel.distributed import initialize_from_env
    from opensplat_tpu_torch.parallel.dp_trainer import dp_train_step
    from opensplat_tpu_torch.parallel.mesh import make_mesh

    assert initialize_from_env(device="cpu")
    d = np.load(data)
    h, w, f = int(d["h"]), int(d["w"]), float(d["f"])
    st = init_model(d["pts"], d["rgb"], 3, capacity=int(d["cap"]),
                    device="cpu")
    mesh = make_mesh(2, 1)
    r = mesh.index["data"]
    st, m = dp_train_step(
        st, torch.from_numpy(d["c2w"][r:r + 1]), [f], [f], [w / 2], [h / 2],
        torch.from_numpy(d["gts"][r:r + 1]), float(d["lr"]), mesh, h, w, 3,
        TrainConfig(), True)
    arrs = {f"p_{k}": v.numpy() for k, v in st.params.as_dict().items()}
    arrs.update(s_xys_grad_norm=st.stats.xys_grad_norm.numpy(),
                s_vis_counts=st.stats.vis_counts.numpy(),
                loss=float(m["loss"]), psnr=float(m["psnr"]),
                n_visible=int(m["n_visible"]), demand=m["demand"].numpy())
    np.savez(f"{out}/rank{dist.get_rank()}.npz", **arrs)


def test_dp_step_two_ranks_matches_batched_step(tmp_path):
    """dp_train_step on 2 gloo ranks (one camera each) against the
    in-process batched_train_step on both cameras: loss and psnr rtol
    1e-5, n_visible equal, params rtol 2e-4 atol 1e-5, xys_grad_norm rtol
    2e-4 atol 1e-8, vis_counts equal; the two ranks' replicas equal to
    the bit."""
    pts, rgb, c2w, gts = _scene(2)
    data = str(tmp_path / "in.npz")
    np.savez(data, pts=pts, rgb=rgb, c2w=c2w, gts=gts, cap=CAP, h=H, w=W,
             f=F, lr=LR)
    run_function(_dp_step_rank, 2, data, str(tmp_path), env=RANK_ENV,
                 timeout=120)
    r0, r1 = (np.load(tmp_path / f"rank{r}.npz") for r in (0, 1))
    for k in r0.files:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    st = init_model(pts, rgb, 3, capacity=CAP, device="cpu")
    ref, m = batched_train_step(
        st, torch.from_numpy(c2w), [F, F], [F, F], [W / 2] * 2, [H / 2] * 2,
        torch.from_numpy(gts), LR, H, W, 3, TrainConfig(), True)
    np.testing.assert_allclose(float(r0["loss"]), float(m["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(r0["psnr"]), float(m["psnr"]), rtol=1e-5)
    assert int(r0["n_visible"]) == int(m["n_visible"])
    assert list(r0["demand"]) == m["demand"].tolist()
    for k in PARAM_NAMES:
        np.testing.assert_allclose(r0[f"p_{k}"], getattr(ref.params, k),
                                   rtol=2e-4, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(r0["s_xys_grad_norm"],
                               ref.stats.xys_grad_norm.numpy(), rtol=2e-4,
                               atol=1e-8)
    np.testing.assert_array_equal(r0["s_vis_counts"],
                                  ref.stats.vis_counts.numpy())


def _trainer_scene():
    """4 cameras around 40 Gaussians, the ground truth rendered by the
    port; the model starts from the points jittered."""
    rng = np.random.default_rng(9)
    gt_pts = rng.uniform(-0.8, 0.8, (40, 3)).astype(np.float32)
    gt = init_model(gt_pts, rng.integers(0, 255, (40, 3)).astype(np.uint8),
                    1, capacity=64, device="cpu")
    c2w = np.stack([_look_at((4 * np.sin(a), 0.6, 4 * np.cos(a)))
                    for a in np.linspace(0, 2 * np.pi, 4, endpoint=False)])
    bg = torch.tensor(DEFAULT_BACKGROUND)
    with torch.no_grad():
        imgs = np.stack([render_forward(
            gt.params, gt.alive, torch.from_numpy(c), F, F, W / 2, H / 2, H,
            W, 1, bg, device="cpu").rgb.numpy() for c in c2w])
    pts = gt_pts + rng.normal(0, 0.05, gt_pts.shape).astype(np.float32)
    rgb = rng.integers(0, 255, (40, 3)).astype(np.uint8)
    return pts, rgb, c2w, imgs


# warm-up 2, refine every 5, reset interval 15 with 4 cameras: step 5
# resets alpha, step 10 densifies (10 > 4 + 5)
TRAINER_CFG = dict(num_iters=60, sh_degree=1, num_downscales=0,
                   warmup_length=2, refine_every=5, reset_alpha_every=3,
                   capacity_round=64)
TRAINER_STEPS = 11


def _dp_trainer_rank(data, out, steps, cfg_kw):
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from opensplat_tpu_torch.config import TrainConfig
    from opensplat_tpu_torch.data.dataset import Camera
    from opensplat_tpu_torch.models.gaussians import init_model
    from opensplat_tpu_torch.parallel.distributed import initialize_from_env
    from opensplat_tpu_torch.parallel.dp_trainer import DPTrainer

    initialize_from_env(device="cpu")
    d = np.load(data)
    h, w, f = int(d["h"]), int(d["w"]), float(d["f"])
    cams = []
    for c2w, img in zip(d["c2w"], d["imgs"]):
        cam = Camera(width=w, height=h, fx=f, fy=f, cx=w / 2, cy=h / 2,
                     cam_to_world=c2w)
        cam.set_image(img)
        cams.append(cam)
    cfg = TrainConfig(**cfg_kw)
    st = init_model(d["pts"], d["rgb"], 1, capacity=64, capacity_round=64,
                    device="cpu")
    st.params.scales[:d["ds"].shape[0]] += torch.from_numpy(d["ds"])
    tr = DPTrainer(st, cams, cfg, device="cpu")
    losses, alive, refines = [], {}, {}
    for step in range(1, steps + 1):
        losses.append(tr.run_step(step).loss)
        if tr.refine_metrics is not None:
            refines[step] = tr.refine_metrics
            tr.refine_metrics = None
        if step % cfg.refine_every == 0:
            alive[f"alive_{step}"] = tr.state.alive.numpy()
    arrs = {f"p_{k}": v.numpy() for k, v in tr.state.params.as_dict().items()}
    np.savez(f"{out}/rank{dist.get_rank()}.npz", losses=np.array(losses),
             refines=repr(refines), **arrs, **alive)


def _dp_trainer_matches(tmp_path, ds, steps):
    """DPTrainer on 2 gloo ranks against DPTrainer on one process with
    d_local = 2, `steps` steps from the same state: init_model's with
    ds added to the 40 live rows' log-scales. Returns the refines'
    metrics by step."""
    pts, rgb, c2w, imgs = _trainer_scene()
    data = str(tmp_path / "in.npz")
    np.savez(data, pts=pts, rgb=rgb, c2w=c2w, imgs=imgs, h=H, w=W, f=F, ds=ds)
    run_function(_dp_trainer_rank, 2, data, str(tmp_path), steps,
                 TRAINER_CFG, env=RANK_ENV, timeout=180)
    r0, r1 = (np.load(tmp_path / f"rank{r}.npz") for r in (0, 1))
    for k in r0.files:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)

    cams = []
    for c, img in zip(c2w, imgs):
        cam = Camera(width=W, height=H, fx=F, fy=F, cx=W / 2, cy=H / 2,
                     cam_to_world=c)
        cam.set_image(img)
        cams.append(cam)
    cfg = TrainConfig(**TRAINER_CFG)
    st = init_model(pts, rgb, 1, capacity=64, capacity_round=64, device="cpu")
    st.params.scales[:ds.shape[0]] += torch.from_numpy(ds)
    tr = DPTrainer(st, cams, cfg, d_local=2, device="cpu")
    assert tr.d_total == 2
    refines = {}
    for step in range(1, steps + 1):
        loss = tr.run_step(step).loss
        np.testing.assert_allclose(r0["losses"][step - 1], loss, rtol=5e-4)
        if tr.refine_metrics is not None:
            refines[step] = tr.refine_metrics
            tr.refine_metrics = None
        if step % cfg.refine_every == 0:
            np.testing.assert_array_equal(r0[f"alive_{step}"],
                                          tr.state.alive.numpy())
    assert repr(refines) == str(r0["refines"])
    for k in PARAM_NAMES:
        np.testing.assert_allclose(r0[f"p_{k}"], getattr(tr.state.params, k),
                                   rtol=5e-3, atol=5e-5, err_msg=k)
    assert np.isfinite(r0["losses"]).all()
    return refines


def test_dp_trainer_two_ranks_matches_one_rank(tmp_path):
    """From init_model's own isotropic start, as every training run
    begins: 9 steps through the step-5 alpha reset, up to the step-10
    densify. (With isotropic scales the quats' gradients are rounding
    noise, which Adam turns into steps of up to the learning rate, and
    the densify's split offsets carry that noise into the children's
    means; the two DP paths sum the views' gradients in different
    orders, so past the densify their means would agree only by rounding
    luck. The next test goes through it.)"""
    refines = _dp_trainer_matches(tmp_path, np.zeros((40, 3), np.float32),
                                  TRAINER_STEPS - 2)
    assert 5 in refines


def test_dp_trainer_two_ranks_matches_one_rank_through_densify(tmp_path):
    """11 steps through the step-5 alpha reset and the step-10 densify,
    from scales made anisotropic as in tests/test_torch_train_step.py, so
    that rotations carry real gradients."""
    ds = np.random.default_rng(1).uniform(-0.5, 0.5, (40, 3)
                                          ).astype(np.float32)
    refines = _dp_trainer_matches(tmp_path, ds, TRAINER_STEPS)
    assert refines[10]["n_splits"] + refines[10]["n_dups"] > 0


def test_run_ranks_stops_every_rank_on_a_failure_or_the_limit():
    """A rank that exits non-zero, or a time limit that passes, raises
    RankFailure naming the rank, and the ranks still running are killed
    (here they would sleep a minute)."""
    code = ("import os, sys, time\n"
            "if os.environ['OPENSPLAT_PROCESS_ID'] == '1': sys.exit(3)\n"
            "time.sleep(60)\n")
    t0 = time.monotonic()
    with pytest.raises(RankFailure, match="rank 1 of 2 exited with 3"):
        run_ranks([sys.executable, "-c", code], 2, env=RANK_ENV, timeout=50)
    with pytest.raises(RankFailure, match="ran past the 2 s limit"):
        run_ranks([sys.executable, "-c", "import time; time.sleep(60)"], 2,
                  env=RANK_ENV, timeout=2)
    assert time.monotonic() - t0 < 30


def _bootstrap_rank(out):
    import numpy as np
    import torch
    import torch.distributed as dist

    from opensplat_tpu_torch.parallel.distributed import (
        global_dp_mesh, initialize_from_env, process_camera_slice,
        rank_device)

    assert initialize_from_env(device="cpu")  # from the OPENSPLAT_* vars
    rank, world = dist.get_rank(), dist.get_world_size()
    assert world == 2 and dist.get_backend() == "gloo"
    assert rank_device("cpu") == torch.device("cpu")
    mesh = global_dp_mesh()
    assert mesh.shape == {"data": 2, "model": 1}
    assert mesh.index == {"data": rank, "model": 0}
    assert process_camera_slice(6, mesh) == (3 * rank, 3)
    x = torch.full((2,), float(rank + 1))
    np.testing.assert_array_equal(mesh.psum(x, "data"), [3.0, 3.0])
    np.testing.assert_array_equal(mesh.pmax(x, "data"), [2.0, 2.0])
    np.testing.assert_array_equal(mesh.all_gather(x, "data"),
                                  [1.0, 1.0, 2.0, 2.0])
    b = mesh.all_gather(torch.tensor([rank == 0, True]), "data")
    assert b.tolist() == [True, True, False, True]
    np.testing.assert_array_equal(mesh.broadcast(x), [1.0, 1.0])
    np.savez(f"{out}/rank{rank}.npz", rank=rank)


def test_initialize_from_env_two_processes(tmp_path, monkeypatch):
    """Two processes join from OPENSPLAT_COORDINATOR (a file:// store),
    OPENSPLAT_NUM_PROCESSES, OPENSPLAT_PROCESS_ID and OPENSPLAT_BACKEND
    and run every collective the port builds; without a coordinator
    there is no cluster and nothing starts."""
    run_function(_bootstrap_rank, 2, str(tmp_path), env=RANK_ENV, timeout=60)
    assert sorted(os.listdir(tmp_path)) == ["rank0.npz", "rank1.npz"]
    monkeypatch.delenv("OPENSPLAT_COORDINATOR", raising=False)
    assert initialize_from_env(device="cpu") is False
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="needs a process group"):
        make_mesh(2, 1)
