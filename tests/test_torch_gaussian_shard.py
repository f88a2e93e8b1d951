"""Gaussian-sharded rendering and training (opensplat_tpu_torch.parallel.
gaussian_shard) on gloo ranks on the CPU.

band_height against the JAX package's; the bands (render_forward's
row_offset, padded and cropped) against the whole frame, bitwise. On 2
ranks (one model shard each): gs_render against the port's single-
process render (bitwise) and against the JAX gs_render on a 2-device
CPU mesh (rtol 1e-5 atol 1e-5, tests/test_gaussian_shard.py:57-59);
gs_train_step
against train_step_impl (loss rtol 1e-5, n_visible and vis_counts equal,
params rtol 2e-4 atol 1e-5, xys_grad_norm rtol 2e-4 atol 1e-8,
tests/test_gaussian_shard.py:90-103); the two differentiable gathers
against single-process autograd of the same computation; GSTrainer
against Trainer for 11 steps through a refine that grows capacity (loss
rtol 5e-4 a step, capacity, alive masks and refine metrics equal, the
alive rows' final params rtol 5e-3 atol 5e-5). On 4 ranks (2 x 2):
dpgs_train_step against the single-process camera-DP step
(batched_train_step) at tests/test_gaussian_shard.py:178-195's
tolerances. 64x64 px, 300 Gaussians; ranks are processes with one torch
thread and a time limit."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from opensplat_tpu.models.gaussians import init_model as jinit
from opensplat_tpu.parallel.gaussian_shard import band_height as jband_height
from opensplat_tpu.parallel.gaussian_shard import gs_render as jgs_render
from opensplat_tpu.parallel.gaussian_shard import shard_state as jshard
from opensplat_tpu.parallel.mesh import make_mesh as jmake_mesh
from opensplat_tpu_torch.config import TrainConfig
from opensplat_tpu_torch.data.dataset import Camera
from opensplat_tpu_torch.models.gaussians import PARAM_NAMES, init_model
from opensplat_tpu_torch.models.splat_model import (DEFAULT_BACKGROUND,
                                                    render_forward)
from opensplat_tpu_torch.parallel.gaussian_shard import band_height
from opensplat_tpu_torch.parallel.sharded_train import batched_train_step
from opensplat_tpu_torch.train import Trainer, render_image, train_step_impl
from test_torch_parallel import (CAP, F, H, LR, TRAINER_CFG, TRAINER_STEPS,
                                 W, _scene,
                                 RANK_ENV, _trainer_scene, run_function)

# one intra-op thread per process, ranks included (RANK_ENV)
torch.set_num_threads(1)


@pytest.mark.parametrize("height,n_model", [(64, 1), (64, 2), (64, 4),
                                            (50, 2), (250, 3), (512, 8)])
def test_band_height_matches_jax(height, n_model):
    bh = band_height(height, n_model)
    assert bh == jband_height(height, n_model)
    assert bh % 16 == 0 and bh * n_model >= height


@pytest.mark.parametrize("height,n_model", [(64, 2), (50, 2), (48, 3)])
def test_bands_reassemble_the_frame_bitwise(height, n_model):
    """The bands gs_render draws (render_forward with row_offset, the
    canvas padded to n_model * band_height rows and cropped) equal the
    whole frame's render bit for bit."""
    pts, rgb, c2w, _ = _scene(1)
    st = init_model(pts, rgb, 3, capacity=CAP, device="cpu")
    bg = torch.tensor(DEFAULT_BACKGROUND)
    c = torch.from_numpy(c2w[0])
    bh = band_height(height, n_model)
    with torch.no_grad():
        bands = [render_forward(st.params, st.alive, c, F, F, W / 2,
                                height / 2, bh, W, 3, bg, device="cpu",
                                fov_height=height, row_offset=m * bh).rgb
                 for m in range(n_model)]
        whole = render_forward(st.params, st.alive, c, F, F, W / 2,
                               height / 2, height, W, 3, bg,
                               device="cpu").rgb
    assert torch.equal(torch.cat(bands)[:height], whole)


def _mp_rank(data, out):
    """gs_render, one gs_train_step and the two gathers on 2 ranks."""
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from opensplat_tpu_torch.config import TrainConfig
    from opensplat_tpu_torch.models.gaussians import init_model
    from opensplat_tpu_torch.parallel.distributed import initialize_from_env
    from opensplat_tpu_torch.parallel.gaussian_shard import (
        gs_render, gs_train_step, shard_state, unshard_state)
    from opensplat_tpu_torch.parallel.mesh import (
        all_gather_replicated, all_gather_rows, make_mesh)

    initialize_from_env(device="cpu")
    d = np.load(data)
    h, w, f = int(d["h"]), int(d["w"]), float(d["f"])
    mesh = make_mesh(1, 2)
    m = mesh.index["model"]
    st = shard_state(mesh, init_model(d["pts"], d["rgb"], 3,
                                      capacity=int(d["cap"]), device="cpu"))
    c2w = torch.from_numpy(d["c2w"][0])
    rgb, v, _ = gs_render(st, c2w, f, f, w / 2, h / 2, mesh, h, w, 3)
    st, met = gs_train_step(st, c2w, f, f, w / 2, h / 2,
                            torch.from_numpy(d["gts"][0]), float(d["lr"]),
                            mesh, h, w, 3, TrainConfig(), True)
    full = unshard_state(mesh, st)

    gen = torch.Generator().manual_seed(0)
    x_all = torch.randn((6, 4), generator=gen)
    w_all = torch.randn((2, 5, 6), generator=gen)
    c = torch.randn((10, 4), generator=gen)
    x = x_all[3 * m:3 * m + 3].clone().requires_grad_(True)
    y = all_gather_rows(x, mesh, "model")  # a different consumer per rank
    z = all_gather_replicated(w_all[m] @ y, mesh, "model")
    g, = torch.autograd.grad((z * z * c).sum(), x)

    arrs = {f"p_{k}": v_.numpy() for k, v_ in full.params.as_dict().items()}
    np.savez(f"{out}/rank{dist.get_rank()}.npz", rgb=rgb.numpy(), v=v,
             loss=float(met["loss"]), n_visible=int(met["n_visible"]),
             n_alive=int(met["n_alive"]), demand=met["demand"].numpy(),
             xys_grad_norm=full.stats.xys_grad_norm.numpy(),
             vis_counts=full.stats.vis_counts.numpy(), grad=g.numpy(),
             **arrs)


@pytest.fixture(scope="module")
def mp_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mp")
    pts, rgb, c2w, gts = _scene(1)
    np.savez(tmp / "in.npz", pts=pts, rgb=rgb, c2w=c2w, gts=gts, cap=CAP,
             h=H, w=W, f=F, lr=LR)
    run_function(_mp_rank, 2, str(tmp / "in.npz"), str(tmp), env=RANK_ENV,
                 timeout=120)
    return [np.load(tmp / f"rank{r}.npz") for r in (0, 1)], (pts, rgb, c2w,
                                                              gts)


def test_gs_render_matches_single_render_and_jax(mp_run):
    """The bands reassembled equal the single render bit for bit (the
    port's bands are the frame's rows, render_forward's row_offset), and
    the JAX gs_render (tiled) within rtol 1e-5 atol 1e-5."""
    (r0, r1), (pts, rgb, c2w, _) = mp_run
    np.testing.assert_array_equal(r0["rgb"], r1["rgb"])
    st = init_model(pts, rgb, 3, capacity=CAP, device="cpu")
    want, _, _ = render_image(st.params, st.alive, torch.from_numpy(c2w[0]),
                              F, F, W / 2, H / 2, H, W, 3, device="cpu")
    np.testing.assert_array_equal(r0["rgb"], want.numpy())
    assert 0 < int(r0["v"]) <= CAP // 2
    js = jinit(pts, rgb, sh_degree=3, capacity=CAP, seed=0)
    np.testing.assert_array_equal(  # the same initial model
        np.asarray(js.params.means), st.params.means.numpy())
    mesh = jmake_mesh(n_data=1, n_model=2, devices=jax.devices()[:2])
    jrgb, jv, _ = jgs_render(jshard(mesh, js), jnp.asarray(c2w[0]), F, F,
                             W / 2, H / 2, mesh, H, W, 3, v_budget=CAP // 2,
                             renderer="tiled")
    assert int(jv) == int(r0["v"])
    np.testing.assert_allclose(r0["rgb"], np.asarray(jrgb), rtol=1e-5,
                               atol=1e-5)


def test_gs_train_step_matches_train_step(mp_run):
    (r0, r1), (pts, rgb, c2w, gts) = mp_run
    for k in set(r0.files) - {"grad"}:  # the model is the same on both
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    st = init_model(pts, rgb, 3, capacity=CAP, device="cpu")
    ref, m = train_step_impl(st, torch.from_numpy(c2w[0]), F, F, W / 2, H / 2,
                             torch.from_numpy(gts[0]), LR, H, W, 3,
                             TrainConfig(), True)
    np.testing.assert_allclose(float(r0["loss"]), float(m["loss"]), rtol=1e-5)
    assert int(r0["n_visible"]) == int(m["n_visible"])
    assert int(r0["n_alive"]) == int(m["n_alive"])
    # demand is the largest band's: inside the whole frame's
    assert 0 < r0["demand"][0] <= int(m["n_cands"])
    assert 0 < r0["demand"][1] <= int(m["n_isects"])
    for k in PARAM_NAMES:
        np.testing.assert_allclose(r0[f"p_{k}"], getattr(ref.params, k),
                                   rtol=2e-4, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(r0["xys_grad_norm"],
                               ref.stats.xys_grad_norm.numpy(), rtol=2e-4,
                               atol=1e-8)
    np.testing.assert_array_equal(r0["vis_counts"],
                                  ref.stats.vis_counts.numpy())


def test_gather_backward_matches_single_process_autograd(mp_run):
    """Rank m's rows x_m are gathered (backward: reduce-scatter), feed
    rank m's own consumer W_m @ X, whose outputs are gathered again for a
    loss every rank computes alike (backward: own rows): each rank's
    gradient equals its rows of d loss / dX with X = [x_0; x_1] and the
    consumers stacked, in one process."""
    (r0, r1), _ = mp_run
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((6, 4), generator=gen).requires_grad_(True)
    w_all = torch.randn((2, 5, 6), generator=gen)
    c = torch.randn((10, 4), generator=gen)
    z = torch.cat([w_all[0] @ x, w_all[1] @ x])
    g, = torch.autograd.grad((z * z * c).sum(), x)
    np.testing.assert_allclose(r0["grad"], g[:3].numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(r1["grad"], g[3:].numpy(), rtol=1e-5,
                               atol=1e-6)


def _hybrid_rank(data, out):
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from opensplat_tpu_torch.config import TrainConfig
    from opensplat_tpu_torch.models.gaussians import init_model
    from opensplat_tpu_torch.parallel.distributed import initialize_from_env
    from opensplat_tpu_torch.parallel.gaussian_shard import (
        dpgs_train_step, shard_state, unshard_state)
    from opensplat_tpu_torch.parallel.mesh import make_mesh

    initialize_from_env(device="cpu")
    d = np.load(data)
    h, w, f = int(d["h"]), int(d["w"]), float(d["f"])
    mesh = make_mesh(2, 2)
    r = mesh.index["data"]
    st = shard_state(mesh, init_model(d["pts"], d["rgb"], 3,
                                      capacity=int(d["cap"]), device="cpu"))
    st, met = dpgs_train_step(st, torch.from_numpy(d["c2w"][r]), f, f,
                              w / 2, h / 2, torch.from_numpy(d["gts"][r]),
                              float(d["lr"]), mesh, h, w, 3, TrainConfig(),
                              True)
    full = unshard_state(mesh, st)
    arrs = {f"p_{k}": v.numpy() for k, v in full.params.as_dict().items()}
    arrs.update({f"s_{k}": getattr(full.stats, k).numpy() for k in
                 ("xys_grad_norm", "vis_counts", "max_2d_size")})
    np.savez(f"{out}/rank{dist.get_rank()}.npz", loss=float(met["loss"]),
             psnr=float(met["psnr"]), demand=met["demand"].numpy(),
             n_alive=int(met["n_alive"]), **arrs)


def test_hybrid_2x2_matches_camera_dp(tmp_path):
    """dpgs_train_step on a 2 x 2 (data, model) grid of ranks, one camera
    per data row, against batched_train_step on both cameras in one
    process (the camera-DP step, itself held to dp_train_step): loss
    rtol 1e-5, all six parameter groups rtol 2e-4 atol 1e-5, the densify
    statistics rtol 1e-4 atol 1e-6; every rank holds the same model."""
    pts, rgb, c2w, gts = _scene(2)
    data = str(tmp_path / "in.npz")
    np.savez(data, pts=pts, rgb=rgb, c2w=c2w, gts=gts, cap=CAP, h=H, w=W,
             f=F, lr=LR)
    run_function(_hybrid_rank, 4, data, str(tmp_path), env=RANK_ENV,
                 timeout=150)
    rs = [np.load(tmp_path / f"rank{r}.npz") for r in range(4)]
    for r in rs[1:]:
        for k in rs[0].files:
            np.testing.assert_array_equal(rs[0][k], r[k], err_msg=k)
    r0 = rs[0]
    st = init_model(pts, rgb, 3, capacity=CAP, device="cpu")
    ref, m = batched_train_step(
        st, torch.from_numpy(c2w), [F, F], [F, F], [W / 2] * 2, [H / 2] * 2,
        torch.from_numpy(gts), LR, H, W, 3, TrainConfig(), True)
    np.testing.assert_allclose(float(r0["loss"]), float(m["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(r0["psnr"]), float(m["psnr"]), rtol=1e-5)
    assert int(r0["demand"][3]) > 0  # the visible-row count flows
    assert int(r0["n_alive"]) == int(m["n_alive"])
    for k in PARAM_NAMES:
        np.testing.assert_allclose(r0[f"p_{k}"], getattr(ref.params, k),
                                   rtol=2e-4, atol=1e-5, err_msg=k)
    for k in ("xys_grad_norm", "vis_counts", "max_2d_size"):
        np.testing.assert_allclose(r0[f"s_{k}"], getattr(ref.stats, k),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def _gs_trainer_rank(data, out, steps, cfg_kw):
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from opensplat_tpu_torch.config import TrainConfig
    from opensplat_tpu_torch.data.dataset import Camera
    from opensplat_tpu_torch.models.gaussians import init_model
    from opensplat_tpu_torch.parallel.distributed import initialize_from_env
    from opensplat_tpu_torch.parallel.gaussian_shard import GSTrainer

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
    st = init_model(d["pts"], d["rgb"], 1, capacity=40,
                    capacity_round=cfg.capacity_round, device="cpu")
    tr = GSTrainer(st, cams, cfg, n_model=2, device="cpu")
    losses, alive, refines = [], {}, {}
    for step in range(1, steps + 1):
        losses.append(tr.run_step(step).loss)
        if tr.refine_metrics is not None:
            refines[step] = tr.refine_metrics
            tr.refine_metrics = None
        if step % cfg.refine_every == 0:
            alive[f"alive_{step}"] = tr.full_state().alive.numpy()
    full = tr.full_state()
    rgb = tr.render(cams[0], steps)
    arrs = {f"p_{k}": v.numpy() for k, v in full.params.as_dict().items()}
    np.savez(f"{out}/rank{dist.get_rank()}.npz", losses=np.array(losses),
             refines=repr(refines), rgb=rgb.numpy(), **arrs, **alive)


def test_gs_trainer_two_ranks_through_capacity_growth(tmp_path):
    """GSTrainer on 2 ranks against Trainer, from 40 Gaussians at capacity
    40 (no free slot), so the step-10 densify grows capacity (in
    multiples of lcm(8, 2)); 11 steps through the step-5 alpha reset."""
    pts, rgb, c2w, imgs = _trainer_scene()
    data = str(tmp_path / "in.npz")
    np.savez(data, pts=pts, rgb=rgb, c2w=c2w, imgs=imgs, h=H, w=W, f=F)
    cfg_kw = dict(TRAINER_CFG, capacity_round=8)
    steps = TRAINER_STEPS
    run_function(_gs_trainer_rank, 2, data, str(tmp_path), steps, cfg_kw,
                 env=RANK_ENV, timeout=180)
    r0, r1 = (np.load(tmp_path / f"rank{r}.npz") for r in (0, 1))
    for k in r0.files:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)

    cams = []
    for c, img in zip(c2w, imgs):
        cam = Camera(width=W, height=H, fx=F, fy=F, cx=W / 2, cy=H / 2,
                     cam_to_world=c)
        cam.set_image(img)
        cams.append(cam)
    cfg = TrainConfig(**cfg_kw)
    tr = Trainer(init_model(pts, rgb, 1, capacity=40, capacity_round=8,
                            device="cpu"), cams, cfg, device="cpu")
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
    assert tr.state.alive.shape[0] > 40  # the densify grew capacity
    # the model is the alive rows: a culled split child keeps the value
    # it was written with, its parent's (within tolerance) plus an offset
    # scaled by the parent's exp(scale), so dead rows may differ more
    live = tr.state.alive.numpy()
    for k in PARAM_NAMES:
        np.testing.assert_allclose(r0[f"p_{k}"][live],
                                   getattr(tr.state.params, k)[live],
                                   rtol=5e-3, atol=5e-5, err_msg=k)
    np.testing.assert_allclose(r0["rgb"], tr.render(cams[0], steps).numpy(),
                               atol=4e-3)
