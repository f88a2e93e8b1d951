"""opensplat_tpu_torch's command-line trainer on the CPU (--cpu, the
kernels' plain versions), against the JAX CLI where they share a
contract: the end-to-end run on test_cli_e2e.py's synthetic project
(loss falls; scene, cameras.json, validation renders, the step-20
snapshot; the oracle check; PLY resume), runs with the conformance
renderers (--renderer dense|tiled), the parser's flags and defaults,
the parallel flags on gloo ranks, the camera sampler's fast-forward, the
Trainer resumed from a checkpoint across two densifying refines (the
counterpart of test_resume.py's exactness test: losses and parameters
rtol 1e-5, alive masks equal), --auto-resume, simple_trainer with each
renderer, the synthetic project's textured style (held to the JAX
tool's draws and to the JAX tiled renderer) and parity_report (held to
the JAX tool on the same scene)."""
import argparse
import importlib.util
import json
import os
import re
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from opensplat_tpu import cli as jcli
from opensplat_tpu.train import InfiniteRandomSampler as JSampler
from opensplat_tpu_torch import cli, simple_trainer
from opensplat_tpu_torch.config import TrainConfig
from opensplat_tpu_torch.data.dataset import Camera
from opensplat_tpu_torch.io import load_checkpoint, load_ply, save_checkpoint
from opensplat_tpu_torch.models.gaussians import PARAM_NAMES, init_model
from opensplat_tpu_torch.data.point_io import read_point_set
from opensplat_tpu_torch.data._image import imread_rgb
from opensplat_tpu_torch.models.splat_model import DEFAULT_BACKGROUND
from opensplat_tpu_torch.parallel.launch import run_ranks
from opensplat_tpu_torch.tools import make_synthetic_project, parity_report
from opensplat_tpu_torch.train import (InfiniteRandomSampler, Trainer,
                                       render_image)
from test_cli_e2e import synthetic_project  # noqa: F401 (module fixture)

# one intra-op thread per process: the suite runs one pytest-xdist
# worker per core, and a full torch thread pool in each of them
# oversubscribes the cores
torch.set_num_threads(1)


def _losses(metrics_file):
    return [r["loss"] for r in map(json.loads, open(metrics_file))
            if r["type"] == "step"]


def test_cli_end_to_end(synthetic_project, tmp_path, capsys):  # noqa: F811
    out = str(tmp_path / "out" / "scene.ply")
    val_dir = str(tmp_path / "val")
    mfile = str(tmp_path / "m.jsonl")
    assert cli.main([
        synthetic_project, "-o", out, "-n", "24", "--cpu",
        "--sh-degree", "1", "--num-downscales", "0",
        "--warmup-length", "500",  # no refine in this short run
        "--capacity", "256", "--val", "--val-render", val_dir,
        "--save-every", "20", "--oracle-check", "--metrics-file", mfile,
    ]) == 0
    text = capsys.readouterr().out
    assert text.startswith("Using CPU")
    oracle = [ln for ln in text.splitlines() if ln.startswith("oracle-check")]
    assert oracle and "OK" in oracle[0], oracle
    psnr_db = float(re.search(r"PSNR ([\d.]+) dB", oracle[0]).group(1))
    assert psnr_db >= 30.0
    assert re.search(r"validation loss: [\d.]+ \(PSNR [\d.]+ dB\)", text)
    losses = _losses(mfile)
    assert len(losses) == 24 and all(np.isfinite(losses))
    assert np.mean(losses[-6:]) < np.mean(losses[:6])  # the loss falls
    stem, ext = os.path.splitext(out)
    for p in (out, f"{stem}_20{ext}", os.path.join(val_dir, "10.png"),
              os.path.join(val_dir, "20.png")):
        assert os.path.exists(p), p
    # cameras.json: the JAX writer's bytes for the same project
    from opensplat_tpu.data.dataset import input_data_from_x

    ref = str(tmp_path / "ref_cameras.json")
    input_data_from_x(synthetic_project).save_cameras(ref, False)
    assert open(os.path.join(os.path.dirname(out), "cameras.json"),
                "rb").read() == open(ref, "rb").read()

    # resume from the saved intermediate scene (fresh moments, step 21)
    resumed = str(tmp_path / "out" / "resumed.ply")
    assert cli.main([
        synthetic_project, "-o", resumed, "-n", "22", "--cpu",
        "--sh-degree", "1", "--num-downscales", "0", "--capacity", "256",
        "--resume", f"{stem}_20{ext}",
    ]) == 0
    assert "at step 21" in capsys.readouterr().out
    state, step = load_ply(resumed, device="cpu")
    assert step == 22 and int(state.alive.sum()) > 0


def _options(parser):
    return {a.dest: a for a in parser._actions
            if not isinstance(a, (argparse._HelpAction,
                                  argparse._VersionAction))}


def test_parser_flags_and_defaults_match_jax():
    t, j = _options(cli.build_parser()), _options(jcli.build_parser())
    assert set(t) == set(j)
    for dest, ja in j.items():
        ta = t[dest]
        for attr in ("option_strings", "default", "type", "nargs", "const",
                     "metavar"):
            assert getattr(ta, attr) == getattr(ja, attr), (dest, attr)
        assert type(ta) is type(ja), dest
        if dest == "renderer":  # the port adds its own name for pallas
            assert ta.choices == list(ja.choices) + ["fast"]
        else:
            assert ta.choices == ja.choices, dest
    a = cli.build_parser().parse_args(["proj"])
    assert (a.output, a.num_iters, a.sh_degree, a.warmup_length,
            a.val_image) == ("splat.ply", 30000, 3, 500, "random")


@pytest.mark.parametrize("flags,ranks,message", [
    (["--distributed"], 1,
     "Distributed: no cluster detected, single-process run"),
    (["--distributed", "--data-parallel", "2"], 2,
     "Camera data-parallel training over 2 ranks"),
    (["--distributed", "--model-parallel", "-1"], 2,
     "Gaussian model-parallel training over 2 ranks"),
])
def test_parallel_flags_train(flags, ranks, message, synthetic_project,  # noqa: F811
                              tmp_path, capsys, monkeypatch):
    """The parallel flags on the CPU under gloo: --distributed without a
    cluster trains in one process, as the JAX CLI does; --data-parallel 2
    and --model-parallel -1 (all ranks; 48-row images, so the second
    band is padded) train on 2 ranks started by parallel/launch.py, and
    only rank 0 writes the scene and the metrics file."""
    out = tmp_path / "out" / "scene.ply"
    mfile = tmp_path / "m.jsonl"
    args = [synthetic_project, "-o", str(out), "-n", "4", "--cpu",
            "--sh-degree", "1", "--num-downscales", "0",
            "--metrics-file", str(mfile)] + flags
    if ranks == 1:
        monkeypatch.delenv("OPENSPLAT_COORDINATOR", raising=False)
        assert cli.main(args) == 0
        outs = [capsys.readouterr().out]
    else:
        outs = run_ranks([sys.executable, "-m", "opensplat_tpu_torch.cli"]
                         + args, ranks,
                         env=dict(os.environ, OMP_NUM_THREADS="1"),
                         timeout=150)
        for r, o in enumerate(outs):
            assert f"Distributed: process {r}/2 (gloo)" in o, o
        assert "Wrote" not in outs[1]
    assert message in outs[0], outs[0]
    assert f"Wrote {out}" in outs[0]
    losses = _losses(str(mfile))
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert int(load_ply(str(out), device="cpu")[0].alive.sum()) > 0


def test_sampler_fast_forward_replays_order():
    """fast_forward(n) == n next() calls across epoch reshuffles, in the
    JAX sampler's order."""
    a = InfiniteRandomSampler(5, seed=9)
    j = JSampler(5, seed=9)
    drawn = [a.next() for _ in range(13)]  # crosses two reshuffles
    assert drawn == [j.next() for _ in range(13)]
    b = InfiniteRandomSampler(5, seed=9)
    b.fast_forward(13)
    assert a.draws == b.draws == 13
    assert [a.next() for _ in range(7)] == [b.next() for _ in range(7)]


def _trainer_setup():
    """40 Gaussians rendered from 3 cameras at 32 px; training from
    jittered points densifies at steps 8 and 12 (refine every 4, stop
    split at 16, a low grad threshold), with capacity growth."""
    rng = np.random.default_rng(5)
    n = 40
    gt_pts = rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)
    gt = init_model(gt_pts, rng.integers(30, 225, (n, 3)).astype(np.uint8),
                    sh_degree=1, capacity=64, capacity_round=64, seed=7,
                    device="cpu")
    gt.params.scales[:n] = float(np.log(0.25))
    gt.params.opacities[:n] = 2.0
    cams = []
    for i in range(3):
        a = 2 * np.pi * i / 3
        eye = np.array([8.0 * np.sin(a), 0.5, 8.0 * np.cos(a)])
        f = -eye / np.linalg.norm(eye)
        r = np.cross(f, [0.0, 1.0, 0.0])
        r /= np.linalg.norm(r)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2] = r, np.cross(r, f), -f
        c2w[:3, 3] = eye
        cam = Camera(width=32, height=32, fx=40.0, fy=40.0, cx=16.0,
                     cy=16.0, cam_to_world=c2w, file_path=f"cam{i}.png")
        rgb, _, _ = render_image(gt.params, gt.alive, torch.from_numpy(c2w),
                                 40.0, 40.0, 16.0, 16.0, 32, 32, 1,
                                 device="cpu")
        cam.set_image(rgb.numpy())
        cams.append(cam)
    pts = gt_pts + rng.normal(0, 0.05, gt_pts.shape).astype(np.float32)
    rgb = rng.integers(0, 255, (n, 3)).astype(np.uint8)
    cfg = TrainConfig(num_iters=32, sh_degree=1, num_downscales=0,
                      warmup_length=2, refine_every=4, capacity_round=64,
                      densify_grad_thresh=1e-6)

    def fresh():
        return init_model(pts, rgb, sh_degree=1, capacity=64,
                          capacity_round=64, seed=3, device="cpu")

    return cams, cfg, fresh


def test_trainer_resume_exact_across_refine(tmp_path):
    """Kill-and-resume == uninterrupted: 16 steps in one go (densifying
    refines at 8 and 12, each drawing split noise); separately 10 steps,
    a checkpoint with the sampler's position, a new Trainer from it,
    steps 11..16. The resumed run must draw at step 12 the noise the
    uninterrupted run drew there, after its draw at step 8: split noise
    comes from (seed, step), so nothing else needs saving."""
    cams, cfg, fresh = _trainer_setup()
    ref = Trainer(fresh(), cams, cfg, device="cpu")
    ref_losses, ref_refines = {}, {}
    for step in range(1, 17):
        ref_losses[step] = ref.run_step(step).loss
        if ref.refine_metrics is not None:
            ref_refines[step] = ref.refine_metrics
            ref.refine_metrics = None
    assert [s for s, m in ref_refines.items() if m.get("n_splits")] == [8, 12]
    assert ref.state.alive.shape[0] > 64  # capacity grew

    a = Trainer(fresh(), cams, cfg, device="cpu")
    for step in range(1, 11):
        a.run_step(step)
    ckpt = str(tmp_path / "ckpt_10.npz")
    save_checkpoint(a.state, 10, ckpt, sampler_draws=a.sampler.draws,
                    seed=cfg.seed)
    del a  # the crash

    state, step0, draws = load_checkpoint(ckpt, device="cpu")
    assert (step0, draws) == (10, 10)
    b = Trainer(state, cams, cfg, device="cpu")
    b.sampler.fast_forward(draws)
    b_refines = {}
    for step in range(step0 + 1, 17):
        np.testing.assert_allclose(b.run_step(step).loss, ref_losses[step],
                                   rtol=1e-5, err_msg=f"step {step}")
        if b.refine_metrics is not None:
            b_refines[step] = b.refine_metrics
            b.refine_metrics = None
    assert b_refines == {s: m for s, m in ref_refines.items() if s > 10}
    np.testing.assert_array_equal(b.state.alive.numpy(),
                                  ref.state.alive.numpy())
    for name in PARAM_NAMES:
        np.testing.assert_allclose(
            getattr(b.state.params, name).numpy(),
            getattr(ref.state.params, name).numpy(), rtol=1e-5, atol=1e-7,
            err_msg=name)
        np.testing.assert_allclose(b.state.opt.mu[name].numpy(),
                                   ref.state.opt.mu[name].numpy(),
                                   rtol=1e-5, atol=1e-8, err_msg=name)
    assert b.state.opt.count == ref.state.opt.count


def test_cli_auto_resume(synthetic_project, tmp_path, capsys):  # noqa: F811
    """--checkpoint-every + --auto-resume: a 24-step run (densifying
    refines at 8 and 10) leaves ckpt_3..ckpt_24; with every checkpoint
    from 12 on removed (the crash), --auto-resume picks the newest left,
    ckpt_9, replays steps 10..24 (the densify at 10 and its noise) and
    writes the uninterrupted run's scene."""
    common = [synthetic_project, "--cpu", "-n", "24", "--sh-degree", "1",
              "--num-downscales", "0", "--capacity", "256",
              "--warmup-length", "1", "--refine-every", "2",
              "--densify-grad-thresh", "1e-6"]
    ckpt_dir = str(tmp_path / "ckpts")
    ref_out = str(tmp_path / "ref.ply")
    assert cli.main(common + ["-o", ref_out, "--checkpoint-every", "3",
                              "--ckpt-dir", ckpt_dir,
                              "--metrics-file",
                              str(tmp_path / "m.jsonl")]) == 0
    refines = [r for r in map(json.loads, open(tmp_path / "m.jsonl"))
               if r["type"] == "refine"]
    assert [r["step"] for r in refines if r.get("n_splits")] == [8, 10]
    for s in (12, 15, 18, 21, 24):
        os.remove(os.path.join(ckpt_dir, f"ckpt_{s}.npz"))
    capsys.readouterr()
    out = str(tmp_path / "resumed.ply")
    assert cli.main(common + ["-o", out, "--auto-resume",
                              "--ckpt-dir", ckpt_dir]) == 0
    assert f"Resuming from {os.path.join(ckpt_dir, 'ckpt_9.npz')} at " \
           "step 10" in capsys.readouterr().out
    a, _ = load_ply(ref_out, device="cpu")
    b, _ = load_ply(out, device="cpu")
    np.testing.assert_array_equal(a.alive.numpy(), b.alive.numpy())
    for name in PARAM_NAMES:
        np.testing.assert_allclose(
            getattr(b.params, name).numpy(), getattr(a.params, name).numpy(),
            rtol=1e-5, atol=1e-6, err_msg=name)


def test_simple_trainer_converges(tmp_path, capsys):
    render_dir = str(tmp_path / "renders")
    assert simple_trainer.main(["--cpu", "--iters", "30", "--points", "300",
                                "--width", "32", "--height", "32",
                                "--render", render_dir]) == 0
    text = capsys.readouterr().out
    first = float(re.search(r"Iteration 1/30 Loss: ([\d.]+)", text).group(1))
    final = float(re.search(r"Final loss: ([\d.]+)", text).group(1))
    assert np.isfinite(final) and final < 0.7 * first, (first, final)
    assert os.path.exists(os.path.join(render_dir, "30.png"))


def test_cli_report_and_control_channel(synthetic_project, tmp_path,  # noqa: F811
                                        capsys, monkeypatch):
    """--report-dir: a stale control.txt is cleared at startup (the run
    is not stopped by an old command); a `stop` written during the run
    stops it after that step, is removed once acted on, and the report,
    scene and cameras.json are still written. The --serve endpoint binds
    to 127.0.0.1 and writes the command it is POSTed."""
    import urllib.request

    from opensplat_tpu_torch import train as ttrain

    report = tmp_path / "report"
    report.mkdir()
    (report / "control.txt").write_text("stop")  # left by an old run
    run_step = ttrain.Trainer.run_step

    def stop_at_3(self, step):
        if step == 3:
            (report / "control.txt").write_text("stop")
        return run_step(self, step)

    monkeypatch.setattr(ttrain.Trainer, "run_step", stop_at_3)
    out = str(tmp_path / "scene.ply")
    assert cli.main([synthetic_project, "-o", out, "-n", "6", "--cpu",
                     "--sh-degree", "1", "--num-downscales", "0",
                     "--capacity", "256", "--val",
                     "--report-dir", str(report)]) == 0
    text = capsys.readouterr().out
    assert "Step 2:" in text and "Stop requested at step 3" in text
    assert "Step 4:" not in text
    assert not (report / "control.txt").exists()
    assert (report / "report.html").exists() and os.path.exists(out)
    assert load_ply(out, device="cpu")[1] == 6  # the scene names -n

    httpd = cli._start_server(str(report), 0)
    try:
        host, port = httpd.server_address[:2]
        assert host == "127.0.0.1"
        req = urllib.request.Request(f"http://127.0.0.1:{port}/__control__",
                                     data=b"pause", method="POST")
        with urllib.request.urlopen(req, timeout=10) as resp:
            assert resp.status == 200
        assert (report / "control.txt").read_text() == "pause"
    finally:
        httpd.shutdown()
        httpd.server_close()


@pytest.mark.parametrize("renderer", ["dense", "tiled"])
def test_cli_conformance_renderers(renderer, synthetic_project, tmp_path,  # noqa: F811
                                   capsys):
    """--renderer dense|tiled trains through the conformance renderers: a
    few steps at 32x24 px (-d 2), finite loss, the scene written; the
    first step's loss is the fast renderer's (the three renderers draw
    the same image)."""
    common = [synthetic_project, "--cpu", "-n", "4", "-d", "2",
              "--sh-degree", "1", "--num-downscales", "0",
              "--capacity", "256"]
    losses = {}
    for r in (renderer, "fast"):
        out = str(tmp_path / r / "scene.ply")
        mfile = str(tmp_path / f"{r}.jsonl")
        assert cli.main(common + ["-o", out, "--renderer", r,
                                  "--metrics-file", mfile]) == 0
        losses[r] = _losses(mfile)
        assert len(losses[r]) == 4 and np.all(np.isfinite(losses[r]))
        state, step = load_ply(out, device="cpu")
        assert step == 4 and int(state.alive.sum()) > 0
    np.testing.assert_allclose(losses[renderer][0], losses["fast"][0],
                               rtol=1e-4)


@pytest.mark.parametrize("renderer", ["tiled", "dense"])
def test_simple_trainer_renderers(renderer, capsys):
    """simple_trainer --renderer converges through each conformance
    renderer, from the fast renderer's first loss (same start)."""
    argv = ["--cpu", "--iters", "20", "--points", "300", "--width", "32",
            "--height", "32"]
    first = {}
    for r in (renderer, "fast"):
        assert simple_trainer.main(argv + ["--renderer", r]) == 0
        text = capsys.readouterr().out
        first[r] = float(re.search(r"Iteration 1/20 Loss: ([\d.]+)",
                                   text).group(1))
        final = float(re.search(r"Final loss: ([\d.]+)", text).group(1))
        assert np.isfinite(final) and final < 0.8 * first[r], (r, final)
    np.testing.assert_allclose(first[renderer], first["fast"], rtol=1e-4)


def _jax_tool(name):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(repo, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_textured_project_matches_jax(tmp_path, monkeypatch):
    """The textured style draws the JAX tool's scene from the same seed
    (its GaussianParams, caught at its render call; sparse.ply and the
    cameras), and its ground truth is the JAX tiled renderer's image of
    that scene over the port's training background (PNG rounding: one
    8-bit step)."""
    from opensplat_tpu.models import splat_model as jsm

    res, n = 32, 240
    jrender = jsm.render_forward
    caught = []

    def catch(params, alive, c2w, fx, fy, cx, cy, h, w, *a, **kw):
        caught.append((params, c2w, fx))
        return jsm.RenderOutputs(*([jnp.zeros((h, w, 3))]
                                   + [jnp.zeros(())] * 8))

    monkeypatch.setattr(jsm, "render_forward", catch)
    monkeypatch.setattr(sys, "argv", [
        "make_synthetic_project.py", str(tmp_path / "jax"), "--cams", "2",
        "--points", str(n), "--res", str(res), "--style", "textured"])
    _jax_tool("make_synthetic_project").main()
    make_synthetic_project.make_project(
        str(tmp_path / "port"), cams=2, points=n, res=res, style="textured",
        device="cpu", verbose=False)

    jt = json.load(open(tmp_path / "jax" / "transforms.json"))
    tt = json.load(open(tmp_path / "port" / "transforms.json"))
    assert jt == tt
    jp = read_point_set(str(tmp_path / "jax" / "sparse.ply"))
    tp = read_point_set(str(tmp_path / "port" / "sparse.ply"))
    np.testing.assert_array_equal(tp.points, jp.points)
    np.testing.assert_array_equal(tp.colors, jp.colors)

    means, _, log_scales, quats, opac = make_synthetic_project.textured_scene(
        np.random.default_rng(7), n)
    params, c2w, f = caught[0]
    for got, k in ((means, "means"), (log_scales, "scales"),
                   (quats, "quats"), (opac, "opacities")):
        np.testing.assert_allclose(got, np.asarray(getattr(params, k)),
                                   rtol=1e-6, atol=1e-7, err_msg=k)

    def render(params, c2w):
        return jrender(params, jnp.ones((n,), bool), c2w, f, f, res / 2.0,
                       res / 2.0, res, res, 0,
                       jnp.asarray(DEFAULT_BACKGROUND, jnp.float32),
                       renderer="tiled", isect_budget=4096).rgb

    want = np.clip(np.asarray(jax.jit(render)(params, jnp.asarray(c2w))),
                   0, 1) * 255
    got = imread_rgb(str(tmp_path / "port" / "images" / "r_000.png"))
    assert np.abs(got.astype(np.float32) - want).max() <= 1.0
    assert got.std() > 10  # the scene, not only the background


def test_parity_report_matches_jax(synthetic_project, tmp_path,  # noqa: F811
                                   monkeypatch):
    """parity_report trains a few steps and writes its .json and .md as
    the JAX tool writes them; evaluating the saved scene (--eval-scene),
    both tools report the same validation PSNR and both oracle checks
    pass."""
    monkeypatch.setenv("OPENSPLAT_TPU_CACHE", "0")  # no XLA disk cache
    out = str(tmp_path / "rep")
    assert parity_report.main([synthetic_project, "-n", "4", "--val-every",
                               "2", "--renderer", "tiled", "--cpu",
                               "--downscale-factor", "2", "--out",
                               out]) == 0
    rep = json.load(open(out + ".json"))
    assert (rep["backend"], rep["renderer"], rep["num_iters"]) == (
        "cpu", "tiled", 4)
    assert [r["step"] for r in rep["curve"]] == [2, 4]
    assert rep["oracle_check"]["ok"] and os.path.exists(rep["scene"])
    md = open(out + ".md").read().splitlines()
    assert md[0] == f"# Parity report — {os.path.basename(synthetic_project)}"
    assert md[4] == "| step | val PSNR (dB) | steps/s | loss | #gaussians |"

    evals = {}
    for name, main in (("jax", _jax_tool("parity_report").main),
                       ("port", parity_report.main)):
        stem = str(tmp_path / f"eval_{name}")
        assert main([synthetic_project, "--eval-scene", rep["scene"],
                     "--renderer", "tiled", "--cpu",
                     "--downscale-factor", "2", "--out", stem]) == 0
        evals[name] = json.load(open(stem + ".json"))
    j, t = evals["jax"], evals["port"]
    assert set(j) == set(t) and set(j["final"]) == set(t["final"])
    assert t["num_iters"] == j["num_iters"] == 4
    assert t["n_cameras"] == j["n_cameras"]
    assert t["final"]["n_gaussians"] == j["final"]["n_gaussians"]
    np.testing.assert_allclose(t["final"]["val_psnr"], j["final"]["val_psnr"],
                               atol=0.01)
    assert t["oracle_check"]["ok"] and j["oracle_check"]["ok"]
