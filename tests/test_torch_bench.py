"""The port's bench (opensplat_tpu_torch/bench.py) and step profiler on
the CPU, in process.

Against the JAX package's bench.py: the scene's draws (its
bench.py:395-403, redrawn here with numpy in its order), `_derived`, and
one and then two bench steps against JAX train_step with the float32
tiled renderer from the same initial state (the JAX init_model's,
carried across by state_from_numpy): loss rel 1e-3, n_alive and n_cands
equal (n_isects differs by design: the port's stream is culled). The
sweep's line format on a test-sized sweep, and profile_step's CPU table.
2048 Gaussians at 64 px; the profiler at 256 Gaussians, 32 px (the plain
rasterizer issues ~10^5 CPU ops a step at 64 px, and the trace's
summary costs seconds per 10^5 events)."""
import json
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bench as jbench
from opensplat_tpu.config import TrainConfig as JConfig
from opensplat_tpu.models.gaussians import init_model as jinit
from opensplat_tpu.optim.adam import means_lr_schedule as jlr
from opensplat_tpu.train import train_step as jstep
from opensplat_tpu_torch import bench
from opensplat_tpu_torch.models.gaussians import (PARAM_NAMES,
                                                  state_from_numpy)
from opensplat_tpu_torch.tools import profile_step, profiling

# one intra-op thread per process: the suite runs one pytest-xdist
# worker per core
torch.set_num_threads(1)

N, H = 2048, 64
CPU = torch.device("cpu")
KEYS = {"metric", "value", "unit", "vs_baseline", "mpix_per_sec",
        "rays_per_sec", "gaussians_per_sec", "device"}


def test_bench_scene_draws_bench_py():
    sc = bench.bench_scene(N, H)
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1.5, 1.5, (N, 3)).astype(np.float32)
    rgb = rng.integers(0, 255, (N, 3)).astype(np.uint8)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = np.array([0.0, 0.0, 6.0])
    gt = rng.uniform(0, 1, (H, H, 3)).astype(np.float32)
    for got, want in ((sc.pts, pts), (sc.rgb, rgb), (sc.gt, gt),
                      (sc.c2w, c2w)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert (sc.fx, sc.fy, sc.cx, sc.cy) == (0.9 * H, 0.9 * H, H / 2.0,
                                            H / 2.0)


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


def test_bench_steps_match_jax():
    sc = bench.bench_scene(N, H)
    js = jinit(sc.pts, sc.rgb, sh_degree=3, capacity=N, seed=0)
    _, step = bench.single_step(N, H, "fast", CPU)
    ts = state_from_numpy(_numpy_state(js), device="cpu")
    cfg = JConfig(num_iters=30000, capacity_round=N)
    args = dict(cam_to_world=jnp.asarray(sc.c2w), fx=sc.fx, fy=sc.fy,
                cx=sc.cx, cy=sc.cy, gt_image=jnp.asarray(sc.gt),
                means_lr=jlr(cfg.lr_means, cfg.lr_means_final, cfg.num_iters,
                             0),
                height=H, width=H, sh_deg=3, cfg=cfg, accumulate=True,
                renderer="tiled")
    for _ in range(2):
        js, jm = jstep(js, **args)
        ts, tm = step(ts)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-3)
        for k in ("n_alive", "n_cands"):
            assert int(tm[k]) == int(jm[k]), k


@pytest.mark.parametrize("args", [(12.5, 512, 512, 131072, 1),
                                  (3.25, 1080, 1080, 1048576, 2),
                                  (0.123, 64, 64, 511, 4)])
def test_derived_matches_bench_py(args):
    *rest, cams = args
    assert bench._derived(*rest, cams_per_step=cams) == \
        jbench._derived(*rest, cams_per_step=cams)


def _lines(out):
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def test_sweep_lines(capsys):
    sweep = ((256, 32), (512, 32))
    head = bench.run_sweep("fast", CPU, 1, sweep=sweep, headline=(256, 32))
    lines = _lines(capsys.readouterr().out)
    assert len(lines) == len(sweep) + 1
    assert lines[-1] == head
    for rec, (n, h) in zip(lines, sweep + ((256, 32),)):
        assert set(rec) - {"sweep"} == KEYS
        assert rec["metric"] == f"train_steps_per_sec[fast,{n}g,{h}px]"
        assert math.isfinite(rec["value"]) and rec["value"] > 0
        assert rec["vs_baseline"] is None
        assert rec["device"] == {"platform": "cpu"}
    assert "sweep" not in lines[0] and "sweep" not in lines[1]
    assert lines[-1]["sweep"] == lines[:2]


def test_renderer_names(monkeypatch):
    for name, want in (("fast", "fast"), ("pallas", "fast"),
                       ("auto", "fast"), ("tiled", "tiled"),
                       ("dense", "dense")):
        monkeypatch.setenv("BENCH_RENDERER", name)
        assert bench.bench_renderer() == want
    monkeypatch.setenv("BENCH_RENDERER", "nope")
    with pytest.raises(ValueError, match="BENCH_RENDERER"):
        bench.bench_renderer()


@pytest.mark.parametrize("name,want", [
    ("void (anonymous namespace)::expand_kernel<true>(int, int const*)",
     "expand_kernel"),
    ("(anonymous namespace)::raster_fwd_kernel(int const*, int const*)",
     "raster_fwd_kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "FillFunctor<float>>(int, float*)",
     "at::native::vectorized_elementwise_kernel"),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x32x8",
     "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x32x8"),
    ("aten::mul", "aten::mul")])
def test_kernel_name_stems(name, want):
    assert profiling.stem(name) == want


def test_by_stem_sums_instances():
    rows = [("void k<1>(int)", 2.0, 3), ("void k<2>(int)", 1.0, 1),
            ("aten::add", 0.5, 2)]
    assert profiling.by_stem(rows) == [("k", 7.0, 4), ("aten::add", 1.0, 2)]
    assert len(profiling.by_stem(rows, full_names=True)) == 3


def test_profile_step_cpu_table(capsys, monkeypatch, tmp_path):
    monkeypatch.setenv("BENCH_CPU", "1")
    out = profile_step.anatomy(256, 32, "fast", bench.bench_device(),
                               str(tmp_path), n_steps=1)
    text = capsys.readouterr().out
    assert "CPU op time" in text and "device time" not in text
    assert "CPU ops by CPU op time" in text
    assert out["stems"] and out["busy_ms"] > 0 and out["ssim_ms"] > 0
    assert len(out["wall_ms"]) == len(out["profiled_wall_ms"]) == 1
    assert (tmp_path / "trace.json").is_file()
