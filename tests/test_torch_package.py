"""Package rules of opensplat_tpu_torch, checked on the CPU: it imports
neither JAX nor the JAX package, its entry points default to CUDA and
refuse to run without it, its kernel wrappers take their plain versions
only for CPU tensors (counting no launch), and chip_smoke.py fails
without a card."""
import os
import pkgutil
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import opensplat_tpu_torch
from opensplat_tpu_torch import (bench, cli, io, multi_scene_cli,
                                 simple_trainer)
from opensplat_tpu_torch.config import TrainConfig
from opensplat_tpu_torch.models.gaussians import init_model
from opensplat_tpu_torch.models.splat_model import (DEFAULT_BACKGROUND,
                                                    render_depth,
                                                    render_forward)
from opensplat_tpu_torch.ops.kernels import (_lib, expand, raster,
                                             raster_variants, segsum)
from opensplat_tpu_torch.ops.kernels.integration import rasterize_fast
from opensplat_tpu_torch.parallel.distributed import initialize_from_env
from opensplat_tpu_torch.parallel.dp_trainer import DPTrainer
from opensplat_tpu_torch.parallel.gaussian_shard import GSTrainer
from opensplat_tpu_torch.tools import (kbench_raster, make_synthetic_project,
                                       parity_report, profile_step)
from opensplat_tpu_torch.train import Trainer, render_image, train_step

# one intra-op thread per process: the suite runs one pytest-xdist
# worker per core, and a full torch thread pool in each of them
# oversubscribes the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _modules():
    names = [opensplat_tpu_torch.__name__]
    for m in pkgutil.walk_packages(opensplat_tpu_torch.__path__,
                                   opensplat_tpu_torch.__name__ + "."):
        names.append(m.name)
    return names


def _clean_env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


# the JAX package, JAX, and the JAX package's bench.py at the repository
# root (opensplat_tpu_torch.bench is the port's own)
_NO_JAX = (
    "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
    " or m == 'opensplat_tpu' or m.startswith('opensplat_tpu.')"
    " or m == 'bench']\n"
    "assert not bad, bad\n"
)


def test_no_jax_imports():
    """A fresh interpreter (this one already holds JAX) imports every
    port module and chip_smoke, then finds no jax / opensplat_tpu."""
    mods = _modules()
    assert len(mods) >= 46
    for m in ("cli", "simple_trainer", "data.dataset", "data._image",
              "data.colmap", "data.nerfstudio", "data.opensfm",
              "data.openmvg", "data.point_io", "native.loader",
              "io.scene_io", "oracle.np_oracle", "oracle.scene_check",
              "utils.metrics", "utils.report",
              "tools.make_synthetic_project", "tools.parity_report",
              "gsplat_compat", "ops.rasterize", "ops.rasterize_tiled",
              "multi_scene_cli", "parallel", "parallel.mesh",
              "parallel.distributed", "parallel.launch",
              "parallel.sharded_train", "parallel.dp_trainer",
              "parallel.gaussian_shard", "parallel.multi_scene", "bench",
              "tools.profile_step", "tools.profiling"):
        assert f"opensplat_tpu_torch.{m}" in mods, m
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        + _NO_JAX + "print('clean', len(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


def test_cli_help_loads_no_jax():
    """`python -m opensplat_tpu_torch.cli --help` in a fresh interpreter
    prints the usage and loads neither jax nor opensplat_tpu."""
    code = (
        "import runpy, sys\n"
        "sys.argv = ['opensplat_tpu_torch.cli', '--help']\n"
        "try:\n"
        "    runpy.run_module('opensplat_tpu_torch.cli', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        + _NO_JAX
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "--oracle-check" in out.stdout and "--auto-resume" in out.stdout


def _tiny_state(device="cpu"):
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (40, 3)).astype(np.float32)
    rgb = rng.integers(0, 255, (40, 3)).astype(np.uint8)
    return pts, rgb, init_model(pts, rgb, 1, capacity=64, device=device)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _call_init_model():
    pts, rgb, _ = _tiny_state()
    init_model(pts, rgb, 1, capacity=64)


def _call_trainer():
    Trainer(_tiny_state()[2], [], TrainConfig())


def _call_train_step():
    train_step(_tiny_state()[2])


def _call_render_forward():
    st = _tiny_state()[2]
    render_forward(st.params, st.alive, torch.eye(4), 50.0, 50.0, 16.0, 16.0,
                   32, 32, 0, torch.tensor(DEFAULT_BACKGROUND))


def _call_render_depth():
    st = _tiny_state()[2]
    render_depth(st.params, st.alive, torch.eye(4), 50.0, 50.0, 16.0, 16.0,
                 32, 32)


def _call_parity_report():
    parity_report.main([REPO, "-n", "1"])


def _call_rasterize_fast():
    z = torch.zeros((4,))
    rasterize_fast(torch.zeros((4, 2)), torch.zeros((4, 3)),
                   torch.zeros((4, 3)), z, z, z.int(), z.int(),
                   torch.zeros((4, 2), dtype=torch.int32),
                   torch.zeros((4, 2), dtype=torch.int32),
                   torch.zeros((3,)), 16, 16)


def _call_render_image():
    st = _tiny_state()[2]
    render_image(st.params, st.alive, torch.eye(4), 50.0, 50.0, 16.0, 16.0,
                 32, 32, 0)


def _call_kbench():
    kbench_raster.main(["--tiles", "2", "--per-tile", "10", "--tb-x", "2",
                        "--iters", "1"])


def _call_cli():
    cli.main([REPO])


def _call_multi_scene_cli():
    multi_scene_cli.main([REPO])


def _call_dp_trainer():
    DPTrainer(_tiny_state()[2], [], TrainConfig())


def _call_gs_trainer():
    GSTrainer(_tiny_state()[2], [], TrainConfig())


def _call_initialize_from_env():
    initialize_from_env("file:///nonexistent/store", 1, 0)


def _call_simple_trainer():
    simple_trainer.main(["--iters", "1", "--points", "10"])


def _call_make_synthetic_project():
    make_synthetic_project.make_project("unused", cams=1, points=10, res=16)


def _call_load_ply():
    io.load_ply("unused.ply")


def _call_load_checkpoint():
    io.load_checkpoint("unused.npz")


def _call_bench():
    bench.main()


def _call_profile_step():
    profile_step.main()


@pytest.mark.parametrize("call", [_call_init_model, _call_trainer,
                                  _call_train_step, _call_render_forward,
                                  _call_render_depth, _call_rasterize_fast,
                                  _call_render_image, _call_parity_report,
                                  _call_kbench, _call_cli,
                                  _call_multi_scene_cli, _call_dp_trainer,
                                  _call_gs_trainer,
                                  _call_initialize_from_env,
                                  _call_simple_trainer,
                                  _call_make_synthetic_project,
                                  _call_load_ply, _call_load_checkpoint,
                                  _call_bench, _call_profile_step])
def test_entry_points_default_to_cuda(no_cuda, monkeypatch, call):
    monkeypatch.delenv("BENCH_CPU", raising=False)  # the bench's CPU switch
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


def test_cpu_tensors_take_the_plain_versions():
    """Each wrapper, given CPU tensors, returns its plain version's result
    and counts no launch."""
    wrappers = (expand.expand, raster.rasterize_forward,
                raster.rasterize_backward, segsum.segment_sum)
    before = [w.launches for w in wrappers]
    rng = np.random.default_rng(0)
    c, h, w = 30, 24, 40
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    xys = t(rng.uniform(0, 40, (c, 2)).astype(np.float32))
    conics = t(np.tile([0.1, 0.01, 0.1], (c, 1)).astype(np.float32))
    cnt = t(np.full(c, 2, np.int32))
    starts = torch.cumsum(cnt.long(), 0) - cnt.long()
    tmin = t(np.zeros((c, 2), np.int32))
    tmax = t(np.tile([2, 1], (c, 1)).astype(np.int32))
    depths = t(rng.uniform(1, 5, c).astype(np.float32))
    s_max = t(np.full(c, 3.0, np.float32))
    e_args = (cnt, starts, 2 * c, tmin, tmax, depths, xys, conics, s_max, 3, 6)
    for a, b in zip(expand.expand(*e_args), expand.expand_plain(*e_args)):
        assert torch.equal(a, b)
    full = e_args[:8] + (None,) + e_args[9:]  # no cull: every row kept
    for a, b in zip(expand.expand(*full), expand.expand_plain(*full)):
        assert torch.equal(a, b)
    assert torch.equal(expand.expand(*full)[2], cnt)
    keys, gids, _ = expand.expand(*e_args)
    order = torch.sort(keys, stable=True).indices
    gauss_ids = gids[order].contiguous()
    edges = torch.searchsorted(keys[order],
                               torch.arange(7, dtype=torch.int64) << 32)
    ts, te = edges[:-1].int(), edges[1:].int()
    opac = t(rng.uniform(0.2, 0.9, c).astype(np.float32))
    col = t(rng.uniform(0, 1, (c, 3)).astype(np.float32))
    bg = torch.tensor(DEFAULT_BACKGROUND)
    f_args = (gauss_ids, ts, te, xys, conics, opac, col, bg, h, w)
    fk = raster.rasterize_forward(*f_args)
    for a, b in zip(fk, raster.rasterize_forward_plain(*f_args)):
        assert torch.equal(a, b)
    b_args = f_args[:8] + (fk[1], fk[2], torch.ones((h, w, 3)),
                           torch.ones((h, w)), order.int(), h, w)
    g = raster.rasterize_backward(*b_args)
    assert torch.equal(g, raster.rasterize_backward_plain(*b_args))
    s_args = (g, starts, cnt)
    assert torch.equal(segsum.segment_sum(*s_args),
                       segsum.segment_sum_plain(*s_args))
    assert [w.launches for w in wrappers] == before


def test_cpu_tensors_take_the_plain_variants():
    """The ablation bench's wrapper, given CPU tensors, returns its plain
    version's result for every variant and counts no launch."""
    before = raster_variants.rasterize_variant.launches
    st = kbench_raster.make_stream(2, 300, 2, device="cpu")
    args = kbench_raster.variant_args(st)
    for name in raster_variants.VARIANTS:
        for a, b in zip(raster_variants.rasterize_variant(name, *args),
                        raster_variants.rasterize_variant_plain(name, *args)):
            assert torch.equal(a, b), name
    assert raster_variants.rasterize_variant.launches == before


def test_kernel_check_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        _lib.check(torch.zeros(3), "x", torch.float32, (3,))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _lib._nvcc()


def test_source_hash_covers_every_source():
    for name in _lib.SOURCES + _lib.HEADERS:
        assert (_lib.CSRC / name).is_file(), name
    assert len(_lib._source_hash()) == 16


def test_chip_smoke_fails_without_cuda(tmp_path):
    """Without a card, and alone in a directory, chip_smoke.py exits
    non-zero and prints no result."""
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), lone)
    # both runs at once: each spends its seconds starting Python
    procs = [subprocess.Popen([sys.executable, script], cwd=tmp_path,
                              env=_clean_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for script in (os.path.join(REPO, "chip_smoke.py"), str(lone))]
    for p in procs:
        stdout, _ = p.communicate(timeout=300)
        assert p.returncode != 0
        assert '"ok"' not in stdout
