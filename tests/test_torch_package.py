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
from opensplat_tpu_torch.config import TrainConfig
from opensplat_tpu_torch.models.gaussians import init_model
from opensplat_tpu_torch.models.splat_model import (DEFAULT_BACKGROUND,
                                                    render_forward)
from opensplat_tpu_torch.ops.kernels import (_lib, expand, raster,
                                             raster_variants, segsum)
from opensplat_tpu_torch.ops.kernels.integration import rasterize_fast
from opensplat_tpu_torch.tools import kbench_raster
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


def test_no_jax_imports():
    """A fresh interpreter (this one already holds JAX) imports every
    port module and chip_smoke, then finds no jax / opensplat_tpu."""
    mods = _modules()
    assert len(mods) >= 20
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'opensplat_tpu' or m.startswith('opensplat_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean', len(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


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


@pytest.mark.parametrize("call", [_call_init_model, _call_trainer,
                                  _call_train_step, _call_render_forward,
                                  _call_rasterize_fast, _call_render_image,
                                  _call_kbench])
def test_entry_points_default_to_cuda(no_cuda, call):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


def test_renderers_of_later_slices_raise():
    st = _tiny_state()[2]
    for r in ("dense", "tiled"):
        with pytest.raises(NotImplementedError, match="later slice"):
            render_forward(st.params, st.alive, torch.eye(4), 50.0, 50.0,
                           16.0, 16.0, 32, 32, 0,
                           torch.tensor(DEFAULT_BACKGROUND), renderer=r,
                           device="cpu")


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
    for script in (os.path.join(REPO, "chip_smoke.py"), str(lone)):
        out = subprocess.run([sys.executable, script], cwd=tmp_path,
                             env=_clean_env(), capture_output=True,
                             text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
