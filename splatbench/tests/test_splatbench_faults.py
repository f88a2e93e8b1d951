"""A whole run on the CPU at a tiny size (the look for a card skipped,
the kernels' plain versions in their place), sound and with the timed
path broken underneath: `correct` has to come out true, then false for
each fault a one-card training cell can have: a step that leaves its
state unchanged, half of the batch (the image's rows) left out of the
loss with the mean taken over the rest, and the step's answer (the
rendered image) altered where it is produced. Each for the mix of one
scene a step (`steady`, Trainer) and for the cells' mix of four scenes
in one batched step (`scenes4`, MultiSceneTrainer)."""
import time

import pytest
import torch

import opensplat_tpu_torch.train as train_mod
from splatbench import harness


MIXES = ("steady", "scenes4")


def _tiny_cell(mix):
    cell = harness.load_cell("lego.scenes4")
    cell.traffic = harness.load_traffic(mix)
    sc = cell.config["scene"]
    w = h = 48
    sc["fx"] *= w / sc["width"]
    sc["fy"] *= h / sc["height"]
    sc["cx"], sc["cy"] = w / 2, h / 2
    sc["width"], sc["height"] = w, h
    sc["n_gaussians"] = 4000
    sc["cameras"]["count"] = 6
    return cell


def _run(cell):
    return harness.run(cell, 2**31 + 12345, 0.5, False, torch.device("cpu"),
                       time.perf_counter())


def _half_batch(full):
    def loss(rendered, gt, w):
        h = gt.shape[-3] // 2
        return full(rendered[..., :h, :, :], gt[..., :h, :, :], w)
    return loss


def _altered(render):
    def forward(*args, **kwargs):
        out = render(*args, **kwargs)
        return out._replace(rgb=out.rgb * 1.02)
    return forward


FAULTS = {
    "state_unchanged": ("adam_update", lambda f: lambda *a, **k: None),
    "half_batch": ("main_loss", _half_batch),
    "image_altered": ("render_forward", _altered),
}


@pytest.mark.parametrize("mix", MIXES)
def test_sound_run_is_correct(mix):
    cell = _tiny_cell(mix)
    out = _run(cell)
    assert out["correct"], out["checks"]
    scenes = cell.traffic["scenes"]
    assert list(out)[-1] == "checks" and out["attempted"] >= scenes
    assert out["attempted"] % scenes == 0


@pytest.mark.parametrize("mix", MIXES)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_caught(fault, mix, monkeypatch):
    name, make = FAULTS[fault]
    monkeypatch.setattr(train_mod, name, make(getattr(train_mod, name)))
    out = _run(_tiny_cell(mix))
    assert not out["correct"], out["checks"]
