"""The port's one-view training step (Trainer.run_step, the kernels'
plain versions) against the benchmark's plain float32 reference
(splatbench/reference/) on tiny scenes shaped as the one-view cells'
configurations, cut to 2048 Gaussians seen at 48 x 32 px by 6 cameras
(fx and fy scaled alike), with rows put in each camera's clip slab
(camera depth about 0 and +-0.005) and, in the drone orbit, rows behind
every camera:

- `garden.steady` (`mipnerf360-garden`): the ground disc, central sphere
  and background shell around the camera orbit;
- `aerial.steady` (`odm-orbit-p4pro`): the site and the surrounding
  ground, one building, the oblique orbit 50 m up (3:2 frames, as the
  camera's 5472 x 3648).

Three checked steps from step 15,001, compared by
splatbench/correctness.py's gaps, as the benchmark decides `correct`."""
import math

import pytest
import torch

from splatbench import correctness, harness

# one intra-op thread per process: the suite runs one pytest-xdist
# worker per core
torch.set_num_threads(1)

SEED = 2**31 + 16
# Each tolerance is the cell's own limit (limits/<cell>.json), set on the
# card between the sound seeds' largest reading and the smallest of the
# reference computed with TF32 matrix products (10-bit mantissas, the
# precision below the configuration's float32) and of the program with
# half of the image left out of its loss (PERF.md). Here float32 with the
# sums in another order reads more than 100 times below each. The CPU
# has no TF32, so the controls run on the card only.
TOLERANCE = {
    # garden: 16 sound seeds, 3 control seeds
    "garden.steady": {
        # relative gap of a step's loss: sound 2.3e-7, TF32 9.9e-3 and up
        "loss_gap": 1e-4,
        # dB: sound 1.9e-6, half batch 0.029 and up, TF32 0.067 and up
        "psnr_gap": 2e-4,
        # the first gradient, worst group, 16 rows left out: sound
        # 9.2e-6, TF32 2.0e-3 and up
        "grad_gap": 3e-4,
        # the 3 steps' change, worst group: sound 9.1e-7, TF32 4.8e-4
        # and up
        "change_gap": 5e-5,
    },
    # aerial: 16 sound seeds, 3 control seeds at 5472 x 3648
    "aerial.steady": {
        # relative gap of a step's loss: sound 5.3e-6, TF32 3.6e-2 and up
        "loss_gap": 1e-4,
        # dB: sound 5.2e-5, half batch 5.6e-4 and up, TF32 0.38 and up
        "psnr_gap": 2e-4,
        # the first gradient, worst group, 16 rows left out: sound
        # 6.3e-6, TF32 2.0e-2 and up
        "grad_gap": 3e-4,
        # the 3 steps' change, worst group: sound 1.4e-6, TF32 2.3e-3
        # and up
        "change_gap": 5e-5,
    },
}
# camera depths of the rows put in each camera's clip slab, then, in the
# orbit, of a row behind it
DEPTHS = {
    "garden.steady": (0.0, 0.005, -0.005),
    "aerial.steady": (0.0, 0.005, -0.005, -5.0),
}


def _cell(name):
    cell = harness.load_cell(name)
    sc = cell.config["scene"]
    w, h = 48, 32
    sc["fx"] *= w / sc["width"]
    sc["fy"] *= h / sc["height"]
    sc["cx"], sc["cy"] = w / 2, h / 2
    sc["width"], sc["height"] = w, h
    sc["n_gaussians"] = 2048
    sc["cameras"]["count"] = 6
    return cell


def _with_rows_at(make, scene, depths):
    """make_params with, for each camera, a row at each camera depth of
    `depths`, beside its axis; the rows are the last ones (after the
    Morton order: any rows would do)."""
    poses = harness.camera_poses(scene)

    def made(sc, seed, device):
        params = make(sc, seed, device)
        row = params["means"].shape[0]
        for pose in poses:
            c2w = torch.from_numpy(pose).to(device)
            for i, depth in enumerate(depths):
                row -= 1
                # OpenGL axes: the camera looks down -z; right is x
                params["means"][row] = (c2w[:3, 3]
                                        + (0.5 + i) * c2w[:3, 0]
                                        - depth * c2w[:3, 2])
        return params
    return made


@pytest.mark.parametrize("name", list(TOLERANCE), ids=lambda n: n.split(".")[0])
def test_step_agrees_with_the_reference(name, monkeypatch):
    cell = _cell(name)
    monkeypatch.setattr(harness, "make_params",
                        _with_rows_at(harness.make_params,
                                      cell.config["scene"], DEPTHS[name]))
    dev = torch.device("cpu")
    job = harness.build(cell, SEED, dev, harness.program())
    readings, views, after = harness.checked_steps(
        job, int(cell.traffic["first_step"]),
        int(cell.traffic["checked_steps"]))
    job.trainer = None
    harness.program_changes(cell, job, dev, readings, after)
    ref = correctness.reference_readings(
        harness.reference_scenes(cell, job, dev, views),
        cell.config["train"])
    gaps = correctness.compare(readings, ref)
    for k, tol in TOLERANCE[name].items():
        assert math.isfinite(gaps[k]) and gaps[k] <= tol, (k, gaps)
    assert all(math.isfinite(v) for n in readings.change_norms
               for v in n.values())
