"""opensplat_tpu_torch's metrics logger, profiler trace and training
report: the counterparts of test_metrics.py and test_report.py, with the
port's records held to the JAX package's on the same calls."""
import json

import numpy as np
import torch

from opensplat_tpu.utils.metrics import MetricsLogger as JMetricsLogger
from opensplat_tpu_torch.data._image import decode_png
from opensplat_tpu_torch.utils.metrics import (MetricsLogger, profile_trace,
                                               span, take_spans)
from opensplat_tpu_torch.utils.report import TrainingReport, _png_b64

# one intra-op thread per process: the suite runs one pytest-xdist
# worker per core, and a full torch thread pool in each of them
# oversubscribes the cores
torch.set_num_threads(1)

_TIMED = ("steps_per_sec", "mpix_per_sec")


def test_metrics_jsonl_matches_jax(tmp_path):
    """The same calls write the same records (the rates are wall-clock:
    positive, not compared)."""
    files = []
    for cls, name in ((MetricsLogger, "t"), (JMetricsLogger, "j")):
        p = str(tmp_path / name / "m.jsonl")  # the logger makes the dir
        m = cls(p, window=10)
        for s in range(1, 6):
            rec = m.step(s, loss=0.5 / s, psnr=20.0 + s, n_alive=100 + s,
                         height=64, width=64)
            assert rec["step"] == s
        m.tick(64, 64)
        m.refine(5, {"split": 3, "dup": 2, "cull": 1})
        m.close()
        files.append([json.loads(line) for line in open(p)])
    t, j = files
    assert len(t) == len(j) == 6
    assert t[-1] == {"type": "refine", "step": 5, "split": 3, "dup": 2,
                     "cull": 1}
    for a, b in zip(t, j):
        assert {k: v for k, v in a.items() if k not in _TIMED} == \
            {k: v for k, v in b.items() if k not in _TIMED}
    assert t[3]["steps_per_sec"] > 0 and t[3]["mpix_per_sec"] > 0


def test_metrics_no_sink():
    m = MetricsLogger("")
    rec = m.step(1, 0.1, 30.0, 10, 32, 32)
    assert rec["n_gaussians"] == 10
    m.close()


def test_profile_trace(tmp_path):
    with profile_trace(""):
        pass
    out = tmp_path / "prof"
    take_spans()
    with profile_trace(str(out)):
        with span("step.probe"):  # the tracer is on in the window
            torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((out / "trace.json").read_text())
    assert trace["traceEvents"]
    assert any(e.get("name") == "step.probe" for e in trace["traceEvents"])
    assert [s.name for s in take_spans()] == ["step.probe"]


def test_report_html_and_snapshot_cap(tmp_path):
    r = TrainingReport(str(tmp_path), max_snapshots=3)
    for s in range(10, 110, 10):
        r.log(s, loss=1.0 / s, psnr=15 + s / 20, n_gaussians=100 + s)
    img = np.random.default_rng(0).uniform(0, 1, (32, 32, 3))
    r.snapshot(50, img, img * 0.5)
    r.snapshot(100, img)
    content = open(r.write()).read()
    assert "polyline" in content  # curves rendered
    assert content.count("data:image/png;base64,") == 3  # 2 renders + 1 gt
    assert "PSNR" in content and "Gaussians" in content
    for s in range(4):
        r.snapshot(200 + s, img)
    assert [s["step"] for s in r.snapshots][0] == 50  # first kept
    assert len(r.snapshots) == 3 and r.snapshots[-1]["step"] == 203


def test_report_png_decodes():
    """The snapshots are PNGs of the port's own encoder."""
    import base64

    img = np.random.default_rng(1).uniform(0, 1, (8, 12, 3))
    png = base64.b64decode(_png_b64(img))
    np.testing.assert_array_equal(
        decode_png(png), (np.clip(img, 0, 1) * 255).astype(np.uint8))


def test_live_report_point_cloud_and_controls(tmp_path):
    rep = TrainingReport(str(tmp_path))
    rep.log(1, 0.5, 20.0, 100)
    rep.log(2, 0.4, 21.0, 100)
    rng = np.random.default_rng(0)
    rep.point_cloud(2, rng.normal(size=(500, 3)), rng.uniform(0, 1, (500, 3)))
    live = open(rep.write(live=True)).read()
    assert "http-equiv='refresh'" in live and "live" in live
    assert 'canvas id="pc"' in live
    assert "point cloud (step 2, 500 shown)" in live
    assert "__control__" in live and "Pause" in live and "Stop" in live
    static = open(rep.write()).read()
    assert "http-equiv='refresh'" not in static
    assert 'canvas id="pc"' in static and "__control__" not in static
    rep.point_cloud(3, rng.normal(size=(50000, 3)),
                    rng.uniform(0, 1, (50000, 3)), max_points=1000)
    assert rep._cloud["n"] == 1000
