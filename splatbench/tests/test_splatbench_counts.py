"""The yardstick against hand counts on tiny cases: the work the plain
forward finds, the operations and bytes, and the trace's union."""
import json
import math

import pytest
import torch

from splatbench.reference.render import Camera, render
from splatbench.yardstick import counts
from splatbench.yardstick.peaks import peaks_for
from splatbench.yardstick import trace


def _camera(size=16):
    c2w = torch.eye(4)
    c2w[2, 3] = 5.0  # at z = 5 looking down -z at the origin
    return Camera(c2w, 50.0, 50.0, size / 2, size / 2, size, size)


def _params(n, opacity, scale=0.5):
    means = torch.zeros((n, 3))
    means[:, 2] = -0.01 * torch.arange(n)  # distinct depths, front first
    return {
        "means": means,
        "scales": torch.full((n, 3), math.log(scale)),
        "quats": torch.tensor([[1.0, 0.0, 0.0, 0.0]]).repeat(n, 1),
        "features_dc": torch.zeros((n, 3)),
        "features_rest": torch.zeros((n, 15, 3)),
        "opacities": torch.full((n, 1), math.log(opacity / (1 - opacity))),
    }


def _work(n, opacity):
    cam = _camera()
    with torch.no_grad():
        _, raster, _ = render(_params(n, opacity), torch.ones(n, dtype=bool),
                              cam, torch.zeros(3), count_work=True)
    return raster.work


def test_no_stop_every_pixel_every_record():
    # wide faint Gaussians: every pixel of the one tile needs both, none
    # stops
    w = _work(2, 0.05)
    assert w == {"pairs": 2 * 256, "replay": 2, "n_tiles": 1, "visible": 2}


def test_stop_counts_records_before_it():
    # opacity 0.99 near the centre: T after k records is 0.01^k..., so
    # the central pixels stop at the third record (T would fall to 1e-6
    # <= 1e-4) and count two; the corners, where alpha is lower, go on
    w = _work(3, 0.99)
    assert w["visible"] == 3 and w["replay"] == 3
    assert 2 * 256 <= w["pairs"] < 3 * 256


def test_step_ops_and_raster_bytes():
    work = {"visible": 10, "pairs": 1000, "replay": 40, "n_tiles": 4,
            "height": 32, "width": 32, "alive": 12, "params_per_gaussian": 59}
    assert counts.step_ops(work) == (
        10 * (630 + 213) + 1000 * 65 + 1024 * 3 * (404 + 5) + 12 * 59 * 15)
    rw = counts.raster_work(work)
    common = 10 * 36 + 40 * 4 + 4 * 8 + 4 * 256 * 4
    assert rw["raster_fwd"] == (common + 1024 * 16, 1000 * 20)
    assert rw["raster_bwd"] == (common + 1024 * 20 + 40 * 36, 1000 * 45)
    assert counts.bound_seconds(3.35e12, 0.0, (3.35e12, 67e12)) == 1.0
    assert counts.bound_seconds(0.0, 134e12, (3.35e12, 67e12)) == 2.0


def test_peaks_by_name():
    assert peaks_for("NVIDIA H100 80GB HBM3") == (3.35e12, 67e12)
    assert peaks_for("NVIDIA H100 PCIe") == (2.0e12, 51.2e12)
    assert peaks_for("NVIDIA A100") is None


def _marker(t):
    return ("void at::cuda::(anonymous namespace)::spin_kernel(long)", t,
            t + 1.0)


def test_trace_union_gaps_and_steps():
    ops = [_marker(-1.0),
           ("void raster_fwd_kernel<1>(int)", 0.0, 10.0),
           ("gemm", 5.0, 15.0),
           _marker(16.0),
           ("raster_fwd_kernel(int)", 20.0, 30.0),
           ("Memcpy DtoH (Device -> Pageable)", 38.0, 39.5),
           _marker(40.0)]
    tr = trace.from_device_ops(ops)
    assert tr.window == (0.0, 40.0) and len(tr.ops) == 4 and tr.steps == 2
    assert [o.step for o in tr.ops] == [0, 0, 1, 1]
    assert tr.busy_intervals() == [(0.0, 15.0), (20.0, 30.0), (38.0, 39.5)]
    assert tr.busy_s() == pytest.approx(26.5e-6)
    assert tr.window_s == pytest.approx(40e-6)
    # each gap named by the operations on either side of it
    assert dict(tr.idle_by_neighbours()) == pytest.approx({
        "gemm -> raster_fwd_kernel": 5e-6,
        "raster_fwd_kernel -> Memcpy DtoH": 8e-6,
        "Memcpy DtoH -> window": 0.5e-6})
    assert tr.kernel_seconds("raster_fwd_kernel", 1) == [pytest.approx(1e-5)]
    assert tr.kernel_seconds("raster_fwd_kernel", 0) == [pytest.approx(1e-5)]
    assert tr.device_by_stem()[0] == ("raster_fwd_kernel", pytest.approx(2e-5))


def test_trace_from_chrome_json(tmp_path):
    events = [{"ph": "X", "cat": "kernel", "name": n, "ts": s, "dur": e - s}
              for n, s, e in (_marker(0.0), ("k", 2.0, 5.0), _marker(7.0))]
    events.append({"ph": "X", "cat": "cuda_runtime",
                   "name": "cudaLaunchKernel", "ts": 1.0, "dur": 50.0})
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    tr = trace.load_trace(str(path))
    assert tr.window == (1.0, 7.0) and [o.name for o in tr.ops] == ["k"]
    assert tr.busy_s() == pytest.approx(3e-6)
    with pytest.raises(RuntimeError, match="markers"):
        trace.from_device_ops([_marker(0.0), ("k", 2.0, 5.0)])


def test_idle_share_over_the_untraced_step():
    from types import SimpleNamespace

    from splatbench import harness
    tr = trace.from_device_ops([_marker(-1.0), ("k", 0.0, 6.0), _marker(16.0),
                                ("k", 20.0, 26.0), _marker(40.0)])
    # 6 us busy a traced step against an untraced mean step of 10 us
    ctx = SimpleNamespace(on_card=True, trace=tr,
                          window=SimpleNamespace(step_ms=[0.008, 0.012]))
    read = harness.load_reader("device.idle_share")
    assert read(ctx) == pytest.approx(40.0)
    assert read(SimpleNamespace(on_card=False, trace=tr,
                                window=ctx.window)) is None


def test_grad_gap_leaves_out_the_largest_reference_rows():
    from splatbench import correctness
    n = correctness.TRIM + 4
    rows = torch.arange(n, 0, -1, dtype=torch.float32)[:, None]
    ref = {k: rows.repeat(1, 3) for k in correctness.PARAMS}
    ref["quats"][0] = 100.0  # one row holds most of the group's norm
    prog = {k: v.clone() for k, v in ref.items()}
    prog["quats"][0] *= 1.01  # noise on that row alone
    trimmed = correctness.trimmed_norms(prog, ref)
    assert trimmed == pytest.approx(correctness.trimmed_norms(ref, ref),
                                    rel=1e-9)
    # the rows left are the four smallest, 4, 3, 2 and 1
    assert trimmed["quats"] == pytest.approx(math.sqrt(3 * 30))
    prog["quats"][-1] *= 2.0  # a row outside the largest: seen
    assert correctness.trimmed_norms(prog, ref)["quats"] > trimmed["quats"]
