"""The port bench's parallel modes on the CPU, as rank processes.

`python -m opensplat_tpu_torch.bench` with BENCH_CPU=1 at 512 Gaussians,
64 px and BENCH_ITERS=2 starts its ranks through parallel/launch.py
(gloo, one torch thread each). Each mode must print exactly one line,
rank 0's, with the mode's metric name and a finite rate whose
gaussians_per_sec is the rate times the model's alive count (512; the
multi-scene modes: a scene's), to the lines' rounding. Without a card
and without BENCH_CPU the bench exits non-zero and prints no line."""
import json
import math
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, H = 512, 64


def _bench(**env):
    e = dict(os.environ, OMP_NUM_THREADS="1", BENCH_POINTS=str(N),
             BENCH_RES=str(H), BENCH_ITERS="2", **env)
    for k in ("BENCH_CPU", "BENCH_DP", "BENCH_MP", "BENCH_SCENES",
              "BENCH_SCENES_SHARDED", "OPENSPLAT_COORDINATOR"):
        if k not in env:
            e.pop(k, None)
    return subprocess.run([sys.executable, "-m", "opensplat_tpu_torch.bench"],
                          cwd=REPO, env=e, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("env,metric,ranks", [
    ({"BENCH_DP": "2"}, f"dp_train_steps_per_sec[fast,{N}g,{H}px,dp2]", 2),
    ({"BENCH_MP": "2"}, f"mp_train_steps_per_sec[fast,{N}g,{H}px,mp2]", 2),
    ({"BENCH_DP": "2", "BENCH_MP": "2"},
     f"hybrid_train_steps_per_sec[fast,{N}g,{H}px,dp2xmp2]", 4),
    ({"BENCH_SCENES": "2", "BENCH_SCENES_SHARDED": "1"},
     f"scene_steps_per_sec[fast,{N}g,{H}px,s2-sharded]", 2),
    ({"BENCH_SCENES": "2"}, f"scene_steps_per_sec[fast,{N}g,{H}px,s2-loop]",
     0),
], ids=["dp", "mp", "hybrid", "scenes-sharded", "scenes-loop"])
def test_parallel_mode_prints_one_line(env, metric, ranks):
    out = _bench(BENCH_CPU="1", **env)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = [json.loads(ln) for ln in out.stdout.splitlines()
             if ln.startswith("{")]
    assert len(lines) == 1, out.stdout
    rec = lines[0]
    assert rec["metric"] == metric
    assert rec["device"] == {"platform": "cpu"}
    assert rec["vs_baseline"] is None
    if ranks:
        assert f"{ranks} ranks, gloo, CPU" in rec["unit"]
    v = rec["value"]
    assert math.isfinite(v) and v > 0
    # value is rounded to 1e-3, gaussians_per_sec to 1e-1
    assert abs(rec["gaussians_per_sec"] - v * N) <= 5e-4 * N + 0.05 + 1e-9


def test_no_card_exits_nonzero():
    out = _bench()
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
    assert "{" not in out.stdout
