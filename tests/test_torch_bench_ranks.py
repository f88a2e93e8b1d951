"""The port bench's parallel modes on the CPU, as rank processes.

`python -m opensplat_tpu_torch.bench` with BENCH_CPU=1 at 512 Gaussians,
64 px and BENCH_ITERS=2 starts its ranks through parallel/launch.py
(gloo, one torch thread each). Each mode must print exactly one line,
rank 0's, with the mode's metric name and a finite rate whose
gaussians_per_sec is the rate times the model's alive count (512; the
multi-scene modes: a scene's), to the lines' rounding. Without a card
and without BENCH_CPU the bench exits non-zero and prints no line.
The five modes' runs and the run without a card start together (a
module fixture) and each test reads its own: a run spends most of its
seconds starting Python and its ranks, and those overlap."""
import json
import math
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, H = 512, 64


def _env(**env):
    e = dict(os.environ, OMP_NUM_THREADS="1", BENCH_POINTS=str(N),
             BENCH_RES=str(H), BENCH_ITERS="2", **env)
    for k in ("BENCH_CPU", "BENCH_DP", "BENCH_MP", "BENCH_SCENES",
              "BENCH_SCENES_SHARDED", "OPENSPLAT_COORDINATOR"):
        if k not in env:
            e.pop(k, None)
    return e


# mode: (environment, metric, ranks)
MODES = {
    "dp": ({"BENCH_DP": "2"}, f"dp_train_steps_per_sec[fast,{N}g,{H}px,dp2]",
           2),
    "mp": ({"BENCH_MP": "2"}, f"mp_train_steps_per_sec[fast,{N}g,{H}px,mp2]",
           2),
    "hybrid": ({"BENCH_DP": "2", "BENCH_MP": "2"},
               f"hybrid_train_steps_per_sec[fast,{N}g,{H}px,dp2xmp2]", 4),
    "scenes-sharded": ({"BENCH_SCENES": "2", "BENCH_SCENES_SHARDED": "1"},
                       f"scene_steps_per_sec[fast,{N}g,{H}px,s2-sharded]",
                       2),
    # one process, one batched step for both scenes (the JAX s2-vmap)
    "scenes-loop": ({"BENCH_SCENES": "2"},
                    f"scene_steps_per_sec[fast,{N}g,{H}px,s2-vmap]", 0),
}


@pytest.fixture(scope="module")
def mode_runs():
    """Every mode's (returncode, stdout, stderr) under BENCH_CPU=1, and
    a run without it ("no-card"); the runs start at once."""
    envs = {mode: dict(env, BENCH_CPU="1")
            for mode, (env, _, _) in MODES.items()}
    envs["no-card"] = {}
    procs = {
        mode: subprocess.Popen(
            [sys.executable, "-m", "opensplat_tpu_torch.bench"], cwd=REPO,
            env=_env(**env), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        for mode, env in envs.items()}
    runs = {}
    try:
        for mode, p in procs.items():
            out, err = p.communicate(timeout=300)
            runs[mode] = (p.returncode, out, err)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return runs


@pytest.mark.parametrize("mode", list(MODES))
def test_parallel_mode_prints_one_line(mode, mode_runs):
    _, metric, ranks = MODES[mode]
    returncode, stdout, stderr = mode_runs[mode]
    assert returncode == 0, stderr[-4000:]
    lines = [json.loads(ln) for ln in stdout.splitlines()
             if ln.startswith("{")]
    assert len(lines) == 1, stdout
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


def test_no_card_exits_nonzero(mode_runs):
    returncode, stdout, stderr = mode_runs["no-card"]
    assert returncode != 0
    assert "CUDA is not available" in stderr
    assert "{" not in stdout
