"""The command without a card, and in a tree without the program: a
non-zero exit with a message and no result."""
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def _run(cwd, *args):
    return subprocess.run([sys.executable, "splatbench/run.py", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_no_card_exits_nonzero_with_a_message():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run(ROOT, "--workload", "lego.scenes4", "--seed", "4294967311",
               "--seconds", "10", "--trace", "0")
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert out.stdout.strip() == ""


def test_unknown_workload_exits_nonzero():
    out = _run(ROOT, "--workload", "nope", "--seed", "1", "--seconds", "1")
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_files_alone_cannot_run(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "splatbench", tmp_path / "splatbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, '.')\n"
            "from splatbench import harness\n"
            "harness.program()\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "opensplat_tpu_torch" in out.stderr
    out = _run(tmp_path, "--workload", "lego.scenes4", "--seed", "1",
               "--seconds", "1")
    assert out.returncode != 0 and out.stdout.strip() == ""
