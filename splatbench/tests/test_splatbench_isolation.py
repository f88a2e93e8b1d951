"""What the benchmark runs loads neither JAX nor the JAX package
(top-level module names compared whole: the port's name begins with the
JAX package's), and the reference loads nothing of the port. Each check
runs in a fresh interpreter."""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = "{'jax', 'jaxlib', 'flax', 'opensplat_tpu'}"


def _tops(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(sorted({n.split('.')[0] for n in sys.modules}))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_harness_and_program_load_no_jax():
    tops = _tops(
        "import sys; sys.path.insert(0, '.')\n"
        "from splatbench import harness, calibrate\n"
        "harness.program()\n"
        "import opensplat_tpu_torch.train, opensplat_tpu_torch.ops.kernels.raster\n"
        "import pathlib\n"
        "for p in pathlib.Path('splatbench/metrics').glob('*.py'):\n"
        "    harness.load_reader(p.stem)")
    assert "opensplat_tpu_torch" in tops
    assert not tops & eval(FORBIDDEN)


def test_reference_loads_nothing_of_the_port():
    tops = _tops("import sys; sys.path.insert(0, '.')\n"
                 "import splatbench.reference.step, splatbench.correctness\n"
                 "import splatbench.scene, splatbench.yardstick.counts\n"
                 "import splatbench.yardstick.trace, splatbench.yardstick.peaks")
    assert not tops & (eval(FORBIDDEN) | {"opensplat_tpu_torch"})
