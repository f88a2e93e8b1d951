"""BENCHMARK.json and the files it names: present, loadable and within
the benchmark's contract."""
import json
import re
from pathlib import Path

import pytest

from splatbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["splatbench"]
    assert BENCH["command"][1] == "splatbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entry(conf):
    assert NAME.match(conf["name"])
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert len(conf["why"]) <= 200 and len(conf["source"]) <= 200
    assert conf["file"] == f"splatbench/configs/{conf['name']}.json"
    data = json.loads((ROOT / conf["file"]).read_text())
    assert data["name"] == conf["name"] and data["reduced"] == conf["reduced"]


@pytest.mark.parametrize(
    "path", sorted((ROOT / "splatbench" / "configs").glob("*.json")),
    ids=lambda p: p.stem)
def test_config_file(path):
    data = json.loads(path.read_text())
    assert data["name"] == path.stem and data["reduced"] == []
    scene = data["scene"]
    assert scene["cameras"]["count"] > 0 and scene["n_gaussians"] > 0
    assert scene["axis_spread"] >= 0 and scene["scale_spread"] >= 0
    assert abs(sum(s["share"] for s in scene["surfaces"]) - 1.0) < 1e-9


@pytest.mark.parametrize("work", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_files(work):
    assert NAME.match(work["name"]) and NAME.match(work["traffic"])
    assert set(work) == {"name", "config", "traffic", "chips", "why"}
    assert work["chips"] == 1 and len(work["why"]) <= 200
    cell = harness.load_cell(work["name"], ROOT)
    assert cell.traffic["trainer"] in harness.TRAINERS
    assert set(cell.limits) == set(("loss_gap", "psnr_gap", "grad_gap",
                                    "change_gap"))
    names = {m["name"] for m in cell.metrics}
    assert "setup_s" in names and len(names) >= 3


@pytest.mark.parametrize(
    "mix", sorted(p.stem for p in (ROOT / "splatbench" / "traffic")
                  .glob("*.json")))
def test_traffic_file(mix):
    assert NAME.match(mix)
    traffic = harness.load_traffic(mix)
    assert traffic["trainer"] in harness.TRAINERS
    assert traffic["scenes"] >= 1 and traffic["first_step"] >= 1
    assert traffic["trace_samples"] <= traffic["trace_steps"]
    if traffic["trainer"] == "Trainer":
        assert traffic["scenes"] == 1


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert (ROOT / "splatbench" / "metrics" / f"{metric['name']}.py").exists()
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        assert metric["moves"] == "train_steps_per_s"
        assert set(metric["workloads"]) <= {w["name"] for w in
                                            BENCH["workloads"]}
        assert len(metric["layer"]) <= 200


def test_every_metric_has_a_reader():
    named = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    files = {p.stem for p in (ROOT / "splatbench" / "metrics").glob("*.py")}
    assert named <= files
    for name in files:
        assert callable(harness.load_reader(name))
