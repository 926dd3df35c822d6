"""Every configuration, cell and metric is found by name and parses, and a
cell added as files alone is picked up."""

import json
import os
import re
import shutil

import pytest

from portbench import spec

ROOT = os.path.dirname(spec.HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_keys_and_names():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    assert 1 <= b["run_seconds"] <= 51
    metrics = b["end_to_end"] + b["per_layer"]
    names = [m["name"] for m in metrics] + [w["name"] for w in
                                            b["workloads"]]
    names += [c["name"] for c in b["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert 0 < m["bound"] <= 0.25 and m["source"] in ("host_clock",
                                                           "device_trace")
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]


@pytest.mark.parametrize("entry", bench()["configs"],
                         ids=lambda c: c["name"])
def test_config_parses(entry):
    with open(os.path.join(ROOT, entry["file"])) as f:
        cfg = json.load(f)
    assert cfg["name"] == entry["name"]
    assert cfg["reduced"] == entry["reduced"]
    assert cfg["source"] == entry["source"]
    for key in ("task", "method", "imsize", "net", "compute_dtype",
                "limits"):
        assert key in cfg


@pytest.mark.parametrize("entry", bench()["workloads"],
                         ids=lambda w: w["name"])
def test_cell_loads(entry):
    cell = spec.load_cell(ROOT, entry["name"])
    assert cell.config["name"] == entry["config"]
    assert cell.workload["chips"] == entry["chips"] == 1
    assert cell.workload["why"] == entry["why"]
    drv = cell.traffic()
    assert drv.candidates(cell)
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer


@pytest.mark.parametrize("metric", bench()["end_to_end"]
                         + bench()["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_found(metric):
    assert callable(spec.reader(metric["name"]))


def test_cell_added_as_files(tmp_path):
    """A new cell, configuration and per-layer metric, added as files and
    BENCHMARK.json entries only, are found by the harness."""
    bench_dir = tmp_path / "portbench"
    shutil.copytree(spec.HERE, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = bench()
    cfg = json.loads((bench_dir / "configs" / "den_mfvi_f32_256.json")
                     .read_text())
    cfg["name"] = "den_mfvi_f32_256_img1"
    cfg["img"] = 1
    (bench_dir / "configs" / "den_mfvi_f32_256_img1.json").write_text(
        json.dumps(cfg))
    b["configs"].append({"name": cfg["name"], "source": cfg["source"],
                         "file": "portbench/configs/"
                                 "den_mfvi_f32_256_img1.json",
                         "reduced": cfg["reduced"], "why": "a test"})
    (bench_dir / "workloads" / "den_mfvi_f32_256_img1.fit.json").write_text(
        json.dumps({"config": cfg["name"], "traffic": "fit",
                    "kind": "fit", "params": {}, "chips": 1,
                    "why": "a test"}))
    b["workloads"].append({"name": "den_mfvi_f32_256_img1.fit",
                           "config": cfg["name"], "traffic": "fit",
                           "chips": 1, "why": "a test"})
    (bench_dir / "metrics" / "chunks_seen.py").write_text(
        "def read(run):\n    return len(run.candidates[0].chunks)\n")
    b["per_layer"].append({"name": "chunks_seen", "unit": "chunks",
                           "better": "higher", "source": "program_span",
                           "layer": "Trainer", "moves": "cand_it_s",
                           "workloads": ["den_mfvi_f32_256_img1.fit"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = spec.load_cell(str(tmp_path), "den_mfvi_f32_256_img1.fit",
                          str(bench_dir))
    assert cell.config["img"] == 1
    assert [m["name"] for m in cell.per_layer
            if m["name"] == "chunks_seen"] == ["chunks_seen"]
    read = spec.reader("chunks_seen", str(bench_dir))

    class R:
        candidates = [type("C", (), {"chunks": [1, 2, 3]})]

    assert read(R) == 3
    assert cell.traffic().candidates(cell) == [(cfg["temp"], cfg["sigma"])]


def test_bad_names_refused():
    with pytest.raises(ValueError):
        spec.reader("../run")
    with pytest.raises(ValueError):
        spec.load_cell(ROOT, "a/b")
