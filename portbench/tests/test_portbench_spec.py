"""Every configuration, cell and metric is found by name and parses, and a
configuration (with a plain reference of its own), a cell and a metric added
as files alone are picked up, with no existing file changed."""

import hashlib
import json
import os
import re
import shutil
import types

import pytest
import torch

from portbench import check, run as R, spec
from portbench.tests import small
from portbench.work import conv

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
    for key in ("task", "method", "reference", "imsize", "net",
                "compute_dtype", "limits"):
        assert key in cfg
    assert callable(spec.reference(cfg["reference"]).Fit)


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


# a configuration's own reference module: step's den fit with an L1 data
# loss, and one conv site more (1 x 1 channels, 1 x 1 kernel, on 2 x 2)
L1_MODULE = """
import torch
from portbench.reference import step


class Fit(step.Fit):
    def data_loss(self, out):
        return torch.mean(torch.abs(self.target - out[:, :1]))


def conv_sites(cfg):
    return step.conv_sites(cfg) + [dict(name="extra", c_in=1, c_out=1, k=1,
                                        stride=1, size_in=2, needs_dx=False)]
"""
# the same mathematics as step's, under a name of its own
COPY_MODULE = "from portbench.reference.step import Fit, conv_sites\n"


def _digests(folder) -> dict:
    return {str(p.relative_to(folder)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(folder.rglob("*")) if p.is_file()}


def add_config(tmp_path, module: str, source: str) -> tuple:
    """A copy of the benchmark at ``tmp_path`` with, added as files and
    BENCHMARK.json entries only: configuration ``den_<module>`` naming the
    reference module ``<module>`` (``source``), its cell ``den_<module>.fit``
    and the per-layer metric ``chunks_seen``. Returns (root, bench_dir,
    cell name); asserts that no file of the copy changed."""
    bench_dir = tmp_path / "portbench"
    shutil.copytree(spec.HERE, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(bench_dir)
    b = bench()
    cfg = json.loads((bench_dir / "configs" / "den_mfvi_f32_256.json")
                     .read_text())
    cfg["name"] = f"den_{module}"
    cfg["reference"] = module
    (bench_dir / "reference" / f"{module}.py").write_text(source)
    (bench_dir / "configs" / f"{cfg['name']}.json").write_text(
        json.dumps(cfg))
    b["configs"].append({"name": cfg["name"], "source": cfg["source"],
                         "file": f"portbench/configs/{cfg['name']}.json",
                         "reduced": cfg["reduced"], "why": "a test"})
    name = f"{cfg['name']}.fit"
    (bench_dir / "workloads" / f"{name}.json").write_text(
        json.dumps({"config": cfg["name"], "traffic": "fit",
                    "kind": "fit", "params": {}, "chips": 1,
                    "why": "a test"}))
    b["workloads"].append({"name": name, "config": cfg["name"],
                           "traffic": "fit", "chips": 1, "why": "a test"})
    (bench_dir / "metrics" / "chunks_seen.py").write_text(
        "def read(run):\n    return len(run.candidates[0].chunks)\n")
    b["per_layer"].append({"name": "chunks_seen", "unit": "chunks",
                           "better": "higher", "source": "program_span",
                           "layer": "Trainer", "moves": "cand_it_s",
                           "workloads": [name]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    after = _digests(bench_dir)
    assert {k: after[k] for k in before} == before
    return str(tmp_path), str(bench_dir), name


def test_cell_added_as_files(tmp_path):
    """A new configuration with its own reference module, a cell and a
    per-layer metric, added as files and BENCHMARK.json entries only, are
    found by the harness: spec, the correctness check's reference side and
    the conv work all take the configuration's module."""
    root, bench_dir, name = add_config(tmp_path, "den_l1", L1_MODULE)
    cell = spec.load_cell(root, name, bench_dir)
    assert cell.config["reference"] == "den_l1"
    assert cell.reference().__file__ == os.path.join(bench_dir, "reference",
                                                     "den_l1.py")
    assert [m["name"] for m in cell.per_layer
            if m["name"] == "chunks_seen"] == ["chunks_seen"]
    read = spec.reader("chunks_seen", bench_dir)

    class Run:
        candidates = [type("C", (), {"chunks": [1, 2, 3]})]

    assert read(Run) == 3
    assert cell.traffic().candidates(cell) == [
        (cell.config["temp"], cell.config["sigma"])]

    den = spec.load_cell(small.ROOT, "den_mfvi_f32_256.fit")
    sites = conv.sites(cell.config, cell.reference())
    assert [s["name"] for s in sites] == [
        s["name"] for s in conv.sites(den.config, den.reference())] + ["extra"]
    # the extra site: 2 operations a pass on each of its 2 x 2 outputs, a
    # forward and a dw
    assert conv.flops_per_iteration(cell.config, cell.reference()) == \
        conv.flops_per_iteration(den.config, den.reference()) + 2 * 8.0

    cell.config = small.cut(cell.config)
    den.config = small.cut(den.config)
    seed = 2 ** 31 + 5
    mine = check.reference_side(cell, cell.config["temp"],
                                cell.config["sigma"], seed, "cpu")
    step = check.reference_side(den, den.config["temp"], den.config["sigma"],
                                seed, "cpu")
    for k in step["flat0"]:
        assert torch.equal(mine["flat0"][k], step["flat0"][k])
    assert not all(torch.equal(mine["g1"][k], step["g1"][k])
                   for k in step["g1"])


@pytest.mark.parametrize("module, source, correct",
                         [("den_copy", COPY_MODULE, True),
                          ("den_l1", L1_MODULE, False)])
def test_added_cell_is_judged_by_its_module(module, source, correct,
                                            tmp_path, monkeypatch):
    """A CPU run of a cell added as files reports ``correct`` against a
    reference module of the program's mathematics, and not against one of
    another loss."""
    root, bench_dir, name = add_config(tmp_path, module, source)
    cell = spec.load_cell(root, name, bench_dir)
    cell.config = small.cut(cell.config)
    cell.config["num_iter"] = 300
    small.patch_port(monkeypatch, cell.config)
    out = R.measure(cell, types.SimpleNamespace(seed=2 ** 31 + 7,
                                                seconds=0.0, trace=0), "cpu")
    assert out["correct"] is correct, out["compared"]


def test_bad_names_refused():
    with pytest.raises(ValueError):
        spec.reader("../run")
    with pytest.raises(ValueError):
        spec.load_cell(ROOT, "a/b")
    with pytest.raises(ValueError):
        spec.reference("../check")
