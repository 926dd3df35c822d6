"""Everything a run finds by name: the cell's entry in ``BENCHMARK.json``, its
workload file, its configuration file, its traffic module, its
configuration's plain reference module and the reader of each metric it
reports. Adding a configuration (with a reference module of its own), a
cell or a per-layer metric is adding files under ``portbench/`` and entries
in ``BENCHMARK.json``; nothing here names one of them."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: str, name: str):
    """The Python file ``path`` loaded as a module of its own."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One cell: its ``BENCHMARK.json`` entry, its workload file, its
    configuration and the metrics it reports."""
    name: str
    entry: dict              # the BENCHMARK.json workload entry
    workload: dict           # portbench/workloads/<name>.json
    config: dict             # portbench/configs/<config>.json
    end_to_end: list         # BENCHMARK.json metric entries for this cell
    per_layer: list
    bench_dir: str
    _reference: object = dataclasses.field(default=None, repr=False)

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    def traffic(self):
        """The traffic module, portbench/traffic/<kind>.py."""
        kind = self.workload["kind"]
        if not NAME.match(kind):
            raise ValueError(f"bad traffic kind {kind!r}")
        return _module(os.path.join(self.bench_dir, "traffic", f"{kind}.py"),
                       f"portbench_traffic_{kind}")

    def reference(self):
        """The configuration's plain reference module,
        portbench/reference/<its 'reference'>.py, loaded once."""
        if self._reference is None:
            self._reference = reference(self.config["reference"],
                                        self.bench_dir)
        return self._reference

    def metrics(self, trace: bool) -> list:
        """The metric entries a run reports: the end-to-end ones untraced,
        the per-layer ones traced."""
        return self.per_layer if trace else self.end_to_end


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: str, name: str, bench_dir: str = HERE) -> Cell:
    """The cell ``name`` of the benchmark at ``root`` (the checkout), with
    its files under ``bench_dir``."""
    if not NAME.match(name):
        raise ValueError(f"bad cell name {name!r}")
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    entry = entries[name]
    workload = _load_json(os.path.join(bench_dir, "workloads",
                                       f"{name}.json"))
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(os.path.join(root, configs[entry["config"]]["file"]))
    return Cell(name, entry, workload, config,
                [m for m in bench["end_to_end"] if applies(m, name)],
                [m for m in bench["per_layer"] if applies(m, name)],
                bench_dir)


def reader(name: str, bench_dir: str = HERE):
    """The ``read(run)`` function of metric ``name``
    (portbench/metrics/<name>.py)."""
    if not NAME.match(name):
        raise ValueError(f"bad metric name {name!r}")
    mod = _module(os.path.join(bench_dir, "metrics", f"{name}.py"),
                  "portbench_metric_" + name.replace(".", "_"))
    return mod.read


def reference(name: str, bench_dir: str = HERE):
    """The plain reference module ``name`` (portbench/reference/<name>.py):
    ``Fit`` and ``conv_sites``, as reference/step.py's docstring says."""
    if not NAME.match(name):
        raise ValueError(f"bad reference module name {name!r}")
    return _module(os.path.join(bench_dir, "reference", f"{name}.py"),
                   "portbench_reference_" + name.replace(".", "_"))
