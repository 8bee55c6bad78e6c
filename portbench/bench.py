"""What BENCHMARK.json names, found by name under portbench/: a cell's
configuration (configs/<config>.json), traffic mix (traffic/<mix>.json),
the limits of its check (limits/<cell>.json) and the readers of its
metrics (metrics/<metric>.py, each with read(ctx) -> number or None).
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root=ROOT):
    with open(Path(root) / "BENCHMARK.json") as fh:
        return json.load(fh)


def _json(path):
    with open(path) as fh:
        return json.load(fh)


def _reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


class Cell:
    """One entry of BENCHMARK.json's workloads with everything it names."""

    def __init__(self, name, bench=None, root=ROOT):
        bench = load_benchmark(root) if bench is None else bench
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                           f"{sorted(cells)}")
        self.name = name
        self.entry = cells[name]
        self.chips = int(self.entry["chips"])
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = _json(Path(root) / configs[self.entry["config"]]["file"])
        self.traffic = _json(HERE / "traffic" / f"{self.entry['traffic']}.json")
        self.limits = _json(HERE / "limits" / f"{name}.json")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if _reports(m, name)]
        self.per_layer = [m for m in bench["per_layer"] if _reports(m, name)]

    def metrics(self, trace):
        return self.per_layer if trace else self.end_to_end


def reader(metric_name):
    """The read(ctx) function of metrics/<metric_name>.py."""
    path = HERE / "metrics" / f"{metric_name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric_name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
