"""``BENCHMARK.json`` and the files it names, found by name.

- a configuration: ``portbench/configs/<config>.json``;
- a traffic mix: ``portbench/traffic/<traffic>.json``, whose ``kind``
  names the driver ``portbench/drivers/<kind>.py``;
- a cell's limits for the output check: ``portbench/limits/<workload>.json``;
- a per-layer metric: the reader ``portbench/metrics/<metric>.py``, a
  function ``read(ctx)`` that returns the value or None.

A cell, a configuration, a traffic mix or a per-layer metric is added by
adding files and entries; no file here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

__all__ = ["HERE", "ROOT", "load_benchmark", "Cell", "load_reader",
           "load_driver"]

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path):
    with open(path) as f:
        return json.load(f)


def load_benchmark(path=None):
    return _json(path or ROOT / "BENCHMARK.json")


def _applies(metric, workload):
    return "workloads" not in metric or workload in metric["workloads"]


class Cell:
    """One entry of ``workloads`` with its configuration, traffic,
    limits and metrics."""

    def __init__(self, bench, name, base=HERE):
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                           f"choices: {sorted(entries)}")
        self.entry = entries[name]
        self.name = name
        self.chips = self.entry["chips"]
        self.config = _json(base / "configs" / f"{self.entry['config']}.json")
        self.traffic = _json(base / "traffic"
                             / f"{self.entry['traffic']}.json")
        self.limits = _json(base / "limits" / f"{name}.json")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if _applies(m, name)]
        self.per_layer = [m for m in bench["per_layer"]
                          if _applies(m, name)]


def load_reader(name, base=HERE):
    """The ``read`` function of the per-layer metric ``name``."""
    path = base / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def load_driver(kind):
    return importlib.import_module(f"portbench.drivers.{kind}")
