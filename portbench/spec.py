"""``BENCHMARK.json`` and the files it names, found by name.

A cell, a configuration, a traffic mix, a per-layer metric, a kind of
traffic and an architecture are added by adding files and entries; no
file here changes. What comes by added files:

- a configuration: ``portbench/configs/<config>.json``. Its optional
  ``"reference"`` names the module ``portbench/reference/<module>.py``
  of its plain reference (default ``models``), which exports ``ARCHS``
  ({``recipe.MODEL.arch``: class built as ``cls(cfg)``, with the
  keyword ``mask_dtype`` where the class takes one}) and may export
  ``INIT_RULES`` (``weights.RULES``' form, consulted before them);
- a configuration's fitted heads: an ``.npz`` under ``configs/`` that
  holds arrays under the state-dict keys they replace, in torch layout,
  beside ``backbone_fingerprint`` (``weights.bench_state``);
- a traffic mix: ``portbench/traffic/<traffic>.json``, whose ``kind``
  names the driver ``portbench/drivers/<kind>.py``. A driver exports
  ``run(cell, seed, seconds, trace, device, t_start)``, one run of a
  cell (``portbench.run`` reads its result), and ``readings(cell, seeds,
  control_seeds, device, emit, witness_seeds=())``, the calibration
  readings (``portbench.calibrate``): one ``emit``ted dict a reading,
  with ``kind`` and ``numbers``, among them at least the kinds
  ``program`` and ``control``, which the card test holds to the limits;
- a cell's limits for the output check: ``portbench/limits/<workload>.json``;
- a per-layer metric: the reader ``portbench/metrics/<metric>.py``, a
  function ``read(ctx)`` that returns the value or None.

Each loader takes ``base``, the folder these files sit in, so that a
test can work on a copy.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

__all__ = ["HERE", "ROOT", "load_benchmark", "Cell", "load_reader",
           "load_driver", "load_reference"]

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
        self.name, self.base = name, base
        self.chips = self.entry["chips"]
        self.config = _json(base / "configs" / f"{self.entry['config']}.json")
        self.traffic = _json(base / "traffic"
                             / f"{self.entry['traffic']}.json")
        self.limits = _json(base / "limits" / f"{name}.json")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if _applies(m, name)]
        self.per_layer = [m for m in bench["per_layer"]
                          if _applies(m, name)]


def _from_file(path, module_name):
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _module(folder, name, base):
    """``<base>/<folder>/<name>.py``: this package's own module where
    ``base`` is this package (so that its classes are the ones the rest
    of the harness imports), else loaded from its file."""
    if not name.isidentifier():
        raise ValueError(f"{folder}/{name}.py: not a module name")
    if Path(base).resolve() == HERE:
        return importlib.import_module(f"portbench.{folder}.{name}")
    return _from_file(Path(base) / folder / f"{name}.py",
                      f"portbench_{folder}_{name}")


def load_reader(name, base=HERE):
    """The ``read`` function of the per-layer metric ``name``."""
    return _from_file(base / "metrics" / f"{name}.py",
                      "portbench_metric_" + name.replace(".", "_")).read


def load_driver(kind, base=HERE):
    """The driver module of the traffic kind ``kind``."""
    return _module("drivers", kind, base)


def load_reference(cfg, base=HERE):
    """The plain-reference module that configuration ``cfg`` names."""
    return _module("reference", cfg.get("reference", "models"), base)
