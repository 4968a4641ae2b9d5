"""BENCHMARK.json against the benchmark's contract, and every cell
resolved to its files by name; a throwaway cell added by files alone."""

import hashlib
import json
import re
import shutil

import pytest

from portbench import spec
from portbench.spec import HERE, ROOT, Cell, load_benchmark, load_reader

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = load_benchmark()


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word
    assert 1 <= BENCH["run_seconds"] <= 51


def test_check_fits_with_24_cells():
    cells = 24
    runs = 2 + 14 * cells
    need = runs * (BENCH["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert need <= 43200


def test_names_units_and_entries():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(workload):
    cell = Cell(BENCH, workload)
    assert cell.config["name"] == cell.entry["config"]
    assert spec.load_driver(cell.traffic["kind"]).run
    assert cell.limits["limits"]
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in names
        assert callable(load_reader(m["name"]))


def _digest(root):
    return {p.relative_to(root).as_posix():
            hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_cell_is_added_by_files_alone(tmp_path):
    base = tmp_path / "portbench"
    shutil.copytree(HERE, base, ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(base)
    cfg = json.loads((base / "configs" / "mitonet.json").read_text())
    cfg["name"] = "mitonet_wide"
    (base / "configs" / "mitonet_wide.json").write_text(json.dumps(cfg))
    traffic = json.loads((base / "traffic" / "train.json").read_text())
    traffic["batch"] = 32
    (base / "traffic" / "train_b32.json").write_text(json.dumps(traffic))
    (base / "limits" / "mitonet_wide_b32.json").write_text(
        (base / "limits" / "mitonet_train.json").read_text())
    (base / "metrics" / "steps.train.py").write_text(
        "def read(ctx):\n    return ctx.get('steps')\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "mitonet_wide", "source": "x",
                             "file": "portbench/configs/mitonet_wide.json",
                             "reduced": [], "why": "throwaway"})
    bench["workloads"].append({"name": "mitonet_wide_b32",
                               "config": "mitonet_wide",
                               "traffic": "train_b32", "chips": 1,
                               "why": "throwaway"})
    bench["per_layer"].append({"name": "steps.train", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "train step",
                               "moves": "train_images_per_s",
                               "workloads": ["mitonet_wide_b32"]})
    cell = Cell(bench, "mitonet_wide_b32", base=base)
    assert cell.traffic["batch"] == 32
    assert [m["name"] for m in cell.per_layer][-1] == "steps.train"
    assert load_reader("steps.train", base=base)({"steps": 7}) == 7
    after = _digest(base)
    assert {k: v for k, v in after.items() if k in before} == before
