"""BENCHMARK.json against the benchmark's contract, and every cell
resolved to its files by name; a throwaway cell, and a throwaway kind of
traffic with a throwaway architecture, added by files alone."""

import hashlib
import json
import re
import shutil
import textwrap

import numpy as np
import pytest
import torch

from portbench import calibrate, spec, weights
from portbench.drivers import train
from portbench.reference import models as ref_models
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
    driver = spec.load_driver(cell.traffic["kind"])
    assert callable(driver.run) and callable(driver.readings)
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


TOY_REFERENCE = """
from torch import nn

from portbench.reference.models import Conv


class Head(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.Conv_0 = Conv(cin, cout, 1)


class ToyBC(nn.Module):
    def __init__(self, cfg, mask_dtype=None):
        super().__init__()
        dim = cfg["recipe"]["MODEL"]["decoder_channels"]
        self.mask_dtype = mask_dtype
        self.stem = Conv(1, dim, 3, padding=1)
        self.semantic_head = Head(dim, 1)
        self.boundary_head = Head(dim, 1)


ARCHS = {"ToyBC": ToyBC}
INIT_RULES = [(r"boundary_head\\.Conv_0\\.weight$", "ones")]
"""

TOY_DRIVER = """
def run(cell, seed, seconds, trace, device, t_start):
    raise NotImplementedError


def readings(cell, seeds, control_seeds, device, emit, witness_seeds=()):
    for seed in seeds:
        emit({"kind": "program", "seed": seed, "numbers": {"gap": 0.0}})
        if seed in control_seeds:
            emit({"kind": "control", "seed": seed, "numbers": {"gap": 1.0}})
"""


def test_a_kind_and_an_architecture_are_added_by_files_alone(tmp_path):
    base = tmp_path / "portbench"
    shutil.copytree(HERE, base, ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(base)
    (base / "reference" / "toy_bc.py").write_text(TOY_REFERENCE)
    cfg = {"name": "toy_bc", "reference": "toy_bc",
           "heads": "toy_bc_heads.npz",
           "recipe": {"MODEL": {"arch": "ToyBC", "num_fc": 3,
                                "decoder_channels": 4}}}
    (base / "configs" / "toy_bc.json").write_text(json.dumps(cfg))
    (base / "drivers" / "toy_watershed.py").write_text(TOY_DRIVER)
    (base / "traffic" / "ortho_ws.json").write_text(
        json.dumps({"kind": "toy_watershed"}))
    (base / "limits" / "toy_bc_ortho.json").write_text(
        json.dumps({"limits": {"gap": 0.5}}))
    (base / "metrics" / "gap_s.ws.py").write_text(
        "def read(ctx):\n    return ctx.get('gap_s')\n")

    # the heads file names the state keys it replaces, in torch layout
    shapes = train.state_shapes(cfg, base=base)
    fitted = {"boundary_head.Conv_0.weight": np.full((1, 4, 1, 1), 0.5,
                                                     np.float32),
              "boundary_head.Conv_0.bias": np.array([-2.0], np.float32)}
    backbone = weights.bench_backbone(shapes)
    np.savez(base / "configs" / cfg["heads"], **fitted,
             backbone_fingerprint=np.array(
                 weights.fingerprint(backbone, fitted)))

    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "toy_bc", "source": "x",
                             "file": "portbench/configs/toy_bc.json",
                             "reduced": [], "why": "throwaway"})
    bench["workloads"].append({"name": "toy_bc_ortho", "config": "toy_bc",
                               "traffic": "ortho_ws", "chips": 1,
                               "why": "throwaway"})
    bench["per_layer"].append({"name": "gap_s.ws", "unit": "s",
                               "better": "lower", "source": "program_span",
                               "layer": "watershed",
                               "moves": "volume_mvox_per_s",
                               "workloads": ["toy_bc_ortho"]})
    bench["end_to_end"][0]["workloads"].append("toy_bc_ortho")
    cell = Cell(bench, "toy_bc_ortho", base=base)
    assert cell.config["reference"] == "toy_bc"
    assert cell.limits == {"limits": {"gap": 0.5}}
    assert {m["name"] for m in cell.end_to_end} == {"volume_mvox_per_s",
                                                    "setup_s"}
    assert [m["name"] for m in cell.per_layer] == ["gap_s.ws"]
    assert load_reader("gap_s.ws", base=base)({"gap_s": 0.25}) == 0.25
    driver = spec.load_driver("toy_watershed", base=base)
    assert callable(driver.run) and callable(driver.readings)

    got = []
    calibrate.readings(cell, [7, 8], {8}, "cpu", got.append)
    assert [(r["kind"], r["seed"]) for r in got] == [
        ("program", 7), ("program", 8), ("control", 8)]

    model = ref_models.build(cfg, "cpu", torch.bfloat16, base=base)
    assert type(model).__name__ == "ToyBC" and model.training
    assert model.mask_dtype == torch.bfloat16
    # the shared layers: set_precision reaches them
    ref_models.set_precision(model, "fp8")
    assert model.stem.fp8 and model.boundary_head.Conv_0.fp8
    assert list(shapes) == list(model.state_dict())
    assert shapes["boundary_head.Conv_0.weight"] == ((1, 4, 1, 1),
                                                     torch.float32)

    init = train.make_weights(cfg, 3, "cpu", base=base)
    assert torch.equal(init["boundary_head.Conv_0.weight"],
                       torch.ones(1, 4, 1, 1))  # the module's INIT_RULES
    assert init["semantic_head.Conv_0.weight"].abs().max() < 0.01

    state = weights.bench_state(shapes, base / "configs" / cfg["heads"],
                                cfg["recipe"]["MODEL"]["num_fc"])
    for key, value in fitted.items():
        assert torch.equal(state[key], torch.from_numpy(value))
    for key in ("stem.weight", "semantic_head.Conv_0.weight"):
        assert torch.equal(state[key], backbone[key])
    model.load_state_dict(state)

    after = _digest(base)
    assert {k: v for k, v in after.items() if k in before} == before
