"""The port's benchmark entry point (``empanada_torch.bench``) at a tiny
size on the CPU: every section of the line runs through
``run_bench(..., device="cpu")`` (the tiny MitoNet in bfloat16: seeded
regnety_200mf, fpn_layers=1; volumes of 4-24 slices) and the line reads
back as JSON with the JAX bench's keys, less the three that describe the
JAX package's circumstances (``vs_baseline``, ``vs_est_gpu``,
``tunnel_sentinel_ms``), plus the port's (``card``, ``dtype``, the
accuracy of the headline and the slab, ``iou_gate``).

The seeded tiny model segments nothing real, so the gate's result is
only checked for its form here; on the card the bench MitoNet must pass
it (``chip_smoke.py``)."""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from empanada_torch import bench
from empanada_torch.data.synthetic import synthetic_em_volume
from empanada_torch.models import create_model

TINY = dict(encoder="regnety_200mf", fpn_layers=1, num_classes=1,
            train_num_points=16, subdivision_num_points=32)
# the JAX bench's keys (bench.py at the repository's root)
JAX_TOP_KEYS = {"metric", "value", "unit", "vs_baseline", "baseline_note",
                "breakdown"}
JAX_BREAKDOWN_KEYS = {"stack_512", "per_mode_slices_per_sec", "orthoplane",
                      "vs_est_gpu", "product_density", "flops_per_dispatch",
                      "dispatches", "mfu_end_to_end_lower_bound",
                      "product_scale_512", "tunnel_sentinel_ms"}
LEFT_OUT = {"vs_baseline", "baseline_note", "vs_est_gpu",
            "tunnel_sentinel_ms"}
PORT_KEYS = {"card", "dtype", "iou_gate"}


@pytest.fixture(scope="module")
def line():
    """The bench's printed line, read back, for the tiny bfloat16
    MitoNet at one rep a section (one torch thread, as beside other
    test workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    printed = io.StringIO()
    try:
        model = create_model("PanopticBiFPNPR", device="cpu", seed=0,
                             dtype="bfloat16", **TINY)
        stack, _ = synthetic_em_volume((8, 128, 128), n_instances=6, seed=7)
        headline = synthetic_em_volume((4, 16, 24), n_instances=3, seed=11,
                                       overlap=False)
        slab = synthetic_em_volume((8, 16, 16), n_instances=4, seed=13,
                                   overlap=False)
        with contextlib.redirect_stdout(printed):
            out = bench.run_bench(model, stack, headline, slab, "cpu",
                                  large=headline,
                                  reps={"stack": 1, "orthoplane": 1,
                                        "product_density": 1})
    finally:
        torch.set_num_threads(threads)
    # main prints the line and nothing else: the sections print nothing
    assert printed.getvalue() == ""
    text = json.dumps(out)
    assert "\n" not in text
    return json.loads(text)


def test_line_has_the_jax_bench_keys(line):
    assert set(line) == JAX_TOP_KEYS - LEFT_OUT
    assert set(line["breakdown"]) == (JAX_BREAKDOWN_KEYS - LEFT_OUT) \
        | PORT_KEYS
    assert line["metric"] == "mitonet_orthoplane3d_inference_throughput"
    assert line["unit"] == "slices/s"
    assert line["value"] > 0


def test_stack_section_reports_every_mode(line):
    b = line["breakdown"]
    assert set(b["per_mode_slices_per_sec"]) == {"stream", "resident",
                                                 "int8", "ceiling"}
    assert all(v > 0 for v in b["per_mode_slices_per_sec"].values())
    stack = b["stack_512"]
    assert stack["mode"] in ("stream", "resident")
    assert stack["volume"] == [8, 128, 128]
    assert {"slices_per_sec", "instances_per_slice",
            "overflow_slices"} <= set(stack)
    # one block of 8 and the median's tail block
    assert b["dispatches"] == 2 and b["flops_per_dispatch"] > 0
    # the peak is the card's: no device metric from a CPU run
    assert b["mfu_end_to_end_lower_bound"] is None


@pytest.mark.parametrize("section, reps", [("orthoplane", 1),
                                           ("product_density", 1)])
def test_volume_sections_are_timed_through_the_fill_and_scored(line, section,
                                                               reps):
    entry = line["breakdown"][section]
    assert len(entry["rep_seconds"]) == reps
    assert entry["total_seconds"] == min(entry["rep_seconds"])
    assert {"instances_3d", "gt_instances_3d", "instances_per_slice",
            "overflow_slices", "consensus_seconds",
            "label_divisor"} <= set(entry)
    assert entry["label_divisor"] == 20000
    assert set(entry["accuracy"]) == {"semantic_iou", "f1_50", "pq"}
    assert all(0.0 <= v <= 1.0 for v in entry["accuracy"].values())
    # the grouping runs its plain version on the CPU: no kernel launch
    assert entry["k1_launches"] == 0


def test_card_dtype_gate_and_large_section(line):
    b = line["breakdown"]
    assert b["card"] == {"name": "cpu", "power_limit": None}
    assert b["dtype"] == "bfloat16"
    gate = b["iou_gate"]
    assert gate["threshold"] == 0.5
    ious = {k: b[k]["accuracy"]["semantic_iou"]
            for k in ("orthoplane", "product_density")}
    assert gate["semantic_iou"] == ious
    assert gate["passed"] == all(v >= 0.5 for v in ious.values())
    large = b["product_scale_512"]
    assert large["volume"] == [4, 16, 24] and large["slices_per_sec"] > 0
    assert set(large["stats"]["axes"]) == {"xy", "xz", "yz"}


def test_main_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main([])


def test_large_volume_is_the_jax_probe_volume(monkeypatch):
    """``large_volume`` asks for the JAX probe's 512^3 volume: 2400
    disjoint instances, seed 13 (checked without making it)."""
    calls = []

    def fake(shape, **kwargs):
        calls.append((shape, kwargs))
        return np.zeros(shape[:1], np.uint8), None

    monkeypatch.setattr("empanada_torch.data.synthetic.synthetic_em_volume",
                        fake)
    bench.large_volume()
    assert calls == [((512, 512, 512), dict(n_instances=2400, seed=13,
                                            overlap=False))]
