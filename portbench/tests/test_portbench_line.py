"""The result line's keys, the refusal without a card, and the look for
JAX by whole top-level module names."""

import json

from portbench import run
from portbench.spec import Cell, load_benchmark


def _out(trace):
    tr = {"busy_s": 9.0, "window_s": 10.0, "device_ops": [["k", 1.0]],
          "idle_gaps": [["train_step", 0.1]]} if trace else None
    return {"correct": True, "attempted": 12, "failed": 0,
            "end_to_end": {"train_images_per_s": 400.0, "setup_s": 20.0},
            "ctx": {"steps": 12, "window_s": 10.0, "step_ms": [150.0] * 40,
                    "flops_per_step": 1e13, "trace": tr,
                    "dtype": "bfloat16"},
            "checks": {"loss": {"value": 1e-5, "limit": 1e-3}}}


DEVICE = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
          "memory_peak_bytes": 1}


def test_untraced_line_has_the_end_to_end_metrics():
    cell = Cell(load_benchmark(), "pdlpr_train")
    line = run.result_line(cell, _out(False), False, DEVICE)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    json.dumps(line)


def test_traced_line_has_the_per_layer_metrics_and_breakdown():
    cell = Cell(load_benchmark(), "pdlpr_train")
    line = run.result_line(cell, _out(True), True, DEVICE)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "checks"]
    assert set(line["metrics"]) == {m["name"] for m in cell.per_layer}
    assert line["device"]["busy_s"] == 9.0
    assert abs(line["metrics"]["device_idle_share.train"]["value"] - 10) \
        < 1e-9


def test_without_a_card_no_result(capsys):
    code = run.main(["--workload", "pdlpr_train", "--seed", "1",
                     "--seconds", "1", "--trace", "0"])
    captured = capsys.readouterr()
    assert code != 0 and captured.out == ""
    assert "CUDA" in captured.err


def test_forbidden_modules_by_whole_top_level_name():
    found = run.forbidden_modules({
        "jax": 1, "jax.numpy": 1, "jaxlib.xla": 1, "flax.linen": 1,
        "empanada_tpu.ops": 1, "empanada_torch": 1,
        "empanada_torch.models": 1, "jaxtyping": 1, "portbench": 1})
    assert found == ["empanada_tpu.ops", "flax.linen", "jax", "jax.numpy",
                     "jaxlib.xla"]
