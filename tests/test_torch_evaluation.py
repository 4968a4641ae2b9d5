"""Port parity of 3D evaluation: the Evaluator and every metric equal
the JAX package's exactly on the same tracker JSONs (perfect, partial,
empty, split and merge cases); synthetic_em_volume is byte-identical in
both overlap modes and keeps the fast invariants of
tests/test_product_density_recovery.py; the stage timers; and
``python -m empanada_torch evaluate3d`` runs on the CPU with
``--device cpu``, its prediction equal to run_inference3d's."""

import json

import pytest

# the JAX package's third-party dependencies: where only the port's are
# installed, these parity tests skip
for _dep in ("jax", "flax", "yaml"):
    pytest.importorskip(_dep, reason="parity tests need the JAX package")

import numpy as np
import torch

from empanada_tpu import evaluation as j_evaluation
from empanada_tpu.data.synthetic import synthetic_em_volume as j_volume
from empanada_tpu.evaluation import evaluator as j_eval
from empanada_torch import evaluation as t_evaluation
from empanada_torch.data.synthetic import synthetic_em_volume
from empanada_torch.evaluation import evaluator as t_eval
from empanada_torch.inference.tracker import InstanceTracker
from empanada_torch.utils import profiling


def _write(tmp_path, name, instances, shape=(10, 20, 20)):
    tr = InstanceTracker(class_id=1, label_divisor=1000, shape3d=shape)
    tr.instances = instances
    tr.finished = True
    path = str(tmp_path / f"{name}.json")
    tr.write_to_json(path)
    return path


def _inst(box, starts, runs):
    return {"box": box, "starts": np.array(starts), "runs": np.array(runs)}


A = _inst((0, 0, 0, 5, 5, 5), [0, 100], [50, 20])
B = _inst((5, 5, 5, 9, 9, 9), [2000], [100])
C = _inst((9, 9, 9, 10, 10, 10), [3900], [50])
# A cut in two halves, and A and B as one object
A1, A2 = _inst((0, 0, 0, 5, 5, 5), [0], [50]), \
    _inst((0, 0, 0, 5, 5, 5), [100], [20])
AB = _inst((0, 0, 0, 9, 9, 9), [0, 100, 2000], [50, 20, 100])
A_SHIFTED = _inst((0, 0, 0, 5, 5, 5), [10, 100], [50, 25])

CASES = {
    "perfect": ({1001: A, 1002: B}, {1001: A, 1002: B}),
    "partial": ({1001: A, 1002: B}, {1001: A, 1003: C}),
    "shifted": ({1001: A, 1002: B}, {1007: A_SHIFTED, 1002: B}),
    "empty_pred": ({1001: A, 1002: B}, {}),
    "both_empty": ({}, {}),
    "split": ({1001: A, 1002: B}, {1004: A1, 1005: A2, 1002: B}),
    "merge": ({1001: A, 1002: B}, {1006: AB}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_evaluator_matches_jax(tmp_path, case):
    gt_inst, pred_inst = CASES[case]
    gt = _write(tmp_path, "gt", gt_inst)
    pred = _write(tmp_path, "pred", pred_inst)
    want, want_inst = j_eval.default_evaluator()(gt, pred,
                                                 return_instances=True)
    got, got_inst = t_eval.default_evaluator()(gt, pred,
                                               return_instances=True)
    assert list(got) == list(want) == [
        "iou", "f1_50", "f1_75", "precision_50", "precision_75",
        "recall_50", "recall_75", "pq"]
    for name in want:
        assert float(got[name]) == float(want[name]), (case, name)
    assert sorted(got_inst) == sorted(want_inst)
    for key in want_inst:
        np.testing.assert_array_equal(np.asarray(got_inst[key]),
                                      np.asarray(want_inst[key]))
    if case in ("perfect", "both_empty"):
        assert all(float(v) == pytest.approx(1.0, abs=1e-4)
                   for v in got.values())


def test_every_metric_matches_jax():
    """Each exported metric (including ap, f1, precision and recall at
    their own thresholds) on seeded match decompositions."""
    rng = np.random.default_rng(3)
    names = ["f1", "ap", "precision", "recall", "f1_50", "f1_75",
             "precision_50", "precision_75", "recall_50", "recall_75",
             "panoptic_quality"]
    for trial in range(20):
        n_m = int(rng.integers(0, 6))
        kwargs = dict(
            gt_matched=np.arange(n_m), pred_matched=np.arange(n_m),
            gt_unmatched=np.arange(int(rng.integers(0, 4))),
            pred_unmatched=np.arange(int(rng.integers(0, 4))),
            matched_ious=rng.random(n_m))
        for name in names:
            got = getattr(t_evaluation, name)(**kwargs)
            want = getattr(j_evaluation, name)(**kwargs)
            assert float(got) == float(want), (trial, name)
    ranges = np.array([[0, 10], [20, 5]])
    for gt, pred in ((ranges, ranges), (ranges, ranges[:1]),
                     (ranges[:0], ranges[:0]), (ranges, ranges[:0])):
        assert t_evaluation.iou(gt, pred) == j_evaluation.iou(gt, pred)


def test_evaluator_subsets_match_jax(tmp_path):
    """An Evaluator with only semantic metrics, and one with only
    instance metrics; mismatched classes refuse."""
    gt = _write(tmp_path, "gt", CASES["split"][0])
    pred = _write(tmp_path, "pred", CASES["split"][1])
    for group, name in (("semantic_metrics", "iou"),
                        ("instance_metrics", "f1")):
        got = t_eval.Evaluator(**{group: {
            name: getattr(t_evaluation, name)}})(gt, pred)
        want = j_eval.Evaluator(**{group: {
            name: getattr(j_evaluation, name)}})(gt, pred)
        assert got == want and list(got) == [name]
    with open(pred) as f:
        other = json.load(f)
    other["class_id"] = 2
    with open(tmp_path / "other.json", "w") as f:
        json.dump(other, f)
    with pytest.raises(AssertionError, match="classes must match"):
        t_eval.default_evaluator()(gt, str(tmp_path / "other.json"))


@pytest.mark.parametrize("overlap", [True, False])
def test_synthetic_em_volume_is_byte_identical(overlap):
    for shape, n, seed in (((24, 40, 56), 12, 0), ((32, 48, 48), 60, 7)):
        got = synthetic_em_volume(shape, n_instances=n, seed=seed,
                                  overlap=overlap)
        want = j_volume(shape, n_instances=n, seed=seed, overlap=overlap)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape == shape
            assert g.tobytes() == w.tobytes()


def test_disjoint_placement_is_disjoint_and_dense():
    _, gt = synthetic_em_volume((96, 128, 128), n_instances=120, seed=5,
                                overlap=False)
    labels, counts = np.unique(gt, return_counts=True)
    labels, counts = labels[labels > 0], counts[labels > 0]
    # every requested object exists and is a single connected ellipsoid
    assert len(labels) == 120
    assert counts.min() > 50
    per = [len(np.unique(gt[z][gt[z] > 0])) for z in range(0, 96, 8)]
    assert np.mean(per) > 15  # dense per-slice content


def test_tiny_cells_still_paint_every_instance():
    """Grid cells under ~4 px: the radius floor keeps every placement at
    least one voxel."""
    _, gt = synthetic_em_volume((32, 32, 32), n_instances=600, seed=3,
                                overlap=False)
    labels = np.unique(gt)
    assert len(labels[labels > 0]) == 600


def _run_gt_pipeline(gt, min_size=100, min_span=2, ld=20000):
    """Ground-truth panoptic slices through the port's host half:
    matching, tracking and orthoplane consensus."""
    from empanada_torch.core.ccl import image_to_runs
    from empanada_torch.inference import patterns
    from empanada_torch.inference.rle import runs_to_rle_seg

    axes = {"xy": 0, "xz": 1, "yz": 2}
    trackers = patterns.create_axis_trackers(axes, [1], ld, gt.shape)
    for axis_name, axis in axes.items():
        view = np.moveaxis(gt, axis, 0)
        matchers = patterns.create_matchers([1], ld, 0.25, 0.25)
        rle_stack = []
        for z in range(len(view)):
            pan = np.ascontiguousarray(view[z] + (view[z] > 0) * ld)
            s, e, v = image_to_runs(pan.astype(np.int32))
            seg = runs_to_rle_seg(s, e, v, pan.shape, [1], ld, [1])
            rle_stack.append(patterns.apply_matchers(seg, matchers))
        patterns.finish_axis(rle_stack, matchers, trackers[axis_name],
                             len(view), min_size, min_span)
    consensus = patterns.build_consensus(
        trackers, [1], [1], mode="orthoplane", pixel_vote_thr=2,
        cluster_iou_thr=0.75, min_size=min_size, min_span=min_span)
    return consensus[1].instances


def test_full_recovery_at_product_density():
    """Every disjoint ground-truth object above the size and span filters
    survives the port's matching, tracking and 3-axis consensus, one to
    one; the overlapping placement's nested fragments do not (a content
    artifact, as in the JAX package's test)."""
    _, gt = synthetic_em_volume((96, 128, 128), n_instances=120, seed=5,
                                overlap=False)
    assert len(_run_gt_pipeline(gt.astype(np.int32))) == 120
    _, gt = synthetic_em_volume((96, 128, 128), n_instances=120, seed=5,
                                overlap=True)
    n_gt = len(np.unique(gt[gt > 0]))
    assert len(_run_gt_pipeline(gt.astype(np.int32))) < 0.6 * n_gt


def test_stage_timer_and_trace(tmp_path):
    """The recorder's summary (seconds and count a name), and the
    exporter: trace.json and beside it the spans recorded while it was
    open; nothing written when it is disabled."""
    with profiling.recording() as spans:
        for _ in range(3):
            with profiling.span("forward"):
                pass
    summary = spans.summary()
    assert set(summary) == {"forward"} and summary["forward"]["count"] == 3
    assert summary["forward"]["total_s"] == pytest.approx(sum(
        (s.end_ns - s.start_ns) / 1e9 for s in spans))
    with profiling.trace(str(tmp_path / "trace")):
        with profiling.span("forward"):
            torch.ones(4).add_(1)
    assert json.loads((tmp_path / "trace" / "trace.json").read_text())
    written = json.loads((tmp_path / "trace" / "spans.json").read_text())
    assert [s["name"] for s in written["spans"]] == ["forward"]
    with profiling.trace(str(tmp_path / "off"), enabled=False):
        assert profiling.span("forward") is profiling.span("other")
    assert not (tmp_path / "off").exists()


def test_evaluate3d_command_on_cpu(tmp_path):
    """The command exports nothing itself: a tiny MitoNet descriptor, a
    volume with objects and their ground truth; the prediction it
    writes equals run_inference3d's, its scores equal the Evaluator's on
    that JSON, and the ground truth scored against itself is 1."""
    from empanada_torch.cli import evaluate3d
    from empanada_torch.cli.evaluate3d_bc import seg_to_tracker
    from empanada_torch.cli.infer3d import run_inference3d
    from empanada_torch.export import export_model, load_exported_model
    from empanada_torch.models import create_model

    cfg = {"arch": "PanopticBiFPNPR", "encoder": "regnety_200mf",
           "num_classes": 1, "fpn_dim": 32, "fpn_layers": 1,
           "subdivision_num_points": 256}
    model = create_model(cfg["arch"], device="cpu", seed=0,
                         **{k: v for k, v in cfg.items() if k != "arch"})
    export_model(model.state_dict(), cfg, str(tmp_path), "tiny",
                 norms={"mean": 0.5, "std": 0.2})
    vol, gt = synthetic_em_volume((8, 40, 48), n_instances=4, seed=2,
                                  radius=(3, 8))
    np.save(tmp_path / "vol.npy", vol)
    gt_json = str(tmp_path / "gt.json")
    seg_to_tracker(gt.astype(np.int64) + (gt > 0) * 1000,
                   label_divisor=1000).write_to_json(gt_json)
    flags = ["-mode", "stack", "-min-size", "4", "-min-span", "1",
             "-seg-thr", "0.5", "-nms-thr", "0.01"]
    results = evaluate3d.main([str(tmp_path / "tiny.yaml"),
                               str(tmp_path / "vol.npy"), gt_json,
                               "--device", "cpu", *flags])
    assert set(results) == {"iou", "f1_50", "f1_75", "precision_50",
                            "precision_75", "recall_50", "recall_75", "pq"}
    pred_json = str(tmp_path / "pred_class1.json")
    assert results == t_eval.default_evaluator()(gt_json, pred_json)

    model, desc = load_exported_model(str(tmp_path / "tiny.yaml"),
                                      device="cpu")
    want = run_inference3d(
        model, vol, labels=[1], thing_list=[1], mode="stack", qlen=3,
        label_divisor=20000, seg_thr=0.5, nms_thr=0.01, nms_kernel=3,
        min_size=4, min_span=1, norms=desc["norms"], device="cpu",
        progress=False)[1]
    got = InstanceTracker()
    got.load_from_json(pred_json)
    assert sorted(got.instances) == sorted(want.instances)
    for label, attrs in want.instances.items():
        np.testing.assert_array_equal(got.instances[label]["starts"],
                                      attrs["starts"])
    self_scores = t_eval.default_evaluator()(gt_json, gt_json)
    assert all(float(v) == pytest.approx(1.0, abs=1e-4)
               for v in self_scores.values())
