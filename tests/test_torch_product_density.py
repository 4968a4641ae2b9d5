"""Port parity: end-to-end object recovery at product instance density.

The port's counterpart of ``tests/test_product_density_recovery.py``
on its own ``data.synthetic``, ``core`` and ``inference.patterns``: the
same facts (disjoint placement is disjoint and dense; tiny cells still
paint every instance; the GT-driven host half recovers every disjoint
object; overlapping content collapses by data, not by pipeline), and on
the same ground-truth slices the port's host half, with the C++ host
core and with the numpy host half, equals the JAX package's instance for
instance.
"""

import pytest

pytest.importorskip("jax", reason="parity tests need the JAX package")

import numpy as np

from empanada_torch.core.ccl import image_to_runs
from empanada_torch.data.synthetic import synthetic_em_volume
from empanada_torch.inference import patterns
from empanada_torch.inference.rle import runs_to_rle_seg
from empanada_tpu.core.ccl import image_to_runs as jax_image_to_runs
from empanada_tpu.data.synthetic import (
    synthetic_em_volume as jax_synthetic_em_volume,
)
from empanada_tpu.inference import patterns as jax_patterns
from empanada_tpu.inference.rle import runs_to_rle_seg as jax_runs_to_rle_seg
from tests.test_torch_consensus import assert_instances_equal
from tests.test_torch_native import with_host_half

LD = 20000
DENSE = dict(shape=(96, 128, 128), n_instances=120, seed=5)


def _gt(overlap, shape, n_instances, seed):
    """The port's volume and ground truth, held byte for byte against
    the JAX package's draw."""
    vol, gt = synthetic_em_volume(shape, n_instances=n_instances, seed=seed,
                                  overlap=overlap)
    want_vol, want_gt = jax_synthetic_em_volume(
        shape, n_instances=n_instances, seed=seed, overlap=overlap)
    np.testing.assert_array_equal(vol, want_vol)
    np.testing.assert_array_equal(gt, want_gt)
    return gt


def _run_gt_pipeline(gt, pkg, to_runs, to_rle_seg, min_size=100,
                     min_span=2):
    """GT panoptic slices through matching, tracking and orthoplane
    consensus (the host half of run_inference3d) with one package's
    functions."""
    axes = {"xy": 0, "xz": 1, "yz": 2}
    trackers = pkg.create_axis_trackers(axes, [1], LD, gt.shape)
    for axis_name, axis in axes.items():
        view = gt if axis == 0 else np.moveaxis(gt, axis, 0)
        matchers = pkg.create_matchers([1], LD, 0.25, 0.25)
        rle_stack = []
        for z in range(len(view)):
            pan = (view[z] + (view[z] > 0) * LD).astype(np.int32)
            s, e, v = to_runs(np.ascontiguousarray(pan))
            seg = to_rle_seg(s, e, v, pan.shape, [1], LD, [1])
            rle_stack.append(pkg.apply_matchers(seg, matchers))
        pkg.finish_axis(rle_stack, matchers, trackers[axis_name],
                        len(view), min_size, min_span)
    consensus = pkg.build_consensus(
        trackers, [1], [1], mode="orthoplane", pixel_vote_thr=2,
        cluster_iou_thr=0.75, min_size=min_size, min_span=min_span)
    return consensus[1].instances


def _both_pipelines(gt, host_half):
    """(the port's instances with the named host half, the JAX
    package's)."""
    got = with_host_half(
        host_half, lambda: _run_gt_pipeline(gt, patterns, image_to_runs,
                                            runs_to_rle_seg),
        required=("runs_ccl", "pair_intersections"))
    want = _run_gt_pipeline(gt, jax_patterns, jax_image_to_runs,
                            jax_runs_to_rle_seg)
    return got, want


def test_disjoint_placement_is_disjoint_and_dense():
    gt = _gt(False, **DENSE)
    labels, counts = np.unique(gt, return_counts=True)
    labels, counts = labels[labels > 0], counts[labels > 0]
    assert len(labels) == 120
    assert counts.min() > 50
    per = [len(np.unique(gt[z][gt[z] > 0])) for z in range(0, 96, 8)]
    assert np.mean(per) > 15


def test_tiny_cells_still_paint_every_instance():
    """Grid cells under ~4 px: the radius floor keeps every placement at
    least one voxel."""
    gt = _gt(False, (32, 32, 32), 600, 3)
    labels = np.unique(gt)
    assert len(labels[labels > 0]) == 600


@pytest.mark.parametrize("host_half", ["native", "numpy"])
def test_full_recovery_at_product_density(host_half):
    """Every disjoint GT object survives matching, tracking and
    three-axis consensus, one to one, and the port's instances are the
    JAX package's."""
    gt = _gt(False, **DENSE).astype(np.int32)
    got, want = _both_pipelines(gt, host_half)
    assert len(got) == 120
    assert_instances_equal(got, want)


@pytest.mark.parametrize("host_half", ["native", "numpy"])
def test_overlapping_content_collapse_is_data_artifact(host_half):
    """Overlapping placement at high density makes nested fragments that
    IoA healing merges: recovery stays far below GT, in the port as in
    the JAX package, instance for instance."""
    gt = _gt(True, **DENSE).astype(np.int32)
    n_gt = len(np.unique(gt[gt > 0]))
    got, want = _both_pipelines(gt, host_half)
    assert len(got) < 0.6 * n_gt
    assert_instances_equal(got, want)
