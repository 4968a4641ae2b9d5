"""Port parity of the orthoplane path as a whole:
run_inference3d(mode="orthoplane") on the CPU must return consensus
trackers exactly equal to the JAX package's (labels, boxes, starts,
runs), with the same per-axis counts. Both sides run the parameter-free
synthetic model (tests/synthetic.py and empanada_torch.synthetic), so
every integer output is comparable; the tiny MitoNet run at the end has
a stated tolerance, since its maps are float32 sums in another order.
"""

import numpy as np
import pytest
import torch

for _dep in ("jax", "flax", "yaml"):
    pytest.importorskip(_dep, reason="parity tests need the JAX package")

import jax

from empanada_tpu.cli.infer3d import run_inference3d as jax_run_inference3d
from empanada_tpu.data import VolumeDataset as JaxVolumeDataset
from empanada_tpu.inference.fused import FusedStackEngine as JaxEngine
from empanada_tpu.models import create_model as flax_create_model
from empanada_torch.cli.infer3d import run_inference3d
from empanada_torch.core.fill import numpy_fill_instances
from empanada_torch.data import VolumeDataset
from empanada_torch.inference.fused import FusedStackEngine
from empanada_torch.models import create_model
from empanada_torch.ops.group import LAUNCHES
from empanada_torch.synthetic import SyntheticModule
from empanada_torch.weights import flax_to_torch
from tests.synthetic import SyntheticModule as JaxSyntheticModule
from tests.test_torch_consensus import assert_instances_equal
from tests.test_torch_models import TINY, _randomize
from tests.test_torch_native import with_host_half
from tests.test_torch_stack import _blob_volume, _collect, _ellipsoid

COUNTS = ("slices", "overflow_slices", "instances_matched")


def _volume(name):
    """(volume, norms, min_size). The blob volume is not a cube and no
    side is a multiple of the padding factor (16)."""
    if name == "ellipsoid":
        return _ellipsoid(), None, 4
    return _blob_volume(seed=3, d=19, h=30, w=27, n_blobs=6), \
        {"mean": 0.5, "std": 0.2}, 10


def _both(volume, **settings):
    vol, norms, min_size = _volume(volume)
    kwargs = dict(labels=[1], thing_list=[1], mode="orthoplane",
                  label_divisor=100, padding_factor=16, max_centers=64,
                  min_size=min_size, min_span=1, progress=False, norms=norms)
    kwargs.update(settings)
    jax_kwargs = dict(kwargs)
    if "save_panoptic_dir" in kwargs:
        jax_kwargs["save_panoptic_dir"] = kwargs["save_panoptic_dir"] + "_jax"
    want_stats, got_stats = {}, {}
    want = jax_run_inference3d((JaxSyntheticModule(), {}), vol,
                               stats=want_stats, **jax_kwargs)
    got = run_inference3d(SyntheticModule(), vol, device="cpu",
                          stats=got_stats, **kwargs)
    return vol, want, got, want_stats, got_stats


@pytest.mark.parametrize(
    "volume, pixel_vote_thr, one_view, qlen, block_size", [
        # the settings of the repo's own orthoplane flow check
        ("ellipsoid", 2, False, 3, 4),
        ("ellipsoid", 1, True, 3, 4),
        ("ellipsoid", 3, False, 5, None),
        ("blobs", 2, False, 3, None),
        ("blobs", 1, False, 5, 4),
        ("blobs", 3, False, 3, 8),
        ("blobs", 2, True, 5, None),
        ("blobs", 1, True, 3, 4),
    ])
def test_orthoplane_matches_jax(volume, pixel_vote_thr, one_view, qlen,
                                block_size):
    vol, want, got, want_stats, got_stats = _both(
        volume, pixel_vote_thr=pixel_vote_thr, one_view=one_view, qlen=qlen,
        block_size=block_size)
    assert sorted(got) == sorted(want) == [1]
    assert got[1].shape3d == want[1].shape3d == vol.shape
    assert_instances_equal(got[1].instances, want[1].instances)
    if pixel_vote_thr < 3:
        assert len(got[1].instances) >= 1
    assert sorted(got_stats["axes"]) == sorted(want_stats["axes"]) == \
        ["xy", "xz", "yz"]
    for axis, n in zip(("xy", "xz", "yz"), vol.shape):
        for key in COUNTS:
            assert got_stats["axes"][axis][key] == \
                want_stats["axes"][axis][key], (axis, key)
        assert got_stats["axes"][axis]["slices"] == n
        assert got_stats["axes"][axis]["instances_matched"] > 0
    assert got_stats["instances_3d"] == want_stats["instances_3d"]


@pytest.mark.parametrize("host_half", ["native", "numpy"])
def test_orthoplane_host_halves_match_jax(host_half):
    """The orthoplane comparison with the host half named: the C++ core
    (the default; the three axes' host threads and the consensus must
    have called it) and the numpy paths (asked for; no native call).
    Both give the JAX package's consensus exactly."""
    vol, want, got, want_stats, got_stats = with_host_half(
        host_half, lambda: _both("blobs", pixel_vote_thr=2, qlen=3),
        required=("runs_ccl", "pair_intersections", "kway_vote"))
    assert got[1].shape3d == want[1].shape3d == vol.shape
    assert len(got[1].instances) >= 1
    assert_instances_equal(got[1].instances, want[1].instances)
    for axis in ("xy", "xz", "yz"):
        for key in COUNTS:
            assert got_stats["axes"][axis][key] == \
                want_stats["axes"][axis][key], (axis, key)


def test_save_panoptic_crops_each_axis(tmp_path):
    """save_panoptic_dir: one array per axis, cropped to that axis's own
    slice shape (the padded maps differ per axis on a volume that is not
    a cube), equal to the JAX package's."""
    out_dir = str(tmp_path / "pan")
    vol, want, got, _, _ = _both("blobs", pixel_vote_thr=2, qlen=3,
                                 save_panoptic_dir=out_dir)
    assert_instances_equal(got[1].instances, want[1].instances)
    d, h, w = vol.shape
    for axis, shape in (("xy", (d, h, w)), ("xz", (h, d, w)),
                        ("yz", (w, d, h))):
        pan = np.load(f"{out_dir}/panoptic_{axis}.npy")
        ref = np.load(f"{out_dir}_jax/panoptic_{axis}.npy")
        assert pan.shape == shape, axis
        np.testing.assert_array_equal(pan, ref, err_msg=axis)
        assert (pan > 0).any()


def test_one_engine_serves_three_slice_shapes():
    """One engine, three axes in turn: a different automatic block size
    per axis, pad mask and crop header per slice shape, and a median
    carry that starts empty on every axis. Packed rows and maps equal the
    JAX engine's and a fresh engine's."""
    vol = _blob_volume(seed=5, d=21, h=50, w=37, n_blobs=8)
    kwargs = dict(thing_list=[1], label_divisor=100, stuff_area=0,
                  median_kernel_size=5, padding_factor=16, max_centers=64,
                  device_norms={"mean": 0.5, "std": 0.2})
    engine = FusedStackEngine(SyntheticModule(), None, device="cpu", **kwargs)
    jax_engine = JaxEngine(JaxSyntheticModule(), {}, **kwargs)
    block_sizes = []
    for axis in range(3):
        n = vol.shape[axis]
        got = _collect(engine.infer_blocks(VolumeDataset(vol, axis=axis)), n)
        want = _collect(jax_engine.infer_blocks(
            JaxVolumeDataset(vol, axis=axis)), n)
        fresh = _collect(
            FusedStackEngine(SyntheticModule(), None, device="cpu", **kwargs)
            .infer_blocks(VolumeDataset(vol, axis=axis)), n)
        size = tuple(s for a, s in enumerate(vol.shape) if a != axis)
        for z in range(n):
            np.testing.assert_array_equal(got[z][0], want[z][0])
            np.testing.assert_array_equal(got[z][1], want[z][1])
            np.testing.assert_array_equal(got[z][1], fresh[z][1])
            assert tuple(got[z][1][0, 1:]) == size  # the crop header
            assert got[z][0].shape == tuple(-(-s // 16) * 16 for s in size)
        padded = tuple(-(-s // 16) * 16 for s in size)
        block_sizes.append(engine._resolve_block(padded, n))
        assert engine.last_dispatch_count == -(-(n + 2) // block_sizes[-1])
    assert len(set(block_sizes)) == 3, block_sizes


def test_tiny_mitonet_orthoplane_end_to_end_on_cpu(tmp_path):
    """The tiny MitoNet (regnety_200mf, fpn_layers=1), weights through
    flax_to_torch, runs the orthoplane path on the CPU end to end: plain
    grouping (no kernel launch), the same per-axis slice counts as the
    JAX package. Tolerance: the models agree to 1e-4 of max |value|
    (float32, another summation order), so a pixel at a decision
    threshold may flip: at most 0.5% of each axis's panoptic pixels and
    1% of the filled voxels may differ."""
    flax_model = flax_create_model("PanopticBiFPNPR", **TINY)
    init = flax_model.init(
        {"params": jax.random.key(0), "points": jax.random.key(1),
         "dropout": jax.random.key(2)},
        np.zeros((1, 128, 128, 1), np.float32), train=False)
    variables = _randomize(init, seed=3)
    model = create_model("PanopticBiFPNPR", device="cpu", **TINY)
    model.load_state_dict(flax_to_torch(variables, expect=model))

    rng = np.random.default_rng(12)
    vol = rng.integers(0, 255, (14, 40, 52)).astype(np.uint8)
    kwargs = dict(labels=[1], thing_list=[1], mode="orthoplane",
                  norms={"mean": 0.57, "std": 0.12}, min_size=20, min_span=2,
                  progress=False, block_size=8)
    want_stats, got_stats = {}, {}
    want = jax_run_inference3d((flax_model, variables), vol,
                               stats=want_stats,
                               save_panoptic_dir=str(tmp_path / "jax"),
                               **kwargs)
    launches = LAUNCHES["group_pixels"]
    got = run_inference3d(model, vol, device="cpu", stats=got_stats,
                          save_panoptic_dir=str(tmp_path / "torch"),
                          **kwargs)
    assert LAUNCHES["group_pixels"] == launches
    assert sorted(got) == [1] and got[1].shape3d == vol.shape
    for axis, n in zip(("xy", "xz", "yz"), vol.shape):
        assert got_stats["axes"][axis]["slices"] == \
            want_stats["axes"][axis]["slices"] == n
        pan = np.load(tmp_path / "torch" / f"panoptic_{axis}.npy")
        ref = np.load(tmp_path / "jax" / f"panoptic_{axis}.npy")
        assert pan.shape == ref.shape
        assert (pan > 0).any()
        assert ((pan > 0) != (ref > 0)).mean() <= 0.005, axis
    filled = [numpy_fill_instances(np.zeros(vol.shape, np.uint32),
                                   t[1].instances) for t in (got, want)]
    assert ((filled[0] > 0) != (filled[1] > 0)).mean() <= 0.01
    with torch.inference_mode():
        maps = model(torch.from_numpy(rng.normal(0, 1, (1, 1, 128, 128))
                                      .astype(np.float32)))
    assert all(torch.isfinite(v).all() for v in maps.values())
