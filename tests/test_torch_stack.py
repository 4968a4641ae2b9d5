"""Port parity of the stack-mode path: the blocked engine's packed rows
and run_inference3d(mode="stack") instance RLEs must equal the JAX
package's exactly. Both sides run a parameter-free synthetic model with
decisive maps (tests/synthetic.py and its torch twin
empanada_torch.synthetic), so every integer output is comparable.
"""

import numpy as np
import pytest
import torch

# the JAX package's third-party dependencies: where only the port's are
# installed, these parity tests skip
for _dep in ("jax", "flax", "yaml"):
    pytest.importorskip(_dep, reason="parity tests need the JAX package")

from empanada_tpu.cli.infer3d import run_inference3d as jax_run_inference3d
from empanada_tpu.inference.fused import FusedStackEngine as JaxEngine
from empanada_torch.cli.infer3d import run_inference3d
from empanada_torch.inference.fused import FusedStackEngine
from empanada_torch.models import create_model
from empanada_torch.ops.group import LAUNCHES
from empanada_torch.synthetic import SyntheticModule
from tests.synthetic import SyntheticModule as JaxSyntheticModule
from tests.test_torch_native import with_host_half


class _DS:
    def __init__(self, vol):
        self.vol = vol

    def __len__(self):
        return len(self.vol)

    def __getitem__(self, i):
        return {"index": i, "image": self.vol[i], "size": self.vol[i].shape}


def _blob_volume(seed, d=11, h=30, w=27, n_blobs=4):
    """uint8 volume with several bright ellipsoids on dim noise: several
    centers per slice, and a slice shape that is not a pad multiple."""
    rng = np.random.default_rng(seed)
    vol = rng.integers(0, 100, (d, h, w)).astype(np.uint8)
    zz, yy, xx = np.mgrid[:d, :h, :w]
    for _ in range(n_blobs):
        cz, cy, cx = rng.uniform(0, d), rng.uniform(3, h - 3), \
            rng.uniform(3, w - 3)
        r = rng.uniform(2.5, 5)
        vol[((zz - cz) / 2.5) ** 2 + ((yy - cy) / r) ** 2
            + ((xx - cx) / r) ** 2 <= 1] = 250
    return vol


def _ellipsoid():
    shape = (12, 32, 32)
    zz, yy, xx = np.mgrid[: shape[0], : shape[1], : shape[2]]
    return (((zz - 6.0) ** 2 / 16 + (yy - 15.0) ** 2 / 64
             + (xx - 16.0) ** 2 / 49) <= 1.0).astype(np.float32)


def _collect(block_iter, d):
    got = {}
    for z_indices, pan, packed in block_iter:
        arr = np.asarray(packed).reshape(len(z_indices), -1, 3)
        pan = np.asarray(pan)
        for j, z in enumerate(z_indices):
            if z is not None:
                got[z] = (pan[j], arr[j])
    assert sorted(got) == list(range(d))
    return got


@pytest.mark.parametrize("qlen", [3, 5])
@pytest.mark.parametrize("block_size", [4, 8])
def test_engine_packed_rows_match_jax(qlen, block_size):
    vol = _blob_volume(seed=qlen * 10 + block_size)
    kwargs = dict(thing_list=[1], label_divisor=100, stuff_area=0,
                  median_kernel_size=qlen, padding_factor=16, max_centers=64,
                  block_size=block_size,
                  device_norms={"mean": 0.5, "std": 0.2})
    want = _collect(JaxEngine(JaxSyntheticModule(), {}, **kwargs)
                    .infer_blocks(_DS(vol)), len(vol))
    engine = FusedStackEngine(SyntheticModule(), None, device="cpu",
                              **kwargs)
    got = _collect(engine.infer_blocks(_DS(vol)), len(vol))
    n_fg = 0
    for z in range(len(vol)):
        np.testing.assert_array_equal(got[z][0], want[z][0], err_msg=str(z))
        np.testing.assert_array_equal(got[z][1], want[z][1], err_msg=str(z))
        n_fg += int(got[z][1][0, 0])
    assert n_fg > 0
    assert engine.last_dispatch_count == -(-(len(vol) + qlen // 2)
                                           // block_size)


class _FineTwin(SyntheticModule):
    """The torch twin with the center heatmap and offsets repeated 4x
    when ``interpolate_ins`` (the fine-boundary contract)."""

    def forward(self, images, render_steps=2, interpolate_ins=False):
        out = super().forward(images, render_steps)
        if interpolate_ins:
            for key in ("ctr_hmp", "offsets"):
                out[key] = out[key].repeat_interleave(4, 2) \
                    .repeat_interleave(4, 3)
        return out


class _JaxFineTwin(JaxSyntheticModule):
    def apply(self, variables, images, train=False, render_steps=2,
              interpolate_ins=False, **_):
        import jax.numpy as jnp

        out = super().apply(variables, images, train, render_steps)
        if interpolate_ins:
            for key in ("ctr_hmp", "offsets"):
                out[key] = jnp.repeat(jnp.repeat(out[key], 4, axis=1), 4,
                                      axis=2)
        return out


class _UpDS(_DS):
    """Slices as a downsampled volume gives them: the size is the
    full-resolution one."""

    def __getitem__(self, i):
        ex = super().__getitem__(i)
        ex["size"] = tuple(2 * s for s in ex["size"])
        return ex


# engine branches beyond test_engine_packed_rows_match_jax's: the
# shortest and a long median window, PointRend upsampling 2 (render
# steps 3), the automatic block size, and fine boundaries (grouping at
# full resolution)
@pytest.mark.parametrize("case", [
    dict(qlen=1), dict(qlen=7), dict(upsampling=2),
    dict(block_size=None), dict(coarse_boundaries=False)],
    ids=["qlen1", "qlen7", "upsampling2", "auto_block", "fine_boundaries"])
def test_engine_branches_match_jax(case):
    case = dict(case)
    upsampling = case.pop("upsampling", 1)
    qlen = case.pop("qlen", 3)
    coarse = case.get("coarse_boundaries", True)
    vol = _blob_volume(seed=40 + qlen + 3 * upsampling, d=13)
    kwargs = dict(dict(thing_list=[1], label_divisor=100, stuff_area=0,
                       median_kernel_size=qlen, padding_factor=16,
                       max_centers=64, block_size=4,
                       device_norms={"mean": 0.5, "std": 0.2}), **case)
    ds = _UpDS(vol) if upsampling > 1 else _DS(vol)
    jax_twin = JaxSyntheticModule() if coarse else _JaxFineTwin()
    torch_twin = SyntheticModule() if coarse else _FineTwin()
    want = _collect(JaxEngine(jax_twin, {}, **kwargs)
                    .infer_blocks(ds, upsampling), len(vol))
    got = _collect(FusedStackEngine(torch_twin, None, device="cpu", **kwargs)
                   .infer_blocks(ds, upsampling), len(vol))
    n_fg = 0
    for z in range(len(vol)):
        np.testing.assert_array_equal(got[z][0], want[z][0], err_msg=str(z))
        np.testing.assert_array_equal(got[z][1], want[z][1], err_msg=str(z))
        n_fg += int(got[z][1][0, 0])
    assert n_fg > 0
    if upsampling > 1:
        assert got[0][0].shape[-1] >= 2 * vol.shape[2]


@pytest.mark.parametrize("n_classes", [3, 24])
def test_class_pool_matches_serial_apply_matchers(n_classes):
    """Thing classes matched in ForwardMatcher's class pool (one thread a
    class; 24 is more threads than cores, with a short switch interval):
    the pool threads return each class's result and the coordinating
    thread writes the slice's dict; the trackers equal those of the
    serial apply_matchers loop, RLE for RLE."""
    import sys

    from empanada_torch.inference import patterns
    from empanada_torch.inference.rle import pan_seg_to_rle_seg

    classes, ld = list(range(1, n_classes + 1)), 1000
    rng = np.random.default_rng(8)
    d, h, w = 12, 40, 44
    zz, yy, xx = np.mgrid[:d, :h, :w]
    pan = np.zeros((d, h, w), np.int32)
    for k in range(max(9, n_classes)):
        c = classes[k % n_classes]
        cz, cy, cx = rng.uniform(2, d - 2), rng.uniform(5, h - 5), \
            rng.uniform(5, w - 5)
        inside = ((zz - cz) / 3.0) ** 2 + ((yy - cy) / 5.0) ** 2 \
            + ((xx - cx) / 6.0) ** 2 <= 1
        # a new id on every other slice: the matchers must relink them
        pan[inside] = c * ld + 1 + k + (zz[inside] % 2) * 50

    def trackers_from(stack):
        matchers = patterns.create_matchers(classes, ld)
        trackers = patterns.create_axis_trackers({"xy": 0}, classes, ld,
                                                 pan.shape)["xy"]
        patterns.finish_axis(stack(matchers), matchers, trackers, d, 1, 1)
        return trackers

    def pooled(matchers):
        fm = patterns.ForwardMatcher(matchers, classes, ld, classes)
        assert fm._class_pool is not None
        for z in range(d):
            fm.put(pan[z])
        return fm.finish()

    def serial(matchers):
        return [patterns.apply_matchers(
            pan_seg_to_rle_seg(pan[z], classes, ld, classes), matchers)
            for z in range(d)]

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = trackers_from(pooled)
    finally:
        sys.setswitchinterval(interval)
    want = trackers_from(serial)
    assert len(got) == len(want) == n_classes
    for g, t in zip(got, want):
        assert g.class_id == t.class_id
        assert len(t.instances) >= 1
        assert sorted(g.instances) == sorted(t.instances)
        for label, attrs in t.instances.items():
            assert tuple(g.instances[label]["box"]) == tuple(attrs["box"])
            np.testing.assert_array_equal(g.instances[label]["starts"],
                                          attrs["starts"])
            np.testing.assert_array_equal(g.instances[label]["runs"],
                                          attrs["runs"])


def test_engine_overflow_and_auto_budget_match_jax():
    """A tiny run budget overflows: the header still carries the true
    count, the buffer the first runs; the auto budget and block size
    follow the JAX rules."""
    vol = np.zeros((5, 64, 64), np.float32)
    vol[:, 4:, ::2] = 1.0
    kwargs = dict(thing_list=[1], label_divisor=100, stuff_area=0,
                  median_kernel_size=3, padding_factor=16, max_centers=16,
                  block_size=4, max_runs=64)
    want = _collect(JaxEngine(JaxSyntheticModule(), {}, **kwargs)
                    .infer_blocks(_DS(vol)), 5)
    got = _collect(FusedStackEngine(SyntheticModule(), None, device="cpu",
                                    **kwargs).infer_blocks(_DS(vol)), 5)
    for z in range(5):
        assert got[z][1][0, 0] > 64
        np.testing.assert_array_equal(got[z][1], want[z][1])

    engine = FusedStackEngine(SyntheticModule(), None, [1], device="cpu")
    jax_engine = JaxEngine.__new__(JaxEngine)
    jax_engine.max_centers, jax_engine.block_size = 256, None
    jax_engine.mid, jax_engine._mesh = 1, None
    for hw in ((128, 128), (512, 512), (1024, 1024), (128, 384)):
        assert engine._auto_max_runs(*hw) == jax_engine._auto_max_runs(*hw)
        for n in (3, 16, 100):
            assert engine._resolve_block(hw, n) == \
                jax_engine._resolve_block(hw, n)


@pytest.mark.parametrize("volume", ["ellipsoid", "blobs"])
def test_run_inference3d_stack_matches_jax(volume):
    if volume == "ellipsoid":
        vol, norms, min_size = _ellipsoid(), None, 4
    else:
        vol, norms, min_size = _blob_volume(seed=3, d=9), \
            {"mean": 0.5, "std": 0.2}, 10
    kwargs = dict(labels=[1], thing_list=[1], mode="stack", qlen=3,
                  label_divisor=100, block_size=4, padding_factor=16,
                  max_centers=64, min_size=min_size, min_span=1,
                  progress=False, norms=norms)
    want = jax_run_inference3d((JaxSyntheticModule(), {}), vol, **kwargs)
    stats = {}
    got = run_inference3d(SyntheticModule(), vol, device="cpu", stats=stats,
                          **kwargs)
    assert sorted(got) == sorted(want) == [1]
    ins_w, ins_g = want[1].instances, got[1].instances
    assert len(ins_w) >= 1
    assert sorted(ins_g) == sorted(ins_w)
    for label, attrs in ins_w.items():
        assert tuple(ins_g[label]["box"]) == tuple(attrs["box"]), label
        np.testing.assert_array_equal(ins_g[label]["starts"], attrs["starts"])
        np.testing.assert_array_equal(ins_g[label]["runs"], attrs["runs"])
    assert stats["axes"]["xy"]["slices"] == len(vol)


# entry points of the C++ host core that the stack path's host half calls
# on a volume with several instances a slice
STACK_ENTRY_POINTS = ("runs_ccl", "pair_intersections")


@pytest.mark.parametrize("host_half", ["native", "numpy"])
def test_run_inference3d_stack_host_halves_match_jax(host_half):
    """The same comparison with the host half named: the C++ core (the
    default; its entry points must have been called) and the numpy
    paths (asked for; the library must not have been called). Both give
    the JAX package's instances exactly."""
    vol = _blob_volume(seed=3, d=9)
    kwargs = dict(labels=[1], thing_list=[1], mode="stack", qlen=3,
                  label_divisor=100, block_size=4, padding_factor=16,
                  max_centers=64, min_size=10, min_span=1, progress=False,
                  norms={"mean": 0.5, "std": 0.2})
    want = jax_run_inference3d((JaxSyntheticModule(), {}), vol, **kwargs)
    got = with_host_half(
        host_half, lambda: run_inference3d(SyntheticModule(), vol,
                                           device="cpu", **kwargs),
        required=STACK_ENTRY_POINTS)
    ins_w, ins_g = want[1].instances, got[1].instances
    assert len(ins_w) >= 1 and list(ins_g) == list(ins_w)
    for label, attrs in ins_w.items():
        assert tuple(ins_g[label]["box"]) == tuple(attrs["box"]), label
        np.testing.assert_array_equal(ins_g[label]["starts"], attrs["starts"])
        np.testing.assert_array_equal(ins_g[label]["runs"], attrs["runs"])


def test_tiny_mitonet_stack_end_to_end_on_cpu():
    """The tiny MitoNet from a seeded init runs the whole stack path on
    the CPU: plain grouping (no kernel launch), finite maps, a tracker."""
    model = create_model("PanopticBiFPNPR", device="cpu", seed=0,
                         encoder="regnety_200mf", fpn_layers=1,
                         num_classes=1, subdivision_num_points=256)
    rng = np.random.default_rng(12)
    vol = rng.integers(0, 255, (5, 100, 140)).astype(np.uint8)
    launches = LAUNCHES["group_pixels"]
    stats = {}
    out = run_inference3d(model, vol, labels=[1], thing_list=[1],
                          mode="stack", norms={"mean": 0.57, "std": 0.12},
                          min_size=20, min_span=2, progress=False,
                          device="cpu", stats=stats)
    assert LAUNCHES["group_pixels"] == launches
    assert sorted(out) == [1] and out[1].shape3d == vol.shape
    assert stats["axes"]["xy"]["slices"] == 5
    with torch.inference_mode():
        maps = model(torch.from_numpy(rng.normal(0, 1, (1, 1, 128, 128))
                                      .astype(np.float32)))
    assert all(torch.isfinite(v).all() for v in maps.values())
