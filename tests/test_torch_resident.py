"""The port's device-resident volume path and its block FLOP count, on
the CPU: ``FusedStackEngine.infer_blocks_resident`` emits exactly the
streaming path's maps and packed runs (host ndarray and an axis-permuted
tensor, chunked and not; the torch synthetic twin and the tiny MitoNet)
and exactly the JAX package's resident blocks (synthetic twins);
``run_inference3d(resident=True)`` equals the JAX package's consensus
RLE for RLE and streams exactly where the JAX gate does;
``multihost_run_inference3d`` at world 1 runs on the resident path and
equals the local flow; ``infer3d --resident`` writes what streaming
writes; ``block_cost_analysis`` equals an analytic count of the tiny
MitoNet's convolutions and products. Integer outputs: exact."""

import numpy as np
import pytest
import torch

for _dep in ("jax", "flax", "yaml"):
    pytest.importorskip(_dep, reason="parity tests need the JAX package")

from empanada_tpu.cli.infer3d import run_inference3d as jax_run_inference3d
from empanada_tpu.data import zarr_store as jax_zarr_store
from empanada_tpu.inference.fused import FusedStackEngine as JaxEngine
from empanada_tpu.parallel.mesh import create_mesh as jax_create_mesh
from empanada_torch.cli.infer3d import run_inference3d
from empanada_torch.data import zarr_store
from empanada_torch.inference.fused import FusedStackEngine
from empanada_torch.models import create_model
from empanada_torch.parallel import create_mesh
from empanada_torch.parallel.multihost import multihost_run_inference3d
from empanada_torch.synthetic import SyntheticModule
from tests.synthetic import SyntheticModule as JaxSyntheticModule
from tests.test_multihost import blob_volume, canonical
from tests.test_torch_models import TINY
from tests.test_torch_stack import _DS, _blob_volume, _collect

ENGINE = dict(thing_list=[1], label_divisor=100, stuff_area=0,
              median_kernel_size=3, padding_factor=16, max_centers=64,
              block_size=4, device_norms={"mean": 0.5, "std": 0.2})
SETTINGS = dict(labels=[1], thing_list=[1], qlen=3, label_divisor=100,
                block_size=4, padding_factor=16, max_centers=64,
                min_size=10, min_span=1, progress=False)
NORMS = {"mean": 0.5, "std": 0.2}


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for z in want:
        np.testing.assert_array_equal(got[z][0], want[z][0], err_msg=str(z))
        np.testing.assert_array_equal(got[z][1], want[z][1], err_msg=str(z))


def _permuted(vol):
    """The volume as a tensor whose z axis is not its first in memory."""
    stored = torch.from_numpy(np.ascontiguousarray(np.moveaxis(vol, 0, 2)))
    view = torch.movedim(stored, 2, 0)
    assert not view.is_contiguous()
    return view


def _spy(monkeypatch, cls):
    """Count the calls of the engine class's two block paths."""
    calls = {"infer_blocks": 0, "infer_blocks_resident": 0}
    for name in calls:
        def wrapped(self, *args, _name=name, _orig=getattr(cls, name),
                    **kwargs):
            calls[_name] += 1
            return _orig(self, *args, **kwargs)
        monkeypatch.setattr(cls, name, wrapped)
    return calls


@pytest.mark.parametrize("route", ["ndarray", "tensor"])
@pytest.mark.parametrize("chunk_slices", [None, 4, 8])
def test_resident_blocks_equal_streaming(route, chunk_slices):
    vol = _blob_volume(seed=7, d=13)
    engine = FusedStackEngine(SyntheticModule(), None, device="cpu",
                              **ENGINE)
    want = _collect(engine.infer_blocks(_DS(vol)), len(vol))
    assert sum(int(want[z][1][0, 0]) for z in want) > 0
    source = vol if route == "ndarray" else _permuted(vol)
    got = _collect(engine.infer_blocks_resident(
        source, chunk_slices=chunk_slices), len(vol))
    _assert_same(got, want)
    assert engine.last_dispatch_count == -(-(len(vol) + 1) // 4)


def test_resident_casts_without_device_norms():
    """No device normalization: the volume is cast to float32, as the
    streaming path casts each slice."""
    vol = blob_volume()
    kwargs = dict(ENGINE, device_norms=None)
    engine = FusedStackEngine(SyntheticModule(), None, device="cpu",
                              **kwargs)
    want = _collect(engine.infer_blocks(_DS(vol)), len(vol))
    got = _collect(engine.infer_blocks_resident(
        vol.astype(np.float64), chunk_slices=4), len(vol))
    _assert_same(got, want)


@pytest.mark.parametrize("chunk_slices", [None, 4])
def test_resident_blocks_equal_jax(chunk_slices):
    vol = _blob_volume(seed=8, d=11)
    want = _collect(JaxEngine(JaxSyntheticModule(), {}, scan_blocks=1,
                              **ENGINE)
                    .infer_blocks_resident(vol, chunk_slices=chunk_slices),
                    len(vol))
    got = _collect(FusedStackEngine(SyntheticModule(), None, device="cpu",
                                    **ENGINE)
                   .infer_blocks_resident(vol, chunk_slices=chunk_slices),
                   len(vol))
    _assert_same(got, want)


def test_resident_refusals():
    """A mesh, a downsampled pass and a tensor on another device are
    refused; ``scan_blocks`` is not a setting of the port's engine."""
    vol = _blob_volume(seed=1, d=5)
    mesh_engine = FusedStackEngine(
        SyntheticModule(), None,
        mesh=create_mesh(devices=[torch.device("cpu")] * 2), **ENGINE)
    with pytest.raises(ValueError, match="one device"):
        next(mesh_engine.infer_blocks_resident(vol))
    engine = FusedStackEngine(SyntheticModule(), None, device="cpu",
                              **ENGINE)
    with pytest.raises(ValueError, match="full-resolution"):
        next(engine.infer_blocks_resident(vol, upsampling=2))
    with pytest.raises(ValueError, match="volume on meta"):
        next(engine.infer_blocks_resident(
            torch.zeros(vol.shape, dtype=torch.uint8, device="meta")))
    with pytest.raises(TypeError, match="scan_blocks"):
        FusedStackEngine(SyntheticModule(), None, device="cpu",
                         scan_blocks=2, **ENGINE)


def test_run_inference3d_resident_matches_jax(monkeypatch):
    vol = _blob_volume(seed=3, d=11)
    kwargs = dict(SETTINGS, mode="orthoplane", norms=NORMS, resident=True)
    want = jax_run_inference3d((JaxSyntheticModule(), {}), vol, **kwargs)
    calls = _spy(monkeypatch, FusedStackEngine)
    stats = {}
    got = run_inference3d(SyntheticModule(), vol, device="cpu",
                          stats=stats, **kwargs)
    assert calls == {"infer_blocks": 0, "infer_blocks_resident": 3}
    assert stats["upload_bytes"] == vol.nbytes
    assert canonical(got) == canonical(want)
    assert sum(len(v) for v in canonical(got).values()) > 0


def _gate_case(case, package, tmp_path):
    """(volume, run_inference3d kwargs) of a gate case for a package."""
    vol = _blob_volume(seed=4, d=9)
    kwargs = dict(SETTINGS, mode="stack", norms=NORMS, resident=True)
    if case == "no device_norms":
        vol, kwargs["norms"] = blob_volume(), None
    elif case == "downsample_f":
        kwargs["downsample_f"] = 2
    elif case == "mesh":
        kwargs["mesh"] = (create_mesh(devices=[torch.device("cpu")] * 2)
                          if package == "torch" else jax_create_mesh(2))
    elif case == "zarr":
        store = (zarr_store if package == "torch" else jax_zarr_store)
        path = str(tmp_path / f"{package}.zarr")
        store.create_zarr(path, vol.shape, dtype=np.uint8)[:] = vol
        vol = store.read_volume(path)
        assert not isinstance(vol, np.ndarray)
    return vol, kwargs


@pytest.mark.parametrize("case", ["gate met", "mesh", "downsample_f",
                                  "no device_norms", "zarr"])
def test_resident_gate_streams_where_jax_does(case, monkeypatch, tmp_path):
    torch_calls = _spy(monkeypatch, FusedStackEngine)
    jax_calls = _spy(monkeypatch, JaxEngine)
    vol, kwargs = _gate_case(case, "jax", tmp_path)
    jax_run_inference3d((JaxSyntheticModule(), {}), vol, **kwargs)
    vol, kwargs = _gate_case(case, "torch", tmp_path)
    run_inference3d(SyntheticModule(), vol, device="cpu", **kwargs)
    resident = case == "gate met"
    assert torch_calls == jax_calls == {
        "infer_blocks": int(not resident),
        "infer_blocks_resident": int(resident)}


def test_multihost_world_one_runs_resident(monkeypatch):
    vol = _blob_volume(seed=5, d=11)
    want = run_inference3d(SyntheticModule(), vol, device="cpu",
                           norms=NORMS, **SETTINGS)
    calls = _spy(monkeypatch, FusedStackEngine)
    stats = {}
    got = multihost_run_inference3d(SyntheticModule(), vol, device="cpu",
                                    norms=NORMS, stats=stats,
                                    **dict(SETTINGS, progress=False))
    assert calls == {"infer_blocks": 0, "infer_blocks_resident": 3}
    assert canonical(got) == canonical(want)
    assert [stats[a]["slices"] for a in ("xy", "xz", "yz")] == \
        list(vol.shape)


@pytest.fixture(scope="module")
def tiny_mitonet():
    return create_model("PanopticBiFPNPR", device="cpu", seed=0, **TINY)


def test_tiny_mitonet_resident_equals_streaming(tiny_mitonet):
    """Slices of 128 x 140 (padded to 128 x 256), blocks of 4, chunks of
    4; then the block's FLOPs against 2 * N * Cout * Hout * Wout *
    Cin / groups * kh * kw summed over the model's convolutions (input
    size for a transposed one) and 2 * rows * in * out over its linear
    layers."""
    vol = np.random.default_rng(6).integers(0, 255, (7, 128, 140),
                                            dtype=np.uint8)
    engine = FusedStackEngine(
        tiny_mitonet, None, [1], block_size=4, label_divisor=20000,
        stuff_area=0, device_norms={"mean": 0.57, "std": 0.12},
        device="cpu")
    assert engine.block_cost_analysis() is None
    want = _collect(engine.infer_blocks(_DS(vol)), len(vol))
    for source in (vol, _permuted(vol)):
        got = _collect(engine.infer_blocks_resident(source, chunk_slices=4),
                       len(vol))
        _assert_same(got, want)

    flops = []

    def count(module, inputs, output):
        x = inputs[0]
        if isinstance(module, torch.nn.Linear):
            flops.append(2 * x.numel() // x.shape[-1] * module.in_features
                         * module.out_features)
            return
        kh, kw = module.kernel_size
        if isinstance(module, torch.nn.ConvTranspose2d):
            n, cin, h, w = x.shape
            flops.append(2 * n * cin * h * w * kh * kw
                         * module.out_channels // module.groups)
        else:
            n, cout, h, w = output.shape
            flops.append(2 * n * cout * h * w * kh * kw
                         * module.in_channels // module.groups)

    hooks = [m.register_forward_hook(count)
             for m in tiny_mitonet.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d,
                               torch.nn.Linear))]
    try:
        with torch.inference_mode():
            tiny_mitonet(torch.zeros((4, 1, 128, 256)), render_steps=2,
                         interpolate_ins=False)
    finally:
        for h in hooks:
            h.remove()
    assert engine.block_cost_analysis() == {"flops": sum(flops)} \
        and sum(flops) > 0


def test_infer3d_resident_writes_what_streaming_writes(tmp_path,
                                                       tiny_mitonet):
    from empanada_torch.cli import infer3d
    from empanada_torch.export import export_model
    from tests.test_torch_export import MODEL_CONFIG
    from tests.test_torch_export import NORMS as EXPORT_NORMS

    export_model(tiny_mitonet.state_dict(), MODEL_CONFIG,
                 str(tmp_path / "export"), "tiny", norms=EXPORT_NORMS)
    desc = str(tmp_path / "export" / "tiny.yaml")
    vol = np.random.default_rng(9).integers(0, 255, (9, 40, 36),
                                            dtype=np.uint8)
    outs = {}
    for tag, flags in (("stream", []), ("resident", ["--resident"])):
        path = str(tmp_path / f"{tag}.npy")
        np.save(path, vol)
        infer3d.main([desc, path, "--use-cpu", "-block-size", "4",
                      "-min-size", "4", "-min-span", "1"] + flags)
        store = zarr_store.open_zarr(
            f"{path}_orthoplane_seg_class1.zarr")
        outs[tag] = (np.asarray(store[:]),
                     open(f"{path}_orthoplane_class1.json").read())
    assert outs["stream"][0].dtype == outs["resident"][0].dtype
    assert outs["stream"][0].tobytes() == outs["resident"][0].tobytes()
    assert outs["stream"][1] == outs["resident"][1]
