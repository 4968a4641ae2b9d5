"""Model artifacts in and out of the port, held against the JAX package:
the msgpack decoder (against ``flax.serialization.msgpack_restore`` on
the JAX package's own export bytes, and against the ``msgpack`` package
on drawn trees), the JAX package's float32 and calibrated int8
descriptors loaded in the port (with ``msgpack`` blocked too), the
port's own int8 export through orthoplane inference, ``export
--from-torch --quantize`` and ``infer3d --quantized``.

Tolerances: float32 forwards within 1e-4 of max |value| (as
``test_torch_export.py``); int8 forwards within 1e-4 of max |value| (see
``test_torch_quantization.py`` for the flipped-code share behind it)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

for _dep in ("jax", "flax", "yaml", "msgpack", "hypothesis"):
    pytest.importorskip(_dep, reason="parity tests need the JAX package")

import msgpack
import numpy as np
import torch
import yaml
from flax import serialization
from hypothesis import given, settings
from hypothesis import strategies as st

from empanada_tpu import export as jax_export
from empanada_torch import export
from empanada_torch.cli import export as export_cli
from empanada_torch.cli import infer3d
from empanada_torch.models import quantization as tq
from empanada_torch.utils import msgpack as port_msgpack
from empanada_torch.weights import flax_to_torch
from tests.test_torch_export import MODEL_CONFIG, NORMS, tiny_variables  # noqa: F401
from tests.test_torch_quantization import OUT_TOL
from tests.test_torch_torch_weights import reference_layout, scripted

ROOT = Path(__file__).resolve().parents[1]
REL_TOL = 1e-4
KW = dict(render_steps=2, interpolate_ins=False)


def _calibration(n=2, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, (2, 128, 128, 1)).astype(np.float32)
            for _ in range(n)]


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


@pytest.fixture(scope="module")
def ordered_variables():
    """The tiny MitoNet's seeded variables in flax's own key order, as the
    reference layout is built from them."""
    from empanada_tpu.models import create_model as j_create_model
    from tests.test_torch_torch_weights import RNGS, _randomize

    cfg = dict(MODEL_CONFIG)
    model = j_create_model(cfg.pop("arch"), **cfg)
    return _randomize(model.init(
        RNGS, np.zeros((1, 128, 128, 1), np.float32), train=False), 3)


@pytest.fixture(scope="module")
def jax_exported(tmp_path_factory, tiny_variables):  # noqa: F811
    """The JAX package's calibrated int8 export of the tiny MitoNet."""
    root = tmp_path_factory.mktemp("jax_int8")
    desc = jax_export.export_model(
        tiny_variables, MODEL_CONFIG, str(root), "tiny", norms=NORMS,
        quantize=True, calibration_data=_calibration())
    return str(root / "tiny.yaml"), desc


def _same_tree(got, want):
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert list(got) == list(want)
        for key in want:
            _same_tree(got[key], want[key])
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def test_msgpack_decoder_equals_flax_on_jax_exports(jax_exported):
    path, desc = jax_exported
    for key in ("model", "model_quantized"):
        data = Path(desc[key]).read_bytes()
        got = port_msgpack.unpackb(data)
        _same_tree(got, serialization.msgpack_restore(data))
    assert port_msgpack.read_msgpack(desc["model_quantized"])["params"]


_leaves = st.one_of(
    st.none(), st.booleans(), st.integers(-2 ** 63, 2 ** 64 - 1),
    st.floats(allow_nan=False), st.text(max_size=40),
    st.tuples(st.sampled_from(["float32", "float64", "int8", "int32",
                               "uint8", "uint16", "int64", "bool"]),
              st.lists(st.integers(0, 5), max_size=3),
              st.integers(0, 2 ** 32 - 1)).map(
        lambda t: np.random.default_rng(t[2]).normal(
            0, 50, t[1]).astype(t[0])))
_trees = st.recursive(
    _leaves, lambda inner: st.dictionaries(st.text(max_size=12), inner,
                                           max_size=6), max_leaves=30)


@settings(max_examples=150, deadline=None)
@given(_trees)
def test_msgpack_decoder_equals_msgpack_package(tree):
    data = serialization.msgpack_serialize(tree) \
        if isinstance(tree, dict) else msgpack.packb(
            tree, default=serialization._msgpack_ext_pack,
            strict_types=True)
    want = msgpack.unpackb(data, ext_hook=serialization._msgpack_ext_unpack,
                           raw=False)
    _same_tree(port_msgpack.unpackb(data), want)


@pytest.mark.parametrize("value, name", [
    (np.float32(1.5), "numpy scalar"),
    (complex(1, 2), "complex scalar"),
    ([1, 2], "array value"),
    (b"raw", "bin value"),
    ({"__msgpack_chunked_array__": True, "shape": {}}, "chunked"),
])
def test_msgpack_decoder_refuses_what_it_does_not_cover(value, name):
    data = msgpack.packb({"leaf": value},
                         default=serialization._msgpack_ext_pack,
                         use_bin_type=True)
    with pytest.raises(ValueError, match=name):
        port_msgpack.unpackb(data)
    with pytest.raises(ValueError, match="after the msgpack value"):
        port_msgpack.unpackb(msgpack.packb({"a": 1}) + b"\x00")


def _forward_close(got, want, tol):
    for key in ("sem_logits", "ctr_hmp", "offsets"):
        a = np.asarray(want[key])
        b = got[key].permute(0, 2, 3, 1).numpy()
        scale = float(np.abs(a).max())
        assert a.shape == b.shape and scale > 0.05, key
        np.testing.assert_allclose(b, a, rtol=0, atol=tol * scale,
                                   err_msg=key)


@pytest.mark.parametrize("quantized", [False, True])
def test_jax_descriptors_load_in_the_port(jax_exported, quantized):
    """A JAX float32 descriptor and a JAX calibrated int8 descriptor load
    through the port's loader; their forwards match the JAX models."""
    path, _ = jax_exported
    model, desc = export.load_exported_model(path, quantized=quantized,
                                             device="cpu")
    j_model, j_desc = jax_export.load_exported_model(path,
                                                     quantized=quantized)
    assert desc == j_desc and desc["format"] == "empanada_tpu"
    n_int8 = sum(isinstance(m, (tq.Int8Conv2d, tq.Int8Linear))
                 for m in model.modules())
    assert (n_int8 > 0) == quantized
    if quantized:  # one int8 module for each int8 kernel of the artifact
        from flax import traverse_util

        tree = serialization.msgpack_restore(
            Path(desc["model_quantized"]).read_bytes())
        assert n_int8 == sum(k[-1] == "__int8__" for k in
                             traverse_util.flatten_dict(tree))
    x = np.random.default_rng(4).normal(0, 1, (2, 128, 128, 1)) \
        .astype(np.float32)
    # the int8 model runs eagerly, as test_torch_quantization holds it
    want = j_model.module.apply(j_model.params, x, train=False, **KW) \
        if quantized else j_model(x, **KW)
    with torch.inference_mode():
        got = model(_nchw(x), **KW)
    _forward_close(got, want, OUT_TOL if quantized else REL_TOL)


def test_jax_descriptors_load_without_msgpack(jax_exported):
    """The loader needs no msgpack package (nor OpenCV nor JAX): a
    process with them blocked reads both artifacts, tensor for tensor as
    this one does."""
    path, _ = jax_exported
    sums = {}
    for quantized in (False, True):
        model, _ = export.load_exported_model(path, quantized=quantized,
                                              device="cpu")
        sums[quantized] = [float(t.double().sum())
                           for t in model.state_dict().values()]
    code = (
        "import sys, json\n"
        "for name in ('msgpack', 'cv2', 'jax', 'flax', 'empanada_tpu'):\n"
        "    sys.modules[name] = None\n"
        "from empanada_torch import export\n"
        "out = {}\n"
        "for q in (False, True):\n"
        f"    m, _ = export.load_exported_model({path!r}, quantized=q,\n"
        "                                      device='cpu')\n"
        "    out[str(q)] = [float(t.double().sum())\n"
        "                   for t in m.state_dict().values()]\n"
        "print(json.dumps(out))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == {"False": sums[False], "True": sums[True]}


def test_port_int8_export_through_orthoplane(tmp_path, tiny_variables,  # noqa: F811
                                             jax_exported):
    """The port's calibrated int8 export has the JAX export's descriptor
    (act_scales within rtol 1e-5, the same scope, the drift record), loads
    as an executing int8 model and runs run_inference3d(orthoplane) on
    the CPU."""
    from empanada_torch.cli.infer3d import run_inference3d

    state = flax_to_torch(tiny_variables)
    desc = export.export_model(
        state, MODEL_CONFIG, str(tmp_path), "tiny", norms=NORMS,
        quantize=True, calibration_data=[_nchw(b) for b in _calibration()],
        device="cpu")
    want = jax_exported[1]
    assert list(desc) == list(want)
    assert desc["quantize_scope"] == want["quantize_scope"] == "encoder"
    assert sorted(desc["act_scales"]) == sorted(want["act_scales"])
    for p, s in want["act_scales"].items():
        np.testing.assert_allclose(desc["act_scales"][p], s, rtol=1e-5)
    assert desc["int8_drift"]["batches"] == 2
    assert abs(desc["int8_drift"]["sem_iou"]
               - want["int8_drift"]["sem_iou"]) <= 2e-3
    assert desc["model_quantized"] == str(tmp_path / "tiny.int8.pth")

    model, loaded = export.load_exported_model(str(tmp_path / "tiny.yaml"),
                                               quantized=True, device="cpu")
    assert loaded == desc
    assert any(isinstance(m, tq.Int8Conv2d) for m in model.modules())
    vol = np.random.default_rng(12).integers(0, 255, (10, 40, 52)) \
        .astype(np.uint8)
    stats = {}
    out = run_inference3d(model, vol, labels=[1], thing_list=[1],
                          mode="orthoplane", norms=NORMS, device="cpu",
                          min_size=20, min_span=2, block_size=8,
                          progress=False, stats=stats)
    assert sorted(out) == [1] and tuple(out[1].shape3d) == vol.shape
    assert sorted(stats["axes"]) == ["xy", "xz", "yz"]

    # weight-only: dequantized to float32 on load
    export.export_model(state, MODEL_CONFIG, str(tmp_path), "w",
                        quantize=True)
    model, _ = export.load_exported_model(str(tmp_path / "w.yaml"),
                                          quantized=True, device="cpu")
    want_state = export.dequantize_state_int8(
        export.quantize_state_int8(state))
    for key, value in model.state_dict().items():
        assert torch.equal(value, want_state[key]), key


def _recipe(tmp_path):
    cfg = {"MODEL": dict(MODEL_CONFIG),
           "DATASET": {"labels": [1], "thing_list": [1],
                       "class_names": {1: "mito"}, "norms": NORMS}}
    path = tmp_path / "recipe.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def test_export_from_torch_with_quantize_writes_both(tmp_path, capsys,
                                                     ordered_variables):
    """``export --from-torch --quantize`` on a TorchScript archive in the
    reference's layout: the float32 and the weight-only int8 artifacts,
    the descriptor the JAX command writes (but for the format and the
    paths), weights equal to the source's."""
    from empanada_tpu.cli import export as jax_export_cli

    archive = str(tmp_path / "mitonet.pth")
    torch.jit.save(scripted(reference_layout(ordered_variables)), archive)
    recipe = _recipe(tmp_path)
    argv = [recipe, archive, str(tmp_path / "out"), "--from-torch",
            "--quantize", "-name", "m", "-pf", "64"]
    export_cli.main(argv)
    assert "Imported torch artifact" in capsys.readouterr().out
    jax_export_cli.main([recipe, archive, str(tmp_path / "jax"),
                         "--from-torch", "--quantize", "-name", "m", "-pf",
                         "64"])
    with open(tmp_path / "out" / "m.yaml") as f:
        desc = yaml.safe_load(f)
    with open(tmp_path / "jax" / "m.yaml") as f:
        want = yaml.safe_load(f)
    paths = ("format", "model", "model_quantized")
    assert {k: v for k, v in desc.items() if k not in paths} == \
        {k: v for k, v in want.items() if k not in paths}
    assert desc["model_quantized"] == str(tmp_path / "out" / "m.int8.pth")
    assert desc["padding_factor"] == 64 and desc["norms"] == NORMS
    got = torch.load(desc["model"], weights_only=True)
    for key, value in flax_to_torch(ordered_variables).items():
        assert torch.equal(got[key], value), key
    int8_state = torch.load(desc["model_quantized"], weights_only=True)
    assert any(k.endswith(export.INT8_SUFFIX) for k in int8_state)
    model, _ = export.load_exported_model(str(tmp_path / "out" / "m.yaml"),
                                          quantized=True, device="cpu")
    assert not any(isinstance(m, tq.Int8Conv2d) for m in model.modules())


def test_from_torch_refuses_leftover_tensors(tmp_path, ordered_variables):
    sd = reference_layout(ordered_variables, prefix="")
    sd["extra.weight"] = torch.zeros(4, 4, 3, 3)
    torch.save(sd, tmp_path / "extra.pth")
    with pytest.raises(ValueError, match="unconsumed torch params"):
        export.import_torch_model(str(tmp_path / "extra.pth"), MODEL_CONFIG,
                                  str(tmp_path / "out"), "m")


@pytest.mark.parametrize("calibrated", [True, False])
def test_infer3d_quantized_prints_the_warning(tmp_path, capsys, calibrated,
                                              tiny_variables):  # noqa: F811
    """``infer3d --quantized``: the descriptor's drift record and scope
    when the export was calibrated, the no-record warning otherwise;
    then inference runs with the int8 artifact."""
    state = flax_to_torch(tiny_variables)
    kw = dict(calibration_data=[_nchw(b) for b in _calibration(1)],
              device="cpu") if calibrated else {}
    desc = export.export_model(state, MODEL_CONFIG, str(tmp_path), "q",
                               norms=NORMS, quantize=True, **kw)
    vol = np.random.default_rng(3).integers(0, 255, (8, 40, 52)) \
        .astype(np.uint8)
    np.save(tmp_path / "v.npy", vol)
    infer3d.main([str(tmp_path / "q.yaml"), str(tmp_path / "v.npy"),
                  "--use-cpu", "--quantized", "-mode", "stack",
                  "-min-size", "20", "-min-span", "2"])
    out = capsys.readouterr().out
    if calibrated:
        drift = desc["int8_drift"]
        assert (f"WARNING: int8 artifact (scope=encoder) measured drift vs "
                f"fp32 on its calibration data: semantic IoU "
                f"{drift['sem_iou']}") in out
        assert "5-8%" not in out
    else:
        assert "WARNING: int8 artifact has no measured drift record" in out
    assert "class 1:" in out
    assert (tmp_path / "v.npy_stack_class1.json").exists()
