"""The port's exported-model loader and infer3d command line, held
against the JAX package's: descriptor keys and defaults, the forward of
the same variables exported by both, the exported program (``.pt2``,
``stablehlo=True``: exact round trip, the JAX package's ``.stablehlo``
within 1e-5, the ``export --stablehlo`` command), the flag surface
(recipe defaults, explicit flags, unknown keys), the refusals, and
``main`` end to end on the CPU (class zarr == dense fill of the json).

Tolerance of the forward comparison: 1e-4 of max |value| per output
(float32, different summation order in the convolutions)."""

import json
import sys

import numpy as np
import pytest
import torch

for _dep in ("jax", "flax", "yaml"):
    pytest.importorskip(_dep, reason="parity tests need the JAX package")

import jax
import yaml

from empanada_tpu import config as jax_config
from empanada_tpu import export as jax_export
from empanada_tpu.cli import infer3d as jax_infer3d
from empanada_tpu.models import create_model as flax_create_model
from empanada_torch import config, export
from empanada_torch.cli import infer3d
from empanada_torch.core.fill import numpy_fill_instances
from empanada_torch.data.zarr_store import create_zarr, open_zarr
from empanada_torch.inference.tracker import InstanceTracker
from empanada_torch.models import create_model
from empanada_torch.weights import flax_to_torch
from tests.test_torch_models import TINY, _randomize

REL_TOL = 1e-4
MODEL_CONFIG = dict(arch="PanopticBiFPNPR", **TINY)
NORMS = {"mean": 0.57, "std": 0.12}


@pytest.fixture(scope="module")
def tiny_variables():
    flax_model = flax_create_model("PanopticBiFPNPR", **TINY)
    init = flax_model.init(
        {"params": jax.random.key(0), "points": jax.random.key(1),
         "dropout": jax.random.key(2)},
        np.zeros((1, 128, 128, 1), np.float32), train=False)
    return _randomize(init, seed=3)


@pytest.fixture(scope="module")
def exported(tmp_path_factory, tiny_variables):
    """(port descriptor path, JAX descriptor path): the same variables
    exported by both packages."""
    root = tmp_path_factory.mktemp("exported")
    export.export_model(flax_to_torch(tiny_variables), MODEL_CONFIG,
                        str(root / "torch"), "tiny", norms=NORMS)
    jax_export.export_model(tiny_variables, MODEL_CONFIG, str(root / "jax"),
                            "tiny", norms=NORMS)
    return str(root / "torch" / "tiny.yaml"), str(root / "jax" / "tiny.yaml")


def test_export_roundtrip_and_descriptor(tmp_path, tiny_variables):
    state = flax_to_torch(tiny_variables)
    desc = export.export_model(state, MODEL_CONFIG, str(tmp_path), "m")
    want = jax_export.export_model(tiny_variables, MODEL_CONFIG,
                                   str(tmp_path / "jax"), "m")
    # same keys and defaults apart from the format and the weights file
    assert list(desc) == list(want)
    for key in desc:
        if key not in ("format", "model"):
            assert desc[key] == want[key], key
    assert desc["format"] == "empanada_torch"
    assert want["format"] == "empanada_tpu"
    assert desc["model"] == str(tmp_path / "m.pth")
    with open(tmp_path / "m.yaml") as f:
        assert yaml.safe_load(f) == desc

    model, loaded = export.load_exported_model(str(tmp_path / "m.yaml"),
                                               device="cpu")
    assert loaded == desc
    assert isinstance(model, torch.nn.Module) and not model.training
    got = model.state_dict()
    assert sorted(got) == sorted(state)
    for key, value in state.items():
        assert got[key].device.type == "cpu"
        torch.testing.assert_close(got[key], value, rtol=0, atol=0)

    # every descriptor field is carried
    full = export.export_model(
        model.state_dict(), MODEL_CONFIG, str(tmp_path), "full", norms=NORMS,
        padding_factor=16, thing_list=[2], labels=[1, 2],
        class_names={1: "er", 2: "mito"}, finetune_params={"lr": 0.1},
        run_id="r1")
    want_full = jax_export.export_model(
        tiny_variables, MODEL_CONFIG, str(tmp_path / "jax"), "full",
        norms=NORMS, padding_factor=16, thing_list=[2], labels=[1, 2],
        class_names={1: "er", 2: "mito"}, finetune_params={"lr": 0.1},
        run_id="r1")
    assert {k: v for k, v in full.items() if k not in ("format", "model")} \
        == {k: v for k, v in want_full.items()
            if k not in ("format", "model")}


def test_relative_model_path_resolves_beside_descriptor(tmp_path, exported):
    desc = yaml.safe_load(open(exported[0]))
    moved = tmp_path / "moved"
    moved.mkdir()
    (moved / "tiny.pth").write_bytes(open(desc["model"], "rb").read())
    desc["model"] = "somewhere/else/tiny.pth"
    with open(moved / "tiny.yaml", "w") as f:
        yaml.safe_dump(desc, f)
    model, _ = export.load_exported_model(str(moved / "tiny.yaml"),
                                          device="cpu")
    assert not model.training


def test_exports_of_both_packages_give_the_same_forward(exported):
    model, desc = export.load_exported_model(exported[0], device="cpu")
    jax_model, jax_desc = jax_export.load_exported_model(exported[1])
    assert desc["norms"] == jax_desc["norms"] == NORMS
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (2, 128, 128, 1)).astype(np.float32)
    want = jax_model(x, render_steps=2, interpolate_ins=False)
    with torch.inference_mode():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2), render_steps=2,
                    interpolate_ins=False)
    for key in ("sem_logits", "ctr_hmp", "offsets"):
        a = np.asarray(want[key])
        b = got[key].permute(0, 2, 3, 1).numpy()
        scale = np.abs(a).max()
        assert a.shape == b.shape and scale > 0.05, key
        np.testing.assert_allclose(b, a, rtol=0, atol=REL_TOL * scale,
                                   err_msg=key)


@pytest.fixture(scope="module")
def programs(tmp_path_factory, tiny_variables):
    """(port descriptor, JAX StableHLO path): the eval forward of the same
    variables exported by both packages at (1, 128, 128, 1)."""
    root = tmp_path_factory.mktemp("programs")
    desc = export.export_model(flax_to_torch(tiny_variables), MODEL_CONFIG,
                               str(root / "torch"), "p", norms=NORMS,
                               stablehlo=True, input_shape=(1, 128, 128, 1))
    jax_export.export_model(tiny_variables, MODEL_CONFIG, str(root / "jax"),
                            "p", norms=NORMS, stablehlo=True,
                            input_shape=(1, 128, 128, 1))
    return desc, str(root / "jax" / "p.stablehlo")


def _program_input(seed):
    return np.random.default_rng(seed).normal(
        0, 1, (1, 128, 128, 1)).astype(np.float32)


def test_exported_program_round_trip_is_exact(programs):
    """The .pt2 reloads and gives the eager forward exactly on the CPU;
    moved to another device (meta here) it holds no CPU tensor."""
    from torch.export.passes import move_to_device_pass

    desc, _ = programs
    assert desc["model_stablehlo"].endswith("p.pt2")
    assert desc["model_stablehlo_input"] == {
        "layout": "NCHW", "shape": [1, 1, 128, 128], "dtype": "float32"}
    model, _ = export.load_exported_model(
        desc["model_stablehlo"].replace(".pt2", ".yaml"), device="cpu")
    x = torch.from_numpy(_program_input(5)).permute(0, 3, 1, 2).contiguous()
    program = torch.export.load(desc["model_stablehlo"])
    with torch.no_grad():
        got = program.module()(x)
        want = model(x, **export.FORWARD_KW)
        on_meta = move_to_device_pass(program, "meta").module()(
            x.to("meta"))
    assert sorted(got) == sorted(want) == ["ctr_hmp", "offsets",
                                           "sem_logits"]
    for key in want:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)
        assert on_meta[key].device.type == "meta"
        assert on_meta[key].shape == want[key].shape


def test_exported_program_matches_jax_stablehlo(programs):
    """The .pt2 against the JAX package's .stablehlo of the same
    variables, called through ``jax.export.deserialize``: within 1e-5
    (float32, another summation order)."""
    from jax import export as jax_program

    desc, hlo_path = programs
    x = _program_input(6)
    with open(hlo_path, "rb") as f:
        want = jax_program.deserialize(f.read()).call(x)
    with torch.no_grad():
        got = torch.export.load(desc["model_stablehlo"]).module()(
            torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    for key in ("sem_logits", "ctr_hmp", "offsets"):
        a = np.asarray(want[key])
        b = got[key].permute(0, 2, 3, 1).numpy()
        assert a.shape == b.shape and np.abs(a).max() > 0.05, key
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5, err_msg=key)


def test_export_command_writes_the_program(tmp_path, tiny_variables):
    """``export --stablehlo`` writes <name>.pt2 at (1, 1, 512, 512) and
    names it in the descriptor; the program's outputs have the eager
    forward's shapes (run on the meta device: no arithmetic)."""
    from torch.export.passes import move_to_device_pass

    from empanada_torch.cli import export as export_cli

    recipe = tmp_path / "recipe.yaml"
    with open(recipe, "w") as f:
        yaml.safe_dump({"MODEL": MODEL_CONFIG,
                        "DATASET": {"labels": [1], "thing_list": [1],
                                    "class_names": {1: "mito"},
                                    "norms": NORMS}}, f)
    state = flax_to_torch(tiny_variables)
    torch.save({"model": state}, tmp_path / "ckpt.pth")
    export_cli.main([str(recipe), str(tmp_path / "ckpt.pth"),
                     str(tmp_path / "out"), "--stablehlo", "-name", "tiny"])
    desc = yaml.safe_load(open(tmp_path / "out" / "tiny.yaml"))
    assert desc["model_stablehlo"] == str(tmp_path / "out" / "tiny.pt2")
    assert desc["model_stablehlo_input"]["shape"] == [1, 1, 512, 512]
    program = move_to_device_pass(
        torch.export.load(desc["model_stablehlo"]), "meta").module()
    with torch.no_grad():
        got = program(torch.zeros((1, 1, 512, 512), device="meta"))
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        "sem_logits": (1, 1, 512, 512), "ctr_hmp": (1, 1, 128, 128),
        "offsets": (1, 2, 128, 128)}


def test_refusals_of_the_loader_and_exporter(tmp_path, exported,
                                             tiny_variables):
    """A descriptor of another format, and an int8 load of a descriptor
    without the int8 artifact, are refused by name."""
    with pytest.raises(ValueError, match="model_quantized"):
        export.load_exported_model(exported[0], quantized=True, device="cpu")
    desc = yaml.safe_load(open(exported[0]))
    desc["format"] = "other"
    with open(tmp_path / "other.yaml", "w") as f:
        yaml.safe_dump(desc, f)
    with pytest.raises(ValueError, match="format 'other'"):
        export.load_exported_model(str(tmp_path / "other.yaml"),
                                   device="cpu")


@pytest.mark.parametrize("flags", [["-n-devices", "2", "-block-size", "3"]])
def test_main_refuses_unported_flags(tmp_path, flags):
    """Refused by name before any work: the files need not exist.
    ``-n-devices`` refuses a block that does not divide over its mesh
    (as the JAX engine does)."""
    argv = [str(tmp_path / "none.yaml"), str(tmp_path / "none.npy"),
            "--use-cpu"] + flags
    match = "-block-size 3 must divide over the 2-device mesh"
    with pytest.raises(SystemExit, match=match):
        infer3d.main(argv)


def _check_outputs(base, mode, shape):
    """The class zarr equals a dense fill of the tracker json."""
    tracker = InstanceTracker()
    tracker.load_from_json(f"{base}_{mode}_class1.json")
    seg = open_zarr(f"{base}_{mode}_seg_class1.zarr")
    assert seg.shape == shape == tuple(tracker.shape3d)
    assert seg.dtype == np.uint32
    dense = numpy_fill_instances(np.zeros(shape, np.uint32),
                                 tracker.instances)
    np.testing.assert_array_equal(np.asarray(seg), dense)
    return tracker


@pytest.mark.parametrize("store, mode", [("npy", "orthoplane"),
                                         ("zarr", "stack"),
                                         ("zarr_group", "orthoplane")])
def test_main_on_the_cpu(tmp_path, exported, store, mode, capsys):
    rng = np.random.default_rng(12)
    vol = rng.integers(0, 255, (14, 40, 52)).astype(np.uint8)
    extra = []
    if store == "npy":
        path = str(tmp_path / "vol.npy")
        np.save(path, vol)
        base = path
    else:
        path = str(tmp_path / "vol.zarr")
        base = str(tmp_path / "vol")
        array_path = path
        if store == "zarr_group":
            array_path = str(tmp_path / "vol.zarr" / "em")
            extra = ["-data-key", "missing, em"]
        arr = create_zarr(array_path, vol.shape, dtype=np.uint8,
                          chunks=(8, 32, 32))
        arr[:, :, :] = vol
        if store == "zarr_group":
            (tmp_path / "vol.zarr" / ".zgroup").write_text(
                '{"zarr_format": 2}')
    infer3d.main([exported[0], path, "--use-cpu", "-mode", mode,
                  "-min-size", "20", "-min-span", "2", "-block-size", "8",
                  "--save-panoptic"] + extra)
    tracker = _check_outputs(base, mode, vol.shape)
    assert len(tracker.instances) >= 1
    assert f"class 1: {len(tracker.instances)} instances" in \
        capsys.readouterr().out
    axes = ["xy"] if mode == "stack" else ["xy", "xz", "yz"]
    for axis in axes:
        assert np.load(tmp_path / f"panoptic_{axis}.npy").shape[0] == \
            vol.shape["xy xz yz".split().index(axis)]


def _write_recipes(tmp_path, child):
    with open(tmp_path / "base.yaml", "w") as f:
        yaml.safe_dump({"qlen": 5, "min_size": 100, "seg_thr": 0.4}, f)
    with open(tmp_path / "recipe.yaml", "w") as f:
        yaml.safe_dump(dict({"BASE": "base.yaml"}, **child), f)
    return str(tmp_path / "recipe.yaml")


def test_recipe_defaults_lose_to_explicit_flags(tmp_path):
    recipe = _write_recipes(tmp_path, {"min_size": 200, "one_view": True})
    argvs = [
        ["m.yaml", "v.zarr"],
        ["m.yaml", "-infer-config", recipe, "v.zarr"],
        ["m.yaml", f"-infer-config={recipe}", "v.zarr", "-qlen", "7",
         "-min-size", "300", "--use-cpu", "-block-size", "16"],
        ["m.yaml", "v.zarr", "-mode", "stack", "-nmax", "1000",
         "-max-centers", "64", "-pipeline-depth", "2", "--fine-boundaries",
         "-data-key", "em", "-downsample-f", "2"],
    ]
    for argv in argvs:
        got = vars(infer3d.parse_args(argv))
        # -trace-dir is the port's own flag (the operator's trace)
        assert got.pop("trace_dir") is None
        assert got == vars(jax_infer3d.parse_args(argv)), argv
    assert infer3d.parse_args(argvs[0] + ["-trace-dir", "t"]).trace_dir == "t"
    args = infer3d.parse_args(argvs[1])
    assert (args.qlen, args.min_size, args.seg_thr, args.one_view) == \
        (5, 200, 0.4, True)
    args = infer3d.parse_args(argvs[2])
    assert (args.qlen, args.min_size, args.seg_thr, args.use_cpu) == \
        (7, 300, 0.4, True)
    defaults = infer3d.parse_args(argvs[0])
    assert (defaults.mode, defaults.n_devices, defaults.use_cpu) == \
        ("orthoplane", 0, False)


def test_recipe_with_unknown_keys_is_refused(tmp_path):
    recipe = _write_recipes(tmp_path, {"no_such_flag": 1})
    for parse in (infer3d.parse_args, jax_infer3d.parse_args):
        with pytest.raises(SystemExit, match="unknown keys.*no_such_flag"):
            parse(["m.yaml", "-infer-config", recipe, "v.zarr"])


def test_load_config_matches_jax(tmp_path):
    with open(tmp_path / "root.yaml", "w") as f:
        yaml.safe_dump({"A": {"x": 1, "y": 2}, "B": [1, 2], "C": "r"}, f)
    with open(tmp_path / "mid.yaml", "w") as f:
        yaml.safe_dump({"BASE": "root.yaml", "A": {"y": 3, "z": 4}}, f)
    with open(tmp_path / "leaf.yaml", "w") as f:
        yaml.safe_dump({"BASE": "mid.yaml", "B": [9], "A": {"x": 0}}, f)
    got = config.load_config(str(tmp_path / "leaf.yaml"))
    assert got == jax_config.load_config(str(tmp_path / "leaf.yaml"))
    assert got["A"] == {"x": 0, "y": 3, "z": 4} and got["B"] == [9]
    assert config.merge_dicts({"a": {"b": 1}}, {"a": {"c": 2}}) == \
        jax_config.merge_dicts({"a": {"b": 1}}, {"a": {"c": 2}})
    with open(tmp_path / "loop.yaml", "w") as f:
        yaml.safe_dump({"BASE": "loop.yaml"}, f)
    with pytest.raises(ValueError, match="circular"):
        config.load_config(str(tmp_path / "loop.yaml"))


def test_dispatcher(monkeypatch, capsys, tmp_path):
    from empanada_torch import __main__ as dispatcher

    assert list(dispatcher.COMMANDS) == ["infer3d", "train", "finetune",
                                         "export", "evaluate3d",
                                         "evaluate3d-bc", "evaluate3d_bc",
                                         "curate"]
    for argv, code in ((["empanada_torch"], 2),
                       (["empanada_torch", "--help"], 0),
                       (["empanada_torch", "nosuch"], 2)):
        monkeypatch.setattr(sys, "argv", argv)
        with pytest.raises(SystemExit) as exc:
            dispatcher.main()
        assert exc.value.code == code
        assert "infer3d" in capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", [
        "empanada_torch", "infer3d", str(tmp_path / "m.yaml"),
        str(tmp_path / "v.npy"), "--use-cpu", "-n-devices", "2",
        "-block-size", "3"])
    with pytest.raises(SystemExit, match="-block-size 3 must divide"):
        dispatcher.main()


def test_tracker_json_is_the_jax_packages(tmp_path, exported):
    """The json main writes loads in the JAX package's tracker."""
    from empanada_tpu.inference.tracker import InstanceTracker as JaxTracker

    rng = np.random.default_rng(12)
    vol = rng.integers(0, 255, (14, 40, 52)).astype(np.uint8)
    np.save(tmp_path / "v.npy", vol)
    infer3d.main([exported[0], str(tmp_path / "v.npy"), "--use-cpu", "-mode",
                  "stack", "-min-size", "20", "-min-span", "2"])
    path = str(tmp_path / "v.npy_stack_class1.json")
    with open(path) as f:
        assert json.load(f)["shape3d"] == list(vol.shape)
    ours, theirs = InstanceTracker(), JaxTracker()
    ours.load_from_json(path)
    theirs.load_from_json(path)
    assert list(ours.instances) == list(theirs.instances) != []
    for label, attrs in theirs.instances.items():
        np.testing.assert_array_equal(ours.instances[label]["starts"],
                                      attrs["starts"])
        np.testing.assert_array_equal(ours.instances[label]["runs"],
                                      attrs["runs"])
