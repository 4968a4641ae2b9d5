"""The port stands alone: empanada_torch and chip_smoke.py import nothing
of JAX or the JAX package, nor OpenCV nor msgpack (and PyYAML only
inside the functions that read or write a descriptor), importing them
neither compiles nor loads the C++ host core (that happens at first
use), entry points never fall back to the CPU on their own, and the
CUDA kernel path is taken only for CUDA tensors."""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import empanada_torch
from empanada_torch.ops import group

ROOT = Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "flax", "optax", "empanada_tpu")
# modules of the orthoplane / loader / command-line slice
NEW_MODULES = ("empanada_torch.__main__", "empanada_torch.config",
               "empanada_torch.export", "empanada_torch.core.fill",
               "empanada_torch.data.zarr_store",
               "empanada_torch.inference.consensus",
               "empanada_torch.cli.infer3d")
# modules of the C++ host core slice
HOST_CORE_MODULES = ("empanada_torch.native_build",
                     "empanada_torch.core.native",
                     "empanada_torch.core.ccl3d")
# modules of the training slice
TRAIN_MODULES = ("empanada_torch.train", "empanada_torch.train.trainer",
                 "empanada_torch.train.optim",
                 "empanada_torch.train.checkpoint",
                 "empanada_torch.losses", "empanada_torch.metrics",
                 "empanada_torch.data", "empanada_torch.data.loader",
                 "empanada_torch.data.image_files",
                 "empanada_torch.data.utils.transforms",
                 "empanada_torch.inference.engines",
                 "empanada_torch.utils.logging",
                 "empanada_torch.cli.train", "empanada_torch.cli.finetune",
                 "empanada_torch.cli.export")
# modules of the Panoptic-DeepLab / boundary-contour / evaluation slice
EVAL_MODULES = ("empanada_torch.evaluation",
                "empanada_torch.evaluation.evaluator",
                "empanada_torch.inference.watershed",
                "empanada_torch.inference.tile",
                "empanada_torch.cli.evaluate3d",
                "empanada_torch.cli.evaluate3d_bc",
                "empanada_torch.models.panoptic_deeplab",
                "empanada_torch.models.encoders.resnet",
                "empanada_torch.models.decoders.aspp",
                "empanada_torch.data.bc_dataset",
                "empanada_torch.data.synthetic",
                "empanada_torch.utils.profiling")
# modules of the artifacts and curation slice
ARTIFACT_MODULES = ("empanada_torch.train.torch_weights",
                    "empanada_torch.utils.msgpack",
                    "empanada_torch.ops.int8",
                    "empanada_torch.models.quantization",
                    "empanada_torch.data.curation",
                    "empanada_torch.cli.curate")


# modules of the multi-device slice
PARALLEL_MODULES = ("empanada_torch.parallel",
                    "empanada_torch.parallel.mesh",
                    "empanada_torch.parallel.collectives",
                    "empanada_torch.parallel.inference",
                    "empanada_torch.parallel.multihost")


# the bench MitoNet's module and the benchmark entry point
BENCH_MODULES = ("empanada_torch.bench_heads", "empanada_torch.bench")

# the counterpart of the JAX package's root __graft_entry__.py
ENTRY_MODULES = ("empanada_torch.entry",)


def _port_sources():
    return sorted((ROOT / "empanada_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def test_every_module_imports_with_jax_blocked():
    names = [m.name for m in pkgutil.walk_packages(
        empanada_torch.__path__, "empanada_torch.")]
    assert "empanada_torch.inference.fused" in names
    assert set(NEW_MODULES + HOST_CORE_MODULES + TRAIN_MODULES
               + EVAL_MODULES + ARTIFACT_MODULES
               + PARALLEL_MODULES + BENCH_MODULES + ENTRY_MODULES) \
        <= set(names)
    blocked = BLOCKED + ("yaml", "cv2", "mlflow", "msgpack")
    code = (
        "import sys\n"
        f"for name in {blocked!r}:\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for name in {['empanada_torch'] + names!r}:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        f"assert not any(m.split('.')[0] in {blocked!r} and sys.modules[m]"
        " for m in list(sys.modules))\n"
        # the flag surface parses without PyYAML as long as no recipe is
        # named
        "from empanada_torch.cli.infer3d import parse_args\n"
        "assert parse_args(['m.yaml', 'v.zarr']).mode == 'orthoplane'\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_parallel_imports_nothing_of_jax():
    """The multi-device modules, and everything they reach, import no
    jax, flax, optax or empanada_tpu (nothing is blocked here: the check
    is what a plain import loads)."""
    code = (
        "import sys, importlib\n"
        f"for name in {list(PARALLEL_MODULES)!r}:\n"
        "    importlib.import_module(name)\n"
        "from empanada_torch.parallel.multihost import "
        "multihost_run_inference3d\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {BLOCKED!r}]\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_bench_heads_imports_nothing_of_jax():
    """The bench MitoNet's module (fit, splice, content-free heads, the
    bench volumes) and everything it reaches import no jax, flax, optax
    or empanada_tpu."""
    code = (
        "import sys\n"
        "from empanada_torch import bench_heads\n"
        "from empanada_torch.bench_heads import fit, splice, content_free\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {BLOCKED!r}]\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_bench_imports_nothing_of_jax():
    """The benchmark entry point (``python -m empanada_torch.bench``) and
    everything its sections reach import no jax, flax, optax or
    empanada_tpu, nor the JAX package's ``tools``."""
    code = (
        "import sys\n"
        "from empanada_torch import bench\n"
        "from empanada_torch.bench import run_bench, main\n"
        "from empanada_torch.cli.infer3d import run_inference3d\n"
        "from empanada_torch.evaluation.evaluator import default_evaluator\n"
        "from empanada_torch.models.quantization import quantize_model\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{BLOCKED + ('tools',)!r}]\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_entry_imports_nothing_of_jax():
    """``empanada_torch.entry`` (``entry``, ``dryrun_multichip`` and
    everything the dry run reaches: the trainer, the mesh, the orthoplane
    path, the synthetic model) imports no jax, flax, optax or
    empanada_tpu, nor the JAX package's root ``__graft_entry__``."""
    code = (
        "import sys\n"
        "from empanada_torch.entry import entry, dryrun_multichip, main\n"
        "from empanada_torch.train import Trainer\n"
        "from empanada_torch.cli.infer3d import run_inference3d\n"
        "from empanada_torch.synthetic import SyntheticModule\n"
        "from empanada_torch.cli.train import _free_port\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{BLOCKED + ('__graft_entry__',)!r}]\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_entry_points_of_entry_raise_without_cuda(monkeypatch):
    from empanada_torch import entry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.main([])
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.main(["2"])
    with pytest.raises(SystemExit):
        entry.main(["--device", "cpu"])  # n must be named on the CPU


def test_import_neither_builds_nor_loads_the_host_core():
    """Importing the package, its core and chip_smoke.py starts no
    build and loads no library; the first call of a host-core function
    does both."""
    names = [m.name for m in pkgutil.walk_packages(
        empanada_torch.__path__, "empanada_torch.")]
    code = (
        "import sys\n"
        "from empanada_torch import cuda_build, native_build\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError('a build was started at import')\n"
        "real = native_build.build, cuda_build.build_all\n"
        "native_build.build = cuda_build.build_all = refuse\n"
        "import importlib\n"
        "import empanada_torch\n"
        "import empanada_torch.core\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "from empanada_torch.core import native\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert native._lib is None and 'libetpu_core' not in maps\n"
        "assert not any(m.split('.')[0] in ('jax', 'empanada_tpu', 'yaml')\n"
        "               for m in sys.modules)\n"
        "native_build.build, cuda_build.build_all = real\n"
        "import numpy as np\n"
        "from empanada_torch.core import ranges_intersection\n"
        "assert ranges_intersection(np.array([[0, 5]]),\n"
        "                           np.array([[3, 9]])) == 2\n"
        "assert native._lib is not None\n"
        "assert 'libetpu_core' in open('/proc/self/maps').read()\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_sources_never_import_jax_or_the_jax_package():
    pattern = re.compile(
        r"^\s*(import|from)\s+(" + "|".join(BLOCKED) + r")\b", re.M)
    offenders = [str(p.relative_to(ROOT)) for p in _port_sources()
                 if pattern.search(p.read_text())]
    assert offenders == []


def test_sources_never_import_cv2_or_msgpack():
    """The card machine has neither: the port reproduces cv2's kernels
    in numpy and decodes flax's msgpack itself."""
    pattern = re.compile(r"^\s*(import|from)\s+(cv2|msgpack)\b"
                         r"|__import__\(\s*['\"](cv2|msgpack)", re.M)
    offenders = [str(p.relative_to(ROOT)) for p in _port_sources()
                 if pattern.search(p.read_text())]
    assert offenders == []


def test_artifact_and_curation_entry_points_raise_without_cuda(
        monkeypatch, tmp_path):
    """Calibrated int8 export (``import_torch_model`` passes through it)
    and the patch filter default to CUDA and raise without a card;
    naming the CPU runs them there."""
    from empanada_torch.data.curation import PatchQualityFilter
    from empanada_torch.export import export_model
    from empanada_torch.models import create_model

    cfg = {"arch": "PanopticBiFPNPR", "encoder": "regnety_200mf",
           "fpn_layers": 1, "num_classes": 1}
    state = create_model(device="cpu", seed=0, **cfg).state_dict()
    batch = [np.random.default_rng(0).normal(0, 1, (1, 1, 128, 128))
             .astype(np.float32)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PatchQualityFilter("resnet18", imsize=32)
    with pytest.raises(RuntimeError, match="CUDA"):
        export_model(state, cfg, str(tmp_path / "q"), "q", quantize=True,
                     calibration_data=batch)
    assert not (tmp_path / "q").exists()  # refused before any write
    assert PatchQualityFilter("resnet18", imsize=32, device="cpu") \
        .device == torch.device("cpu")
    desc = export_model(state, cfg, str(tmp_path / "c"), "c", quantize=True,
                        calibration_data=batch, device="cpu")
    assert desc["quantize_scope"] == "encoder" and desc["act_scales"]


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    from empanada_torch.cli.infer3d import main, run_inference3d
    from empanada_torch.export import load_exported_model
    from empanada_torch.inference.fused import FusedStackEngine
    from empanada_torch.models import create_model
    from empanada_torch.synthetic import SyntheticModule

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        create_model("PanopticBiFPNPR", encoder="regnety_200mf",
                     fpn_layers=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        FusedStackEngine(SyntheticModule(), None, [1])
    with pytest.raises(RuntimeError, match="CUDA"):
        run_inference3d(SyntheticModule(), np.zeros((4, 16, 16), np.float32),
                        labels=[1], thing_list=[1], mode="stack")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_inference3d(SyntheticModule(), np.zeros((4, 16, 16), np.float32),
                        labels=[1], thing_list=[1])  # orthoplane, the default
    with pytest.raises(RuntimeError, match="CUDA"):
        load_exported_model(str(tmp_path / "model.yaml"))
    with pytest.raises(RuntimeError, match="CUDA"):
        main([str(tmp_path / "model.yaml"), str(tmp_path / "volume.npy")])


def test_training_entry_points_raise_without_cuda(monkeypatch):
    from empanada_torch.inference.engines import create_engine
    from empanada_torch.train import Trainer

    config = {"DATASET": {"labels": [1], "thing_list": [1]},
              "MODEL": {"arch": "PanopticBiFPNPR",
                        "encoder": "regnety_200mf", "fpn_layers": 1},
              "TRAIN": {}}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(config)
    with pytest.raises(RuntimeError, match="CUDA"):
        create_engine("PanopticDeepLabEngine", None, thing_list=[1])
    from empanada_torch.parallel import create_mesh

    with pytest.raises(RuntimeError, match="CUDA"):
        create_mesh()
    assert Trainer(config, device="cpu").device == torch.device("cpu")
    engine = create_engine("PanopticDeepLabRenderEngine", None,
                           thing_list=[1], device="cpu")
    assert engine.device == torch.device("cpu")


def test_dispatcher_lists_the_training_commands():
    proc = subprocess.run([sys.executable, "-m", "empanada_torch", "--help"],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0
    commands = {"infer3d", "train", "finetune", "export", "evaluate3d",
                "evaluate3d-bc", "evaluate3d_bc", "curate"}
    for command in commands:
        assert command in proc.stdout
    from empanada_torch.__main__ import COMMANDS

    assert set(COMMANDS) == commands


def test_dispatcher_holds_every_command_of_the_jax_package():
    """Every command name of the JAX package's dispatcher reaches the
    port's module of the same name."""
    pytest.importorskip("jax", reason="needs the JAX package's dispatcher")
    from empanada_torch.__main__ import COMMANDS
    from empanada_tpu.__main__ import COMMANDS as JAX_COMMANDS

    for name, module in JAX_COMMANDS.items():
        assert COMMANDS[name] == module.replace("empanada_tpu.",
                                                "empanada_torch.", 1), name


@pytest.mark.parametrize("name", ["evaluate3d-bc", "evaluate3d_bc"])
def test_both_bc_evaluation_names_reach_the_port_command(name):
    """``evaluate3d-bc`` (the JAX package's name) and ``evaluate3d_bc``
    (the port's earlier one) dispatch to ``empanada_torch.cli.
    evaluate3d_bc``."""
    code = (
        "import sys\n"
        "import empanada_torch.cli.evaluate3d_bc as cmd\n"
        "seen = []\n"
        "cmd.main = seen.append\n"
        f"sys.argv = ['empanada_torch', {name!r}, 'a.yaml', 'v.zarr']\n"
        "from empanada_torch.__main__ import main\n"
        "main()\n"
        "assert seen == [['a.yaml', 'v.zarr']], seen\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    help_run = subprocess.run(
        [sys.executable, "-m", "empanada_torch", name, "--help"], cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert help_run.returncode == 0, help_run.stderr
    assert "-seed-thres" in help_run.stdout


def test_evaluation_and_bc_entry_points_raise_without_cuda(monkeypatch,
                                                           tmp_path):
    """The slice's entry points default to CUDA and raise without a
    card; none of them falls back to the CPU or to the numpy flood."""
    from empanada_torch.cli import evaluate3d, evaluate3d_bc
    from empanada_torch.inference.engines import create_engine
    from empanada_torch.inference.watershed import bc_watershed
    from empanada_torch.synthetic import SyntheticBCModule

    vol = np.zeros((2, 4, 8, 8), np.uint8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("BCEngine", "BCEngine3d", "PanopticDeepLabEngine3d",
                 "PanopticDeepLabRenderEngine3d"):
        with pytest.raises(RuntimeError, match="CUDA"):
            create_engine(name, None, thing_list=[1])
    with pytest.raises(RuntimeError, match="CUDA"):
        bc_watershed(vol)
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate3d_bc.run_bc_inference3d(SyntheticBCModule(), vol[0])
    for main in (evaluate3d.main, evaluate3d_bc.main):
        with pytest.raises(RuntimeError, match="CUDA"):
            main([str(tmp_path / "m.yaml"), str(tmp_path / "v.npy"),
                  str(tmp_path / "gt.json")])
    # a CUDA device named where there is none raises in torch: no
    # quiet CPU run
    with pytest.raises((RuntimeError, AssertionError)):
        bc_watershed(vol, device="cuda")


def test_png_codec_reads_where_no_image_library_imports(tmp_path):
    """With cv2, imageio and PIL blocked the readers fall back to the
    package's own PNG codec and read what it wrote."""
    code = (
        "import sys\n"
        "for name in ('cv2', 'imageio', 'PIL'):\n"
        "    sys.modules[name] = None\n"
        "import numpy as np\n"
        "from empanada_torch.data import image_files as f\n"
        "a = np.arange(12 * 9, dtype=np.uint16).reshape(12, 9) * 300\n"
        f"f.write_png({str(tmp_path / 'm.png')!r}, a)\n"
        f"m = f.read_mask({str(tmp_path / 'm.png')!r})\n"
        "assert f.reader() == 'png-codec'\n"
        "assert m.dtype == np.int64 and (m == a).all()\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("kwargs", [
    {"mesh": [torch.device("cpu")] * 2, "block_size": 3}])
def test_mesh_and_resident_are_refused_by_name(kwargs):
    """A mesh runs, and refuses a block that does not divide over it, as
    the JAX engine does (the resident path runs: its refusals are in
    test_torch_resident.py)."""
    from empanada_torch.cli.infer3d import run_inference3d
    from empanada_torch.parallel import create_mesh
    from empanada_torch.synthetic import SyntheticModule

    kwargs = dict(kwargs)
    kwargs["mesh"] = create_mesh(devices=kwargs["mesh"])
    with pytest.raises(ValueError, match="must divide over the 2-device "
                                         "mesh"):
        run_inference3d(SyntheticModule(), np.zeros((4, 16, 16), np.float32),
                        labels=[1], thing_list=[1], device="cpu", **kwargs)


def test_parity_numerics_disable_tf32():
    from empanada_torch.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_group_wrapper_cpu_uses_plain_and_checks_devices():
    c = torch.zeros((1, 4, 2), dtype=torch.int32)
    v = torch.ones((1, 4), dtype=torch.bool)
    o = torch.zeros((1, 8, 8, 2))
    before = group.LAUNCHES["group_pixels"]
    out = group.group_pixels_batched(c, v, o, 4.0)
    assert group.LAUNCHES["group_pixels"] == before
    assert out.shape == (1, 8, 8) and out.dtype == torch.int32
    with pytest.raises(ValueError, match="device"):
        group.group_pixels_batched(c, v, o.to("meta"), 4.0)


@pytest.mark.cuda
def test_group_kernel_matches_plain_on_card():
    """Runs only where a card is present (chip_smoke.py covers the same
    ground at the main path's shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.default_rng(0)
    b, h, w, k = 4, 64, 64, 256
    c = torch.from_numpy(rng.integers(0, h, (b, k, 2)).astype(np.int32))
    v = torch.from_numpy(rng.random((b, k)) < np.array([[1.0], [0.2],
                                                        [0.0], [0.5]]))
    o = torch.from_numpy((np.round(rng.standard_normal((b, h, w, 2)) * 16)
                          / 2).astype(np.float32))
    for step in (1.0, 4.0):
        want = group.group_pixels_plain(c, v, o, step)
        got = group.group_pixels_batched(c.cuda(), v.cuda(), o.cuda(), step)
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


@pytest.mark.cuda
def test_resolve_device_names_the_card_the_kernel_launches_on():
    """With no device named, resolve_device gives the current card by
    its index; a tensor made there and the grouping kernel's launch land
    on that card, on every visible card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from empanada_torch.device import resolve_device

    rng = np.random.default_rng(1)
    c = torch.from_numpy(rng.integers(0, 32, (2, 16, 2)).astype(np.int32))
    v = torch.ones((2, 16), dtype=torch.bool)
    o = torch.from_numpy(rng.normal(0, 4, (2, 32, 32, 2)).astype(np.float32))
    want = group.group_pixels_plain(c, v, o, 4.0)
    for index in range(torch.cuda.device_count()):
        with torch.cuda.device(index):
            dev = resolve_device()
            assert dev == torch.device("cuda", index)
            assert resolve_device("cuda") == dev
            x = torch.zeros(1, device=dev)
            group.reset_launches()
            got = group.group_pixels_batched(c.to(dev), v.to(dev),
                                             o.to(dev), 4.0)
            assert got.device == x.device == dev
            assert group.LAUNCHES_BY_CARD == {index: 1}
            torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


@pytest.mark.cuda
def test_bc_decoding_on_card_equals_cpu():
    """Runs only where a card is present (chip_smoke.py covers the same
    ground at full size): the device flood equals the numpy plain
    version, and the BC twin's labels on the card equal the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from empanada_torch.cli.evaluate3d_bc import run_bc_inference3d
    from empanada_torch.inference.watershed import (
        bc_watershed,
        bc_watershed_numpy,
    )
    from empanada_torch.synthetic import SyntheticBCModule

    rng = np.random.default_rng(0)
    zz, yy, xx = np.mgrid[:12, :40, :36]
    inside = ((zz - 6) / 5.0) ** 2 + ((yy - 20) / 15.0) ** 2 \
        + ((xx - 18) / 12.0) ** 2 <= 1
    vol = (inside + rng.normal(0, 0.05, inside.shape)).astype(np.float32)
    kw = dict(padding_factor=16, seg_thr=0.9, cnt_thr=0.3, fg_thr=0.5,
              seed_thres=4, min_size=16, progress=False)
    got = run_bc_inference3d(SyntheticBCModule(), vol, device="cuda", **kw)
    want = run_bc_inference3d(SyntheticBCModule(), vol, device="cpu", **kw)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) == 2
    stacks = np.stack([(inside * 200 + rng.integers(0, 50, inside.shape)),
                       rng.integers(0, 120, inside.shape)]).astype(np.uint8)
    kw = dict(thres1=0.7, thres2=0.4, thres3=0.3, seed_thres=2, min_size=4)
    np.testing.assert_array_equal(bc_watershed(stacks, device="cuda", **kw),
                                  bc_watershed_numpy(stacks, **kw))
