"""The port stands alone: empanada_torch and chip_smoke.py import nothing
of JAX or the JAX package (and PyYAML only inside the functions that
read or write a descriptor), importing them neither compiles nor loads
the C++ host core (that happens at first use), entry points never fall
back to the CPU on their own, and the CUDA kernel path is taken only for
CUDA tensors."""

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


def _port_sources():
    return sorted((ROOT / "empanada_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def test_every_module_imports_with_jax_blocked():
    names = [m.name for m in pkgutil.walk_packages(
        empanada_torch.__path__, "empanada_torch.")]
    assert "empanada_torch.inference.fused" in names
    assert set(NEW_MODULES + HOST_CORE_MODULES) <= set(names)
    blocked = BLOCKED + ("yaml",)
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


@pytest.mark.parametrize("kwargs", [{"mesh": object()}, {"resident": True}])
def test_mesh_and_resident_are_refused_by_name(kwargs):
    from empanada_torch.cli.infer3d import run_inference3d
    from empanada_torch.synthetic import SyntheticModule

    with pytest.raises(NotImplementedError, match="mesh and device-resident"):
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
