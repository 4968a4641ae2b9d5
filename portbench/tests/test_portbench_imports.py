"""No module of the benchmark imports JAX, flax or the JAX package, and
the plain reference imports nothing of the program: module names
compared whole, by their top-level part."""

import ast
import subprocess
import sys

from portbench.spec import HERE, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "empanada_tpu"}


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def _module_path(name):
    rel = name.split(".")[1:]
    pkg = HERE.joinpath(*rel)
    return pkg / "__init__.py" if pkg.is_dir() else pkg.with_suffix(".py")


def test_no_module_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        tops = {n.split(".")[0] for n in _imports(path)}
        assert not tops & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    seen, todo = set(), [p for p in (HERE / "reference").glob("*.py")]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in FORBIDDEN | {"empanada_torch"}, (path, name)
            if top == "portbench":
                todo.append(_module_path(name))


def test_loading_the_harness_loads_no_jax():
    code = ("import sys, portbench.run, portbench.drivers.train, "
            "portbench.calibrate, portbench.flops, portbench.trace\n"
            "import empanada_torch.train.trainer\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'empanada_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
