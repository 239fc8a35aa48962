"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference takes nothing of the program: top-level module names compared
whole, since ``repro_torch`` begins with ``repro``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

from servebench import run

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_forbidden_names_are_compared_whole():
    assert run.forbidden_modules(["repro_torch", "repro_torch.engine",
                                  "reprox", "jaxtyping", "torch"]) == []
    assert run.forbidden_modules(["repro.engine", "jax.numpy", "jaxlib",
                                  "flax.linen", "torch"]) == \
        ["flax", "jax", "jaxlib", "repro"]


def test_reference_imports_nothing_of_the_program():
    for path in sorted((HERE / "reference").glob("*.py")):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top in {"__future__", "typing", "itertools", "torch",
                           "servebench"}, \
                (path.name, name)
            if top == "servebench":
                assert name.startswith("servebench.reference"), name


def test_harness_sources_import_no_jax():
    files = [p for p in HERE.rglob("*.py") if not p.name.startswith("test_")]
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] not in run.FORBIDDEN, (path, name)
        assert "benchmarks/" not in path.read_text(), path


def test_loaded_modules_of_a_harness_process():
    """Every module of the harness, the reference and the metric readers,
    and the port's engine they drive, imported in a fresh process: no
    top-level name is jax, jaxlib, flax or repro."""
    readers = sorted(str(p) for p in (HERE / "metrics").glob("*.py"))
    code = (
        "import sys, importlib.util\n"
        "import servebench.run, servebench.bench, servebench.check, "
        "servebench.sweep, servebench.control, servebench.profiling, "
        "servebench.faults, servebench.reference.model\n"
        "import repro_torch.engine.engine, repro_torch.models.lm\n"
        f"for i, p in enumerate({readers!r}):\n"
        "    s = importlib.util.spec_from_file_location(f'r{i}', p)\n"
        "    importlib.util.module_from_spec(s).__spec__.loader"
        ".exec_module(importlib.util.module_from_spec(s))\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        "print(servebench.run.forbidden_modules())\n")
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(REPO), str(REPO / "src")]))
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-2000:]
    names, bad = p.stdout.strip().splitlines()[-2:]
    assert bad == "[]", names
    assert "'repro_torch'" in names and "'torch'" in names
