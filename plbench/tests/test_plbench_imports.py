"""Nothing that the benchmark runs imports JAX or the JAX package, by the
top-level module name as a whole word (the port's name begins with it)."""
import ast
import os
import subprocess
import sys

from plbench import cell

BANNED = {"jax", "jaxlib", "flax", "plslam"}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_sources_import_no_jax():
    for d, _, files in os.walk(cell.HERE):
        for f in files:
            if f.endswith(".py"):
                tops = set(_imports(os.path.join(d, f)))
                assert not tops & BANNED, (f, tops & BANNED)


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(cell.HERE, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            tops = set(_imports(os.path.join(ref, f)))
            assert not tops & (BANNED | {"plslam_torch"}), (f, tops)


def test_loaded_modules():
    """The harness's modules and the reference, imported in a fresh process,
    load no banned module and nothing of the port."""
    code = ("import sys; import plbench.checks, plbench.scene, plbench.trace, plbench.bounds; "
            "import plbench.reference.backend, plbench.reference.lk, plbench.reference.pgo, "
            "plbench.reference.hamming; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=cell.ROOT, capture_output=True,
                         text=True, check=True).stdout
    tops = set(eval(out))
    assert not tops & (BANNED | {"plslam_torch"}), tops


def test_banned_check_is_by_whole_name(monkeypatch):
    import types

    from plbench import run

    before = set(run.banned_modules())
    monkeypatch.setitem(sys.modules, "plslam_torch", types.ModuleType("plslam_torch"))
    monkeypatch.setitem(sys.modules, "plslamx.y", types.ModuleType("plslamx.y"))
    assert set(run.banned_modules()) == before
    monkeypatch.setitem(sys.modules, "plslam.runner", types.ModuleType("plslam.runner"))
    assert set(run.banned_modules()) == before | {"plslam"}
