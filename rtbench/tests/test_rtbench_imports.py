"""Nothing under rtbench/ imports JAX or the JAX package (top-level
names compared whole), and the reference imports nothing of the port."""
import ast
import os
import sys

from rtbench.harness.core import FORBIDDEN, forbidden_modules
from rtbench.harness.registry import BENCH_DIR, ROOT


def imported(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value.split(".")[0]


def sources(folder):
    for base, _, files in os.walk(folder):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def test_no_module_imports_jax_or_the_jax_package():
    for path in sources(BENCH_DIR):
        bad = set(imported(path)) & set(FORBIDDEN)
        assert not bad, f"{path} imports {bad}"


def test_the_reference_imports_nothing_of_the_port():
    for path in sources(os.path.join(BENCH_DIR, "reference")):
        names = set(imported(path))
        assert not names & {"rray_tpu_torch", "rtbench", *FORBIDDEN}, path


def test_the_whole_name_is_compared():
    assert forbidden_modules(["rray_tpu_torch.api", "jaxtyping"]) == []
    assert forbidden_modules(["rray_tpu.cli", "jax.numpy", "flax"]) == [
        "flax", "jax", "rray_tpu"]
    assert forbidden_modules(["rtbench.run", "benchmark_utils"]) == []
    assert forbidden_modules(["bench", "benchmarks.ray"]) == [
        "bench", "benchmarks"]


def test_a_run_loads_no_jax_module():
    """Every cell, untraced and traced, with its check, its control and
    every metric reader: nothing of JAX or the JAX package is loaded at
    the end."""
    from conftest import run_every_cell

    loaded = set(run_every_cell(ROOT)["modules"])
    assert "rray_tpu_torch" in loaded
    assert not loaded & set(FORBIDDEN)


def test_a_module_loaded_late_withholds_the_result(monkeypatch, capsys):
    """run.py looks at sys.modules last, after the check and the readers:
    a forbidden module found then means exit 1 and no result line."""
    import importlib.util
    import types

    spec = importlib.util.spec_from_file_location(
        "rtbench_run", os.path.join(BENCH_DIR, "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    result = {"correct": True, "checks": {}}
    assert mod.finish(result, []) == 0
    assert capsys.readouterr().out.strip() == '{"correct": true, "checks": {}}'
    for name in ("benchmarks.harness", "bench", "jax"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
        assert mod.finish(result, []) == 1
        out = capsys.readouterr()
        assert out.out == "" and name.split(".")[0] in out.err
        monkeypatch.delitem(sys.modules, name)
