"""What the benchmark loads: never JAX or the JAX package, and the
reference nothing of the port.  Top-level module names are compared
whole: ``amq_tpu_torch`` begins with ``amq_tpu`` and is the port."""

from __future__ import annotations

import ast
import subprocess
import sys

from conftest import REPO
from perfbench import bench

#: top-level names nothing under perfbench/ may import
BANNED = {"jax", "jaxlib", "flax", "amq_tpu", "chip_smoke", "benchmarks",
          "scripts", "bench"}


def _imported_tops(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_the_jax_package():
    for path in (REPO / "perfbench").rglob("*.py"):
        assert not set(_imported_tops(path)) & BANNED, path


def test_reference_sources_import_nothing_of_the_port():
    for path in (REPO / "perfbench" / "reference").rglob("*.py"):
        assert "amq_tpu_torch" not in set(_imported_tops(path)), path


def _loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=REPO, capture_output=True, text=True, timeout=600, check=True)
    return set(out.stdout.split())


def test_a_run_loads_no_jax_module(tmp_path):
    """A whole CPU run of the tiny cell (loop, program, reference,
    metrics) leaves no forbidden top-level module loaded."""
    code = (f"import sys; sys.path.insert(0, {str(REPO / 'perfbench' / 'tests')!r})\n"
            "from pathlib import Path\n"
            "from conftest import make_tiny_root, run_tiny\n"
            "from perfbench import bench\n"
            f"root = make_tiny_root(Path({str(tmp_path)!r}))\n"
            "run = run_tiny(root, 2**31 + 9, 0.3)\n"
            "bench.read_metrics(run.cell['end_to_end'] + run.cell['per_layer'], run, root)\n"
            "import perfbench.run\n"
            "assert not bench.forbidden_modules()")
    loaded = _loaded_after(code)
    assert "amq_tpu_torch" in loaded
    assert not loaded & set(bench.FORBIDDEN)


def test_reference_loads_nothing_of_the_port():
    loaded = _loaded_after("import perfbench.reference.llama")
    assert "amq_tpu_torch" not in loaded
    assert not loaded & set(bench.FORBIDDEN)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "amq_tpu_torch_x", sys)
    assert "amq_tpu" not in bench.forbidden_modules()
    monkeypatch.setitem(sys.modules, "amq_tpu.models", sys)
    assert bench.forbidden_modules() == ["amq_tpu"]
