"""Nothing the benchmark runs loads JAX, the JAX package or its harness."""
import ast
import subprocess
import sys

import pytest

from perfbench import harness, manifest

PROBE = """
import sys
sys.path.insert(0, {root!r})
import runpy
runpy.run_path({run!r}, run_name="perfbench_run")
from perfbench import control, harness, manifest
harness.import_program()
m = manifest.load_manifest()
for x in [*m["end_to_end"], *m["per_layer"]]:
    manifest.reader(x["name"])
print(" ".join(sorted({{n.split(".", 1)[0] for n in sys.modules}})))
"""


def test_a_run_imports_nothing_forbidden():
    code = PROBE.format(root=str(manifest.ROOT), run=str(manifest.HERE / "run.py"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True, cwd=manifest.ROOT).stdout.split()
    assert "repro_torch" in out and "torch" in out
    assert not set(out) & harness.FORBIDDEN, set(out) & harness.FORBIDDEN


@pytest.mark.parametrize(("names", "found"), [
    (["repro_torch", "repro_torch.core", "jax_free", "reprox"], []),
    (["repro.core"], ["repro"]),
    (["jaxlib.xla_client", "flax"], ["flax", "jaxlib"]),
    (["benchmarks.run"], ["benchmarks"]),
])
def test_forbidden_names_compare_whole_top_level_names(monkeypatch, names, found):
    fake = {n: None for n in names}
    monkeypatch.setattr(sys, "modules", fake)
    assert harness.forbidden_modules() == found


def test_sources_import_nothing_forbidden():
    for path in manifest.HERE.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".", 1)[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                tops = [node.module.split(".", 1)[0]]
            else:
                continue
            assert not set(tops) & harness.FORBIDDEN, (path, tops)


def test_reference_imports_nothing_of_the_program():
    tree = ast.parse((manifest.HERE / "reference.py").read_text())
    mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    mods |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
    assert {m.split(".", 1)[0] for m in mods} <= {"__future__", "dataclasses", "math", "numpy",
                                                  "torch"}
