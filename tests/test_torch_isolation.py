"""The port stands alone: importing `repro_torch` loads neither JAX nor the
JAX package, builds no kernel, and no file of the port (or chip_smoke.py)
imports either (nor the JAX harness, `benchmarks`, or its `examples`)."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro", "benchmarks", "examples")


def test_import_loads_no_jax_and_no_reference():
    code = (
        "import json, sys\n"
        "import repro_torch, repro_torch.engine, repro_torch.kernels, repro_torch.interop\n"
        "import repro_torch.batch, repro_torch.serve, repro_torch.obs, repro_torch.obs.__main__\n"
        "import repro_torch.sweep, repro_torch.roofline, repro_torch.core.distributed\n"
        "import repro_torch.launch, repro_torch.analysis, repro_torch.analysis.__main__\n"
        "import repro_torch.examples.decompose_tensor, repro_torch.examples.quickstart\n"
        "import repro_torch.models, repro_torch.configs, repro_torch.data\n"
        "import repro_torch.launch.steps, repro_torch.examples.serve_lm\n"
        "import repro_torch.optim, repro_torch.checkpoint, repro_torch.launch.elastic\n"
        "import repro_torch.models.moe, repro_torch.models.ssm, repro_torch.models.xlstm\n"
        "import repro_torch.launch.shardings, repro_torch.launch.dryrun, repro_torch.bench.tp\n"
        "from repro_torch.launch.steps import make_train_step, init_opt_shapes\n"
        "assert not repro_torch.kernels._build._libs  # nothing built on import\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "    if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=120, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_file_imports_jax_or_reference(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"
