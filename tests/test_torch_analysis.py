"""The port's static-analysis suite (`repro_torch.analysis`) against the JAX
package's (`repro.analysis`) on the same inputs: per-rule good/bad fixtures,
the shared rules and suppression semantics giving the same (rule, line)
lists, the copied modules giving equal output, mutations of a copied tree
(one finding each, the CUDA kernel's shifts included), the pins equal to the
reference's, the live tree clean under --strict, and the CLI."""
import dataclasses
import json
import shutil
import textwrap

import pytest

import repro.analysis as ref_analysis
import repro_torch.analysis as port_analysis
from repro.analysis.docanchors import extract_anchor_refs as ref_anchor_refs
from repro.analysis.docanchors import extract_anchors as ref_anchors
from repro.analysis.engine import parse_suppressions as ref_parse_suppressions
from repro_torch.analysis import (
    check_source,
    extract_anchor_refs,
    extract_anchors,
    extract_schema,
    load_contracts,
    regen_manifest,
    registered_rules,
    rule_table,
    run_analysis,
    to_sarif,
)
from repro_torch.analysis.__main__ import main as cli_main
from repro_torch.analysis.engine import parse_suppressions
from repro_torch.engine import registry

REPO = port_analysis.default_root()
PORT_DOC = "docs/torch-static-analysis.md"


def _src(snippet: str) -> str:
    return textwrap.dedent(snippet).lstrip("\n")


# ---------------------------------------------------------------------------
# fixtures: every file rule fires on its bad snippet, not on its good one
# ---------------------------------------------------------------------------

HOST_SYNC_LOOP = _src("""
    import torch

    def probe(xs):
        total = 0.0
        for x in xs:
            total += float(torch.sum(x))
        return total
""")

HOST_SYNC_READOUTS = _src("""
    import numpy as np
    import torch

    def fit(factors, lam, host, device):
        had = torch.outer(lam, lam)
        inner = torch.dot(lam, lam)
        up = torch.from_numpy(host).to(device)
        torch.cuda.synchronize(device)
        return had.sum().item(), np.asarray(inner), up
""")

HOST_SYNC_DATA_DEPENDENT = _src("""
    import torch

    def update(m: torch.Tensor, v: torch.Tensor, idx: torch.Tensor):
        keep = torch.nonzero(idx > 0)
        if (v < 0).any():
            v = v[v > 0]
        return m @ torch.linalg.pinv(v), keep
""")

HOST_SYNC_GOOD = _src("""
    import numpy as np
    import torch

    def probe(xs, host, device, shape):
        total = torch.zeros(())
        for x in xs:
            total = total + torch.sum(x)
        if xs[0].device.type == "cpu" and xs[0].dim() == 2:
            pass
        rows = int(xs[0].shape[0])
        scale = torch.tensor(shape, dtype=torch.int32).pin_memory()
        up = torch.from_numpy(host).to(device, non_blocking=True)
        n = np.asarray(host).tolist()
        return total, rows, scale.to(device, non_blocking=True), up, n
""")

DICT_ORDER_BAD = _src("""
    _REGISTRY = {}

    def candidates():
        return [spec.name for spec in _REGISTRY.values()]
""")

DICT_ORDER_GOOD = _src("""
    _REGISTRY = {}

    def candidates():
        return [s.name for s in sorted(_REGISTRY.values(), key=lambda s: s.name)]

    def count():
        return len(_REGISTRY)
""")

NONDET_BAD = _src("""
    import time

    import numpy as np

    def sample(n):
        created = time.time()
        return created, np.random.rand(n)
""")

NONDET_GOOD = _src("""
    import time

    import numpy as np

    def sample(n, seed=0):
        t0 = time.perf_counter()
        rng = np.random.default_rng(seed)
        return time.perf_counter() - t0, rng.random(n)
""")

NONDET_TORCH_BAD = _src("""
    import torch

    def init(shape):
        torch.manual_seed(0)
        return torch.randn(shape), torch.randint(0, 9, shape)
""")

NONDET_TORCH_GOOD = _src("""
    import torch

    def init(shape, seed=0):
        g = torch.Generator().manual_seed(seed)
        return torch.randn(shape, generator=g), torch.zeros(shape)
""")

WIDTH_NUMPY_BAD = _src("""
    import numpy as np

    def grid(coords, chunk_shape):
        cs = np.asarray(chunk_shape, dtype=np.int64)
        return coords // cs.astype(np.int32)
""")

WIDTH_TORCH_BAD = _src("""
    import torch

    def order(keys):
        perm = torch.argsort(keys)
        wide = keys.long() * 3
        return perm.to(torch.int32), wide.int()
""")

WIDTH_GOOD = _src("""
    import numpy as np
    import torch

    def order(keys):
        perm = torch.argsort(keys)
        if perm.numel() > np.iinfo(np.int32).max:
            raise ValueError("more than 2**31 - 1 keys")
        return perm.to(torch.int32), keys.to(torch.int32)
""")

FIXTURES = [
    ("host-sync", HOST_SYNC_LOOP, HOST_SYNC_GOOD),
    ("host-sync", HOST_SYNC_READOUTS, HOST_SYNC_GOOD),
    ("host-sync", HOST_SYNC_DATA_DEPENDENT, HOST_SYNC_GOOD),
    ("dict-order-enumeration", DICT_ORDER_BAD, DICT_ORDER_GOOD),
    ("nondeterminism", NONDET_BAD, NONDET_GOOD),
    ("nondeterminism", NONDET_TORCH_BAD, NONDET_TORCH_GOOD),
    ("int32-index-width", WIDTH_NUMPY_BAD, WIDTH_GOOD),
    ("int32-index-width", WIDTH_TORCH_BAD, WIDTH_GOOD),
]


@pytest.mark.parametrize(("rule", "bad", "good"), FIXTURES,
                         ids=[f"{r}-{i}" for i, (r, _b, _g) in enumerate(FIXTURES)])
def test_rule_fires_on_bad_and_not_on_good(rule, bad, good):
    bad_hits = check_source(rule, bad)
    assert bad_hits, f"{rule} stayed quiet on its bad fixture"
    assert all(f.rule == rule and f.line > 0 for f in bad_hits)
    assert check_source(rule, good) == [], \
        f"{rule} false-positived on its good fixture: {[f.render() for f in check_source(rule, good)]}"


@pytest.mark.parametrize(("source", "lines"), [
    (HOST_SYNC_LOOP, [6]),
    (HOST_SYNC_READOUTS, [7, 8, 9, 9]),
    (HOST_SYNC_DATA_DEPENDENT, [4, 5, 6, 7]),
    (WIDTH_TORCH_BAD, [6, 6]),
    (NONDET_TORCH_BAD, [4, 5, 5]),
], ids=["loop", "readouts", "data-dependent", "width", "torch-rng"])
def test_rule_lines(source, lines):
    rule = {HOST_SYNC_LOOP: "host-sync", HOST_SYNC_READOUTS: "host-sync",
            HOST_SYNC_DATA_DEPENDENT: "host-sync", WIDTH_TORCH_BAD: "int32-index-width",
            NONDET_TORCH_BAD: "nondeterminism"}[source]
    assert sorted(f.line for f in check_source(rule, source)) == lines


def test_host_sync_loop_context_and_method_call_line():
    (hit,) = check_source("host-sync", HOST_SYNC_LOOP)
    assert "inside a loop" in hit.message
    # A method call is reported on its method name's line, as the interpreter
    # attributes it (and torch's sync warnings with it).
    src = _src("""
        import torch

        def up(a, device):
            return (torch.from_numpy(a)
                    .to(device))
    """)
    assert [f.line for f in check_source("host-sync", src)] == [5]


def test_host_sync_follows_module_functions_and_aliases():
    src = _src("""
        import torch
        import torch.distributed as dist

        def _coo(st, device) -> tuple:
            return (torch.from_numpy(st.c).to(device, non_blocking=True),
                    torch.from_numpy(st.v).to(device, non_blocking=True))

        def diff(st, device, coo=None):
            coords, values = coo if coo is not None else _coo(st, device)
            if dist.get_backend() == "nccl":
                pass
            return float((values - coords).abs().mean())
    """)
    assert [f.line for f in check_source("host-sync", src)] == [12]


# ---------------------------------------------------------------------------
# the rules both suites have agree on the same sources
# ---------------------------------------------------------------------------

def _lines(findings):
    return [(f.rule, f.line) for f in findings]


SHARED_SOURCES = [
    ("nondeterminism", NONDET_BAD),
    ("nondeterminism", NONDET_GOOD),
    ("nondeterminism", NONDET_BAD.replace(
        "created = time.time()",
        "created = time.time()  # repro-lint: disable=nondeterminism -- epoch field")),
    ("nondeterminism", "# repro-lint: disable-file=nondeterminism -- harness\n" + NONDET_BAD),
    ("nondeterminism", _src("""
        import random
        import time

        NOTE = "# repro-lint: disable-file=nondeterminism -- not a comment"

        def f():
            # repro-lint: disable=nondeterminism -- next line only
            a = time.time_ns()
            return a, random.random(), random.Random(0).random(), time.time()
    """)),
    ("dict-order-enumeration", DICT_ORDER_BAD),
    ("dict-order-enumeration", DICT_ORDER_GOOD),
    ("dict-order-enumeration", _src("""
        _A = dict()
        _B: dict = {}

        def f():
            for k in _A:
                pass
            xs = list(_B.items())
            return xs, next(iter(_A)), dict(sorted(_B.items()))
    """)),
]


@pytest.mark.parametrize(("rule", "source"), SHARED_SOURCES,
                         ids=[f"{r}-{i}" for i, (r, _s) in enumerate(SHARED_SOURCES)])
def test_shared_rules_match_reference(rule, source):
    port = check_source(rule, source)
    ref = ref_analysis.check_source(rule, source)
    assert _lines(port) == _lines(ref)


@pytest.mark.parametrize("source", [
    "x = 1  # repro-lint: disable=host-sync,nondeterminism -- why not\n",
    "# repro-lint: disable=host-sync — em-dash reason\nx = 1\n",
    "# repro-lint: disable-file=nondeterminism: colon reason\n",
    "x = 1  # repro-lint: disable=host-sync\n",
    "s = '# repro-lint: disable=host-sync -- in a string'\n",
    "def f(:\n  # repro-lint: disable=host-sync -- broken file\n",
], ids=["two-rules", "em-dash", "file-colon", "no-reason", "string", "broken"])
def test_suppression_parsing_matches_reference(source):
    port = parse_suppressions(source, "src/x.py")
    ref = ref_parse_suppressions(source, "src/x.py")
    assert [dataclasses.astuple(s) for s in port] == [dataclasses.astuple(s) for s in ref]


def test_meta_rules_match_reference(tmp_path):
    source = ("import time\n"
              "a = time.time()  # repro-lint: disable=nondeterminism\n"
              "b = 1  # repro-lint: disable=nondeterminism -- nothing to waive\n"
              "c = 2  # repro-lint: disable=nondeterminsm -- typo'd id\n"
              "d = time.time()  # repro-lint: disable=nondeterminism -- epoch field\n")
    results = []
    for pkg, run in (("repro", ref_analysis.run_analysis), ("repro_torch", run_analysis)):
        root = tmp_path / pkg
        dst = root / "src" / pkg / "core" / "snippet.py"
        dst.parent.mkdir(parents=True)
        dst.write_text(source)
        res = run(root, rules=["nondeterminism"], strict=True)
        results.append((_lines(res.findings), _lines(res.suppressed),
                        [(s.line, s.rules) for s in res.unused_suppressions]))
    assert results[0] == results[1]
    assert {r for r, _ in results[1][0]} == {"suppression-missing-reason",
                                             "unknown-suppression", "unused-suppression"}


def test_syntax_error_matches_reference(tmp_path):
    lines = []
    for pkg, run in (("repro", ref_analysis.run_analysis), ("repro_torch", run_analysis)):
        dst = tmp_path / pkg / "src" / pkg / "core" / "broken.py"
        dst.parent.mkdir(parents=True)
        dst.write_text("x = 1\ndef f(:\n")
        lines.append(_lines(run(tmp_path / pkg, rules=["nondeterminism"]).findings))
    assert lines[0] == lines[1] == [("syntax-error", 2)]


# ---------------------------------------------------------------------------
# the copied modules give equal output
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rel", ["docs/candidates.md", "docs/torch-candidates.md",
                                 "docs/static-analysis.md", PORT_DOC, "README.md"])
def test_docanchors_match_reference(rel):
    text = (REPO / rel).read_text(encoding="utf-8")
    assert extract_anchors(text) == ref_anchors(text)
    assert extract_anchor_refs(text) == ref_anchor_refs(text)


def test_sarif_matches_reference():
    findings = [("syntax-error", "src/a.py", 3, "file does not parse: x"),
                ("fixture-rule", "src/b.py", 0, "a finding")]
    logs = []
    for pkg in (ref_analysis, port_analysis):
        result = pkg.AnalysisResult(
            root=".", n_files=2, findings=[pkg.Finding(*f) for f in findings],
            suppressed=[], unused_suppressions=[], rules=("syntax-error",))
        logs.append(pkg.to_sarif(result))
    port = json.dumps(logs[1]).replace(PORT_DOC, "docs/static-analysis.md").replace(
        "repro_torch.analysis", "repro.analysis")
    assert json.loads(port) == logs[0]
    assert logs[1]["runs"][0]["results"][1]["locations"][0]["physicalLocation"][
        "region"] == {"startLine": 1}


# ---------------------------------------------------------------------------
# mutations of a copied tree: one finding each
# ---------------------------------------------------------------------------

def _copy_tree(dst):
    shutil.copytree(REPO / "src" / "repro_torch", dst / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel in ("chip_smoke.py", "docs/candidates.md", "docs/torch-candidates.md"):
        (dst / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(REPO / rel, dst / rel)
    (dst / "tests").mkdir()
    for p in (REPO / "tests").glob("test_torch_*.py"):
        shutil.copy(p, dst / "tests" / p.name)
    return dst


def _edit(root, rel, old, new):
    p = root / rel
    text = p.read_text(encoding="utf-8")
    assert old in text, f"{rel} no longer holds {old!r}"
    p.write_text(text.replace(old, new, 1), encoding="utf-8")


MUTATIONS = {
    "cuda-matrix-shift": ("qformat-accumulator", "src/repro_torch/kernels/csrc/mttkrp_fixed.cu",
                          "(wrap_mul(p, x) >> matrix_frac)", "wrap_mul(p, x)"),
    "cuda-out-shift": ("qformat-accumulator", "src/repro_torch/kernels/csrc/mttkrp_fixed.cu",
                       "static_cast<int32_t>(v)) >> out_shift", "static_cast<int32_t>(v))"),
    "binding-out-shift": ("qformat-accumulator", "src/repro_torch/kernels/mttkrp_fixed_kernel.py",
                          "value_frac + prec_shift, factor_bytes", "value_frac, factor_bytes"),
    "fixed-partials-shift": ("qformat-accumulator", "src/repro_torch/core/mttkrp.py",
                             "part = (part * qfactor_rows[m].to(torch.int32)) >> matrix_frac",
                             "part = part * qfactor_rows[m].to(torch.int32)"),
    "unguarded-int32": ("int32-index-width", "src/repro_torch/core/mttkrp.py",
                        "def dequantize_output(",
                        "def _narrow(keys):\n    perm = torch.argsort(keys)\n"
                        "    return perm.to(torch.int32)\n\n\ndef dequantize_output("),
    "alto-word-split": ("alto-key-width", "src/repro_torch/core/mttkrp.py",
                        "w = words[p // 32]", "w = words[p // 64]"),
    "imports-reference": ("import-orphans", "src/repro_torch/device.py",
                          "import torch\n", "import torch\n\nimport repro.core  # noqa: F401\n"),
    "byte-terms-arity": ("byte-terms-arity", "src/repro_torch/engine/calibrate.py",
                         "5 + len(backends)", "6 + len(backends)"),
    "schema-without-bump": ("schema-manifest", "src/repro_torch/engine/persist.py",
                            "    rank: int\n", "    rank: int\n    layout: str\n"),
    "host-sync-in-loop": ("host-sync", "src/repro_torch/core/cpals.py",
                          "                        mlast = m\n",
                          "                        mlast = m\n"
                          "                        lam_max = float(lam.max())\n"),
}


@pytest.fixture(scope="module")
def pristine(tmp_path_factory):
    return _copy_tree(tmp_path_factory.mktemp("pristine"))


def test_copied_tree_is_clean(pristine):
    res = run_analysis(pristine, strict=True)
    assert res.ok, [f.render() for f in res.findings]


@pytest.mark.parametrize("case", sorted(MUTATIONS))
def test_mutation_yields_one_finding(case, pristine, tmp_path, capsys):
    rule, rel, old, new = MUTATIONS[case]
    root = tmp_path / "tree"
    shutil.copytree(pristine, root)
    _edit(root, rel, old, new)
    res = run_analysis(root, strict=True)
    assert [f.rule for f in res.findings] == [rule], [f.render() for f in res.findings]
    assert cli_main(["--root", str(root), "--strict", "--rules", rule]) == 1
    assert f": {rule}: " in capsys.readouterr().out


def test_unreachable_module(pristine, tmp_path):
    root = tmp_path / "tree"
    shutil.copytree(pristine, root)
    (root / "src/repro_torch/core/orphan.py").write_text('"""Nobody imports me."""\n')
    res = run_analysis(root, strict=True)
    assert [(f.rule, f.path) for f in res.findings] == [
        ("import-orphans", "src/repro_torch/core/orphan.py")]


def test_backend_without_anchor(pristine, monkeypatch):
    spec = registry.get_backend("ref")
    monkeypatch.setitem(registry._REGISTRY, "nodoc", dataclasses.replace(spec, name="nodoc"))
    res = run_analysis(pristine, rules=["registry-docs"])
    assert [(f.rule, f.path) for f in res.findings] == [
        ("registry-docs", "docs/torch-candidates.md")]
    assert "'nodoc'" in res.findings[0].message


def test_removed_anchor(pristine, tmp_path):
    root = tmp_path / "tree"
    shutil.copytree(pristine, root)
    _edit(root, "docs/torch-candidates.md", '<a id="kernel"></a>', "")
    res = run_analysis(root, rules=["registry-docs"])
    assert len(res.findings) == 1 and "'kernel'" in res.findings[0].message


def test_schema_bump_plus_regen_is_clean(pristine, tmp_path):
    root = tmp_path / "tree"
    shutil.copytree(pristine, root)
    persist = "src/repro_torch/engine/persist.py"
    _edit(root, persist, "    rank: int\n", "    rank: int\n    layout: str\n")
    _edit(root, persist, "_SCHEMA_VERSION = 5", "_SCHEMA_VERSION = 6")
    res = run_analysis(root, rules=["schema-manifest"])
    assert res.findings and all(f.path.endswith("schema_manifest.json") for f in res.findings)
    assert regen_manifest(root)["schema_version"] == 6
    assert run_analysis(root, rules=["schema-manifest"]).ok


def test_contract_drift_and_regen(pristine, tmp_path):
    root = tmp_path / "tree"
    shutil.copytree(pristine, root)
    _edit(root, "src/repro_torch/kernels/ops.py", "def pad_factor(f: torch.Tensor, chunk: int)",
          "def pad_factor(f: torch.Tensor, chunk: int, value: float = 0.0)")
    res = run_analysis(root, rules=["kernel-contract-drift"])
    assert len(res.findings) == 1 and "pad_factor" in res.findings[0].message
    port_analysis.regen_contracts(root)
    assert run_analysis(root, rules=["kernel-contract-drift"]).ok
    assert load_contracts(root)["qformat"] == load_contracts(REPO)["qformat"]


# ---------------------------------------------------------------------------
# pins, live tree, catalog, CLI
# ---------------------------------------------------------------------------

def test_pins_equal_reference():
    port_schema = extract_schema((REPO / "src/repro_torch/engine/persist.py").read_text())
    ref_manifest = json.loads((REPO / "src/repro/analysis/schema_manifest.json").read_text())
    assert port_schema == ref_manifest
    assert json.loads((REPO / "src/repro_torch/analysis/schema_manifest.json").read_text()) \
        == port_schema
    ref_contracts = json.loads((REPO / "src/repro/analysis/kernel_contracts.json").read_text())
    port_contracts = load_contracts(REPO)
    assert port_contracts["qformat"] == ref_contracts["qformat"]
    # Every function that returns a tensor carries its shape contract; the two
    # that return none (a numpy permutation, a dict of tensors) are pinned by
    # signature only.
    no_tensor = {"src/repro_torch/core/baselines.py::alto_order",
                 "src/repro_torch/core/mttkrp.py::chunked_device_arrays"}
    for key, e in port_contracts["functions"].items():
        hand = [e["params"], e["returns"], e["index_adds"]]
        assert all(x is None for x in hand) if key in no_tensor else \
            all(x is not None for x in hand), key


def test_live_tree_is_clean_strict():
    res = run_analysis(REPO, strict=True)
    assert res.ok, "\n" + "\n".join(f.render() for f in res.findings)
    assert all(f.reason for f in res.suppressed)
    assert not any(f.path.startswith("src/repro/") for f in res.suppressed)


def test_registered_rules():
    rules = registered_rules()
    assert list(rules) == sorted(rules)
    assert set(rules) == {
        "alto-key-width", "byte-terms-arity", "dict-order-enumeration", "host-sync",
        "import-orphans", "int32-index-width", "kernel-contract-drift",
        "kernel-shape-contract", "nondeterminism",
        "qformat-accumulator", "registry-docs", "schema-manifest", "suppression-missing-reason",
        "syntax-error", "unknown-suppression", "unused-suppression"}
    shared = set(rules) & set(ref_analysis.registered_rules())
    assert shared == set(rules)
    assert all(rules[n].description and rules[n].rationale for n in rules)


def test_rule_catalog_doc_matches_rule_table():
    doc = (REPO / PORT_DOC).read_text(encoding="utf-8")
    assert rule_table() in doc
    anchors = extract_anchors(doc)
    refs = {frag for target, frag, _l in extract_anchor_refs(rule_table()) if target == PORT_DOC}
    assert refs == set(registered_rules()) and refs <= set(anchors)
    for name in ("retrace-control", "tracer-leak", "trace-in-jit", "pallas-blockspec",
                 "kernel-shape-contract"):
        assert name in doc


def test_cli_exit_codes_and_formats(capsys, tmp_path):
    assert cli_main(["--root", str(REPO), "--strict", "--format", "json"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["counts"]["active"] == 0 and report["strict"] is True
    assert report["counts"]["suppressed"] == len(report["suppressed"]) > 0
    assert cli_main(["--root", str(REPO), "--format", "sarif"]) == 0
    sarif = json.loads(capsys.readouterr().out)
    assert sarif["runs"][0]["tool"]["driver"]["name"] == "repro_torch.analysis"
    assert sarif["runs"][0]["results"] == []
    assert cli_main(["--root", str(REPO), "--list-rules"]) == 0
    out = capsys.readouterr().out
    assert all(f"`{name}`" in out for name in registered_rules())
    assert cli_main(["--root", str(REPO), "--rules", "no-such-rule"]) == 2
    assert cli_main(["--root", str(tmp_path)]) == 2
    assert cli_main(["--root", str(REPO), "--tier", "syntactic"]) == 0


def test_cli_baseline(pristine, tmp_path, capsys):
    root = tmp_path / "tree"
    shutil.copytree(pristine, root)
    _edit(root, *MUTATIONS["byte-terms-arity"][1:])
    baseline = tmp_path / "known.json"
    rules = ["--rules", "byte-terms-arity,alto-key-width"]
    assert cli_main(["--root", str(root), *rules, "--write-baseline", str(baseline)]) == 0
    assert len(json.loads(baseline.read_text())["findings"]) == 1
    assert cli_main(["--root", str(root), *rules, "--baseline", str(baseline)]) == 0
    _edit(root, *MUTATIONS["alto-word-split"][1:])
    capsys.readouterr()
    assert cli_main(["--root", str(root), *rules, "--baseline", str(baseline), "--json"]) == 1
    report = json.loads(capsys.readouterr().out)
    assert [f["rule"] for f in report["new_findings"]] == ["alto-key-width"]
    assert cli_main(["--root", str(root), *rules,
                     "--baseline", str(tmp_path / "missing.json")]) == 2
