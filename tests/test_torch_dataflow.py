"""The port's dataflow tier (`repro_torch.analysis.dataflow` and the
`kernel-shape-contract` rule) on the CPU: the symbolic dim algebra, torch's
dtype lattice against the live `torch.result_type`, the interpreter on
fixture snippets, the live tree, seeded mutations of a copied tree (each
caught at the mutated file and line), the symbolic returns against the JAX
package's interpreter on each function's counterpart, and the contracts
against the concrete shapes the port's functions return on small inputs."""
import ast
import itertools
import json
import math
import shutil
import textwrap

import numpy as np
import pytest
import torch

from repro.analysis import dataflow as ref_df
from repro.analysis import shape_rules as ref_sr
from repro.analysis.engine import ProjectContext as RefProjectContext
from repro_torch.analysis import dataflow as df
from repro_torch.analysis import shape_rules as sr
from repro_torch.analysis.engine import ProjectContext, default_root

REPO = default_root()
F32 = df.parse_dtype("float32")


def _src(snippet: str) -> str:
    return textwrap.dedent(snippet).lstrip("\n")


# ---------------------------------------------------------------------------
# Dim algebra (the cases of tests/test_dataflow.py)
# ---------------------------------------------------------------------------

def test_dim_ceil_pad_idiom_normalizes():
    rows, chunk = df.Dim.sym("I0"), df.Dim.sym("S0")
    padded = rows + ((-rows) % chunk)
    assert padded == df.Dim.atom(df.CeilMul(rows, chunk))
    assert padded.divisible_by(chunk)
    assert not rows.divisible_by(chunk)


def test_dim_negfloordiv_ceil_idiom():
    out, c = df.Dim.sym("I1"), df.Dim.sym("S1")
    padded = (-((-out) // c)) * c
    assert padded == df.Dim.atom(df.CeilMul(out, c))
    assert padded.divisible_by(c)


def test_dim_const_arithmetic_and_exact_div():
    d = df.Dim.const_(12) * df.Dim.sym("R")
    assert d.divisible_by(df.Dim.const_(4)) and d.divisible_by(df.Dim.sym("R"))
    t, s, r = df.Dim.sym("T"), df.Dim.sym("S0"), df.Dim.sym("R")
    assert df._try_exact_div(t * s * r, r) == t * s


def test_join_dims():
    base = df.Dim.sym("I0")
    padded = df.Dim.atom(df.CeilMul(base, df.Dim.sym("S0")))
    assert df.join_dims(base, padded) == df.join_dims(padded, base) == padded
    assert df.join_dims(base, base) == base
    assert df.join_dims(df.Dim.sym("A"), df.Dim.sym("B")) is None


@pytest.mark.parametrize(("a", "b"), itertools.product(["nnz", "T", "R", "I0"], repeat=2))
def test_join_dims_commutative_idempotent(a, b):
    da, db = df.Dim.sym(a) + 1, df.Dim.sym(b) + 3
    assert df.join_dims(da, da) == da
    assert df.join_dims(da, db) == df.join_dims(db, da)


# ---------------------------------------------------------------------------
# torch's dtype lattice
# ---------------------------------------------------------------------------

DTYPES = ["bool", "uint8", "int8", "int16", "int32", "int64", "float16", "bfloat16",
          "float32", "float64"]
SCALARS = {"bool": True, "int": 1, "float": 1.0}
SCALAR_DTYPES = {"bool": "bool", "int": "int64", "float": "float64"}
FORMS = {"tensor": df.TENSOR, "0-dim": df.ZERO_DIM, "scalar": df.SCALAR}


def _operand(name, form):
    if form == "scalar":
        return SCALARS[name], df.parse_dtype(SCALAR_DTYPES[name])
    shape = (2,) if form == "tensor" else ()
    return torch.zeros(shape, dtype=getattr(torch, name)), df.parse_dtype(name)


@pytest.mark.parametrize(("fa", "fb"), [p for p in itertools.product(FORMS, repeat=2)
                                        if p != ("scalar", "scalar")])
def test_promote_matches_torch_result_type(fa, fb):
    for a, b in itertools.product(SCALARS if fa == "scalar" else DTYPES,
                                  SCALARS if fb == "scalar" else DTYPES):
        (xa, da), (xb, dbt) = _operand(a, fa), _operand(b, fb)
        got = df.promote(da, dbt, FORMS[fa], FORMS[fb])
        assert f"torch.{got}" == str(torch.result_type(xa, xb)), (fa, a, fb, b)


def test_promote_types_commutative_idempotent():
    for a, b in itertools.product(DTYPES, repeat=2):
        da, dbt = df.parse_dtype(a), df.parse_dtype(b)
        assert df.promote_types(da, da) == da
        assert df.promote_types(da, dbt) == df.promote_types(dbt, da)
        assert str(df.promote_types(da, dbt)) == str(
            torch.promote_types(getattr(torch, a), getattr(torch, b))).removeprefix("torch.")


# ---------------------------------------------------------------------------
# The interpreter on fixture snippets
# ---------------------------------------------------------------------------

def _interpret(source, fname, args, kwargs=None):
    program = df.Program({"src/repro_torch/core/snippet.py": _src(source)})
    module = program.module("src/repro_torch/core/snippet.py")
    interp = df.Interpreter(program)
    result = interp.call_function(module.functions[fname], module, list(args), kwargs or {})
    return result, interp


def _arr(*dims, dtype="float32"):
    return df.AArray(tuple(df.Dim.of(d) for d in dims), df.parse_dtype(dtype))


MATMUL = """
    import torch

    def f(a, b):
        return torch.matmul(a, b)

    def g(a, b):
        return a @ b
"""


@pytest.mark.parametrize("fname", ["f", "g"])
def test_interpreter_flags_matmul_contraction_mismatch(fname):
    _, interp = _interpret(MATMUL, fname, [_arr("P", "S0"), _arr("S1", "R")])
    assert any("contraction" in p.message for p in interp.problems), interp.problems
    out, interp = _interpret(MATMUL, fname, [_arr("B", "P", "S0"), _arr("S0", "R")])
    assert not interp.problems
    assert out.shape == _arr("B", "P", "R").shape and out.dtype == F32


def test_interpreter_flags_broadcast_mismatch():
    src = """
        def f(a, b):
            return a * b
    """
    _, interp = _interpret(src, "f", [_arr("T", "P"), _arr("T", "R")])
    assert any("broadcast" in p.message and p.line == 2 for p in interp.problems)


def test_interpreter_quiet_on_unknowns():
    src = """
        def f(a):
            b = some_unknown_library_call(a)
            return b * a + a.some_method().other
    """
    _, interp = _interpret(src, "f", [_arr("T")])
    assert not interp.problems


def test_interpreter_applies_torch_promotion():
    src = """
        import torch

        def f(i32, i16, f64_0d):
            return i32 * 2.5, i16 + 1, i32 + f64_0d, i32 / 2, i16 >> 3, torch.where(i16 > 0, i16, 7)
    """
    out, interp = _interpret(src, "f", [_arr("T", dtype="int32"), _arr("T", dtype="int16"),
                                        _arr(dtype="float64")])
    assert not interp.problems
    assert [str(v.dtype) for v in out.items] == ["float32", "int16", "float64", "float32",
                                                 "int16", "int16"]


def test_interpreter_flags_narrow_integer_product():
    src = """
        import torch

        def f(a, b):
            wide = a * b.to(torch.int32)
            return a * b
    """
    _, interp = _interpret(src, "f", [_arr("T", dtype="int16"), _arr("T", dtype="int16")])
    assert [(p.line, "int16 × int16" in p.message) for p in interp.problems] == [(5, True)]


def test_interpreter_index_add_record():
    src = """
        import torch

        def f(src, idx, n):
            out = torch.zeros((n + 1, src.shape[-1]), dtype=src.dtype)
            out.index_add_(0, idx, src)
            return out[:n]
    """
    out, interp = _interpret(src, "f", [_arr("nnz", "R"), _arr("nnz", dtype="int32"),
                                        df.AInt(df.Dim.sym("F"))])
    assert not interp.problems
    assert out.shape == (df.Dim.sym("F"), df.Dim.sym("R")) and out.dtype == F32
    (rec,) = interp.index_adds
    assert (rec.line, rec.dim, rec.target_origin) == (5, 0, ("src/repro_torch/core/snippet.py", 4))
    assert rec.target_shape == (df.Dim.sym("F") + 1, df.Dim.sym("R"))
    assert rec.index_shape == (df.Dim.sym("nnz"),)
    _, bad = _interpret(src, "f", [_arr("nnz", "R"), _arr("P", dtype="int32"),
                                   df.AInt(df.Dim.sym("F"))])
    assert [p.message for p in bad.problems] == [
        "index_add_ source has nnz rows along dim 0 but the index has P"]
    _, bad = _interpret(src.replace("dtype=src.dtype", "dtype=torch.float32"), "f",
                        [_arr("nnz", "R", dtype="int32"), _arr("nnz", dtype="int32"),
                         df.AInt(df.Dim.sym("F"))])
    assert len(bad.problems) == 1 and "torch raises" in bad.problems[0].message


# ---------------------------------------------------------------------------
# The live tree and seeded mutations of a copy
# ---------------------------------------------------------------------------

def test_live_tree_contracts_clean():
    ctx = ProjectContext(REPO)
    assert sr.contract_report(ctx)["shape"] == set()
    assert list(sr.check_kernel_shape_contract(ctx)) == []
    assert list(sr.check_kernel_contract_drift(ctx)) == []


def test_regen_contracts_keeps_every_byte(tmp_path):
    shutil.copytree(REPO / "src" / "repro_torch", tmp_path / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = (tmp_path / sr._CONTRACTS).read_text()
    sr.regen_contracts(tmp_path)
    assert (tmp_path / sr._CONTRACTS).read_text() == before
    contracts = json.loads(before)
    contracts["functions"]["src/repro_torch/kernels/ref.py::vanished_fn"] = {
        "params": None, "returns": None, "index_adds": None, "signature": None}
    (tmp_path / sr._CONTRACTS).write_text(json.dumps(contracts))
    out = sr.regen_contracts(tmp_path)
    assert "src/repro_torch/kernels/ref.py::vanished_fn" not in out["functions"]
    assert out["functions"] == json.loads(before)["functions"]


MUTATIONS = {
    "index-add-target-resized": (
        "src/repro_torch/core/mttkrp.py",
        "out = torch.zeros((n_rows + 1, src.shape[-1])", "out = torch.zeros((n_rows, src.shape[-1])",
        "adds into a target"),
    "trim-dropped": (
        "src/repro_torch/kernels/ops.py", "    return out[:out_dim]", "    return out",
        "return dim 0 is ceil("),
    "int32-cast-dropped": (
        "src/repro_torch/core/mttkrp.py",
        "part = (part * qfactor_rows[m].to(torch.int32)) >> matrix_frac",
        "part = (part * qfactor_rows[m]) >> matrix_frac", "int16 × int16"),
    "return-shape-changed": (
        "src/repro_torch/core/mttkrp.py",
        "return index_add_drop(out_dim, coords[:, mode], part)\n\n\ndef chunked",
        "return index_add_drop(out_dim, coords[:, mode], part).T\n\n\ndef chunked",
        "mttkrp_coo return dim 0 is R"),
}


@pytest.mark.parametrize("case", sorted(MUTATIONS))
def test_mutation_is_caught_at_its_line(case, tmp_path):
    rel, old, new, words = MUTATIONS[case]
    shutil.copytree(REPO / "src" / "repro_torch", tmp_path / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = tmp_path / rel
    text = path.read_text(encoding="utf-8")
    assert old in text, f"{rel} no longer holds {old!r}"
    path.write_text(text.replace(old, new, 1), encoding="utf-8")
    line = text[: text.index(old)].count("\n") + 1
    findings = sr.contract_report(ProjectContext(tmp_path))["shape"]
    assert findings and all((r, n) == (rel, line) for r, n, _m in findings), sorted(findings)
    assert any(words in m for _r, _n, m in findings), sorted(findings)


# ---------------------------------------------------------------------------
# Against the JAX package's interpreter, function by function
# ---------------------------------------------------------------------------

#: port function → its counterpart in the JAX package.  `ops.pad_factor` is
#: left out: the reference also pads the rank to 128 lanes, the port does not.
#: So are the kernel wrappers: they add into the op's (I_pad, R) output, and
#: the TPU kernels' (T, S_mode, R) partials are the plain versions' (`ref.py`).
COUNTERPARTS = {
    "src/repro_torch/core/mttkrp.py::mttkrp_coo": "src/repro/core/mttkrp.py::mttkrp_coo",
    "src/repro_torch/core/mttkrp.py::mttkrp_coo_fixed": "src/repro/core/mttkrp.py::mttkrp_coo_fixed",
    "src/repro_torch/core/mttkrp.py::mttkrp_chunked": "src/repro/core/mttkrp.py::mttkrp_chunked",
    "src/repro_torch/core/mttkrp.py::mttkrp_chunked_fixed":
        "src/repro/core/mttkrp.py::mttkrp_chunked_fixed",
    "src/repro_torch/core/mttkrp.py::mttkrp_csf": "src/repro/core/mttkrp.py::mttkrp_csf",
    "src/repro_torch/core/mttkrp.py::mttkrp_alto": "src/repro/core/mttkrp.py::mttkrp_alto",
    "src/repro_torch/core/mttkrp.py::gather_factor_blocks":
        "src/repro/core/mttkrp.py::gather_factor_blocks",
    "src/repro_torch/kernels/ops.py::mttkrp_kernel_op": "src/repro/kernels/ops.py::mttkrp_pallas",
    "src/repro_torch/kernels/ops.py::mttkrp_fixed_kernel_op":
        "src/repro/kernels/ops.py::mttkrp_fixed_pallas",
    "src/repro_torch/kernels/ref.py::mttkrp_local_ref": "src/repro/kernels/ref.py::mttkrp_local_ref",
    "src/repro_torch/kernels/ref.py::mttkrp_fixed_local_ref":
        "src/repro/kernels/ref.py::mttkrp_fixed_local_ref",
    "src/repro_torch/kernels/ref.py::reduce_local": "src/repro/kernels/ref.py::reduce_local",
}


@pytest.fixture(scope="module")
def reference():
    ctx = RefProjectContext(REPO)
    report = ref_sr.contract_report(ctx)
    program = ref_df.Program({fc.rel: fc.source for fc in ctx.walk("src/repro")})
    return report, program, ref_sr.load_contracts(REPO)


@pytest.mark.parametrize(("ndim", "mode"), sr.CONTRACT_CASES)
def test_symbolic_returns_equal_the_reference(reference, ndim, mode):
    ref_report, program, ref_contracts = reference
    assert ref_report["shape"] == set() and ref_report["pallas"] == set()
    port = sr.contract_report(ProjectContext(REPO))["returns"]
    port_contracts = sr.load_contracts(REPO)["functions"]
    for key, ref_key in COUNTERPARTS.items():
        entry = ref_contracts["functions"][ref_key]
        assert port_contracts[key]["returns"] == entry["returns"], key
        rel, _, name = ref_key.partition("::")
        module = program.module(rel)
        args, kwargs = ref_sr._instantiate(entry["params"], entry["signature"]["args"],
                                           entry["signature"]["kwonly"], ndim, mode)
        want = ref_df.Interpreter(program).call_function(module.functions[name], module, args,
                                                         kwargs)
        got = port[(key, ndim, mode)]
        assert [str(d) for d in got.shape] == [str(d) for d in want.shape], key
        assert str(got.dtype) == str(want.dtype), key


# ---------------------------------------------------------------------------
# The contracts against concrete shapes on the CPU
# ---------------------------------------------------------------------------

def _value(d: df.Dim, env: dict) -> int:
    total = d.const
    for mono, c in d.terms:
        total += c * math.prod(_atom_value(a, env) for a in mono)
    return total


def _atom_value(a, env: dict) -> int:
    if isinstance(a, df.Sym):
        return env[a.name]
    base = _value(a.base, env)
    if isinstance(a, df.CeilMul):
        return -(-base // _value(a.mult, env)) * _value(a.mult, env)
    if isinstance(a, df.CeilDiv):
        return -(-base // _value(a.div, env))
    return (-base) % _value(a.mod, env)


def _concrete(spec, ndim, mode, env, rng):
    kind = spec["kind"]
    dtype = getattr(torch, spec.get("dtype", "float32"))

    def tensor(shape):
        if dtype.is_floating_point:
            return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
        return torch.from_numpy(rng.integers(0, 3, shape)).to(dtype)
    if kind in ("factors", "factors-padded"):
        rows = [env[f"I{m}"] if kind == "factors" else
                -(-env[f"I{m}"] // env[f"S{m}"]) * env[f"S{m}"] for m in range(ndim)]
        return [tensor((r, env["R"])) for r in rows]
    if kind == "array":
        return tensor(tuple(_value(sr._parse_dim(t, ndim, mode), env) for t in spec["shape"]))
    if kind == "dims":
        return tuple(env[f"S{m}"] for m in range(ndim))
    if kind in ("out-dim", "dim"):
        return _value(sr._parse_dim(spec.get("sym", "dim[mode]"), ndim, mode), env)
    got = sr._build_param(spec, ndim, mode)
    return got.value


@pytest.mark.parametrize(("ndim", "mode"), sr.CONTRACT_CASES)
def test_contracts_give_the_concrete_shapes(ndim, mode):
    env = {"nnz": 7, "T": 3, "P": 5, "R": 4, "F": 3, "B": 2,
           **{f"I{m}": 9 + m for m in range(ndim)}, **{f"S{m}": 4 + m for m in range(ndim)}}
    rng = np.random.default_rng(ndim * 10 + mode)
    checked = 0
    for key, entry in sr.load_contracts(REPO)["functions"].items():
        if entry["params"] is None:
            continue
        rel, _, name = key.partition("::")
        module = __import__(rel[len("src/"):-len(".py")].replace("/", "."), fromlist=[name])
        sig = entry["signature"]
        args = [_concrete(entry["params"][a], ndim, mode, env, rng)
                for a in sig["args"] if a in entry["params"]]
        kwargs = {a: _concrete(entry["params"][a], ndim, mode, env, rng)
                  for a in sig["kwonly"] if a in entry["params"]}
        out = getattr(module, name)(*args, **kwargs)
        want = tuple(_value(sr._parse_dim(t, ndim, mode), env) for t in entry["returns"]["shape"])
        assert tuple(out.shape) == want, key
        assert out.dtype == getattr(torch, entry["returns"]["dtype"]), key
        checked += 1
    assert checked == 23


def test_contract_module_list_is_pinned():
    contracts = sr.load_contracts(REPO)
    assert contracts["modules"] == list(sr.CONTRACT_MODULES)
    for rel in sr.CONTRACT_MODULES:
        tree = ast.parse((REPO / rel).read_text())
        assert any(isinstance(n, ast.FunctionDef) for n in tree.body), rel
