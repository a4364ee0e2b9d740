"""Kernel contracts: dataflow rules over `kernels/` + `core/mttkrp.py`
(counterpart of `repro.analysis.shape_rules`).

The public MTTKRP surface has one contract the whole stack leans on —
every variant returns `(dims[mode], rank)`, every per-task local
`(T, S[mode], R)` — plus agreements no runtime test states explicitly:
each `index_add_` target has the rows its scatter needs (the spare row
`index_add_drop` drops out-of-range rows into included), the Alg.-2
products are int32, and torch's promotion leaves the pinned dtype.

These rules pin that contract in `kernel_contracts.json` (mirroring
`schema_manifest.json`) and prove it per function with the `dataflow.py`
abstract interpreter, instantiating each pinned function over a small case
grid of (ndim, mode) so mode-rotation bugs (the `chunk_shape[m]` vs
`chunk_shape[mode]` class) can't hide behind a symmetric case:

  kernel-contract-drift — the pinned signatures vs the live ASTs: a
      renamed kwarg, a new positional arg or a vanished function fails
      until `--regen-contracts` re-pins it (making API drift a reviewed
      diff, like the persist schema).
  kernel-shape-contract — interpreter-derived return shape/dtype vs the
      pinned contract, broadcast/contraction/index mismatches and narrow
      integer products found inside the bodies, and the `index_add_` calls
      against the pinned target rows.  A wrong return is reported at the
      return statement that produced it, a wrong target at the line that
      allocated it.

A kernel wrapper's CPU branch returns `out` with the plain version's summed
partials added and its CUDA branch the `out` the kernel added into; the
interpreter follows both and checks each return.  The reference's
`pallas-blockspec` has no counterpart (the port has no BlockSpecs;
`kernels/tiles.py::plan_launch` checks each launch plan at run time).
"""
from __future__ import annotations

import ast
import json
import re
from pathlib import Path

from . import dataflow as df
from .engine import ProjectContext, register_rule

__all__ = [
    "CONTRACT_CASES",
    "CONTRACT_MODULES",
    "check_kernel_contract_drift",
    "check_kernel_shape_contract",
    "contract_report",
    "extract_signature",
    "load_contracts",
    "regen_contracts",
]

_CONTRACTS = "src/repro_torch/analysis/kernel_contracts.json"

#: The modules whose `__all__` functions the contract file pins.
CONTRACT_MODULES = (
    "src/repro_torch/core/mttkrp.py",
    "src/repro_torch/core/baselines.py",
    "src/repro_torch/kernels/ops.py",
    "src/repro_torch/kernels/mttkrp_kernel.py",
    "src/repro_torch/kernels/mttkrp_fixed_kernel.py",
    "src/repro_torch/kernels/ref.py",
    "src/repro_torch/kernels/gram_pinv.py",
    "src/repro_torch/kernels/sum_squares.py",
)

#: (ndim, mode) instantiations every contracted function is proven over.
#: 3-mode covers every mode role (output / inner / mid); the 4-mode case
#: exercises the extra mid-factor multiply in the fixed Alg.-2 chain.
CONTRACT_CASES = ((3, 0), (3, 1), (3, 2), (4, 1))

#: Hand-written fields of a contract entry, kept by `--regen-contracts`.
_HAND_FIELDS = ("params", "returns", "index_adds")


def extract_signature(fndef: ast.FunctionDef) -> dict:
    """Static signature fingerprint: arg names/order, kw-only set, which
    params carry defaults and the vararg — everything a caller can observe
    without running the function."""
    a = fndef.args
    return {
        "args": [p.arg for p in a.posonlyargs + a.args],
        "vararg": a.vararg.arg if a.vararg else None,
        "kwonly": [p.arg for p in a.kwonlyargs],
        "defaults": len(a.defaults),
        "kw_defaults": [p.arg for p, d in zip(a.kwonlyargs, a.kw_defaults)
                        if d is not None],
    }


def _module_all(tree: ast.Module) -> list[str]:
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "__all__":
                    try:
                        return [str(n) for n in ast.literal_eval(node.value)]
                    except ValueError:
                        return []
    return []


def _module_functions(tree: ast.Module) -> dict[str, ast.FunctionDef]:
    return {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}


def load_contracts(root: Path) -> dict | None:
    """The pinned contracts, or None when missing/unparseable (the drift
    rule reports that; the shape rule just goes quiet)."""
    p = Path(root) / _CONTRACTS
    if not p.is_file():
        return None
    try:
        data = json.loads(p.read_text(encoding="utf-8"))
    except json.JSONDecodeError:
        return None
    return data if isinstance(data, dict) else None


def regen_contracts(root: Path) -> dict:
    """Re-pin the signature blocks from the live ASTs, keeping the
    hand-written shape contracts (params, returns, index_adds) of surviving
    functions and dropping entries for vanished ones — the intentional-drift
    workflow: change the API, run `python -m repro_torch.analysis
    --regen-contracts`, review + commit the JSON diff (new functions arrive
    with `"params": null`, signature-pinned only, until someone writes their
    shape contract)."""
    root = Path(root)
    data = load_contracts(root) or {}
    old = data.get("functions", {})
    functions: dict[str, dict] = {}
    for rel in CONTRACT_MODULES:
        p = root / rel
        if not p.is_file():
            continue
        tree = ast.parse(p.read_text(encoding="utf-8"))
        defs = _module_functions(tree)
        for name in _module_all(tree):
            fndef = defs.get(name)
            if fndef is None:
                continue
            key = f"{rel}::{name}"
            entry = dict(old.get(key) or dict.fromkeys(_HAND_FIELDS))
            entry["signature"] = extract_signature(fndef)
            functions[key] = entry
    out = {
        "modules": list(CONTRACT_MODULES),
        "functions": {k: functions[k] for k in sorted(functions)},
    }
    if "qformat" in data:
        out["qformat"] = data["qformat"]
    (root / _CONTRACTS).write_text(
        json.dumps(out, indent=2) + "\n", encoding="utf-8")
    return out


# ---------------------------------------------------------------------------
# Contract instantiation
# ---------------------------------------------------------------------------

_CEIL_RE = re.compile(r"^ceil\((.+),\s*(.+)\)$")


def _split_top(text: str, sep: str) -> list[str]:
    """`text` split at `sep` outside parentheses and brackets."""
    parts, depth, cur = [], 0, ""
    for ch in text:
        depth += ch in "(["
        depth -= ch in ")]"
        if ch == sep and depth == 0:
            parts.append(cur)
            cur = ""
        else:
            cur += ch
    return [*parts, cur]


def _parse_dim(token, ndim: int, mode: int) -> df.Dim:
    """The contract shape grammar: ints, `N` (tensor order), `dim[mode]` /
    `S[mode]` (mode-indexed tensor extent / chunk size), `ceil(a,b)` (least
    multiple of b ≥ a — the padding algebra), a named symbol from the
    per-case table (nnz, T, P, R, F, B, I0.., S0..), and sums and products
    of those (`T*S[mode]+1`)."""
    if isinstance(token, int):
        return df.Dim.const_(int(token))
    token = token.strip()
    terms = _split_top(token, "+")
    if len(terms) > 1:
        out = df.Dim.const_(0)
        for t in terms:
            out = out + _parse_dim(t, ndim, mode)
        return out
    factors = _split_top(token, "*")
    if len(factors) > 1:
        out = df.Dim.const_(1)
        for f in factors:
            out = out * _parse_dim(f, ndim, mode)
        return out
    if token == "N":
        return df.Dim.const_(ndim)
    if token == "dim[mode]":
        return df.Dim.sym(f"I{mode}")
    if token == "S[mode]":
        return df.Dim.sym(f"S{mode}")
    m = _CEIL_RE.match(token)
    if m:
        return df.Dim.atom(df.CeilMul(_parse_dim(m.group(1), ndim, mode),
                                      _parse_dim(m.group(2), ndim, mode)))
    if token.isdigit():
        return df.Dim.const_(int(token))
    return df.Dim.sym(token)


def _dtype(name: str) -> df.DType:
    dt = df.parse_dtype(name)
    if dt is None:
        raise ValueError(f"unknown dtype {name!r} in kernel contract")
    return dt


def _alto_case_positions(ndim: int) -> tuple[tuple[int, ...], ...]:
    # Mode-major round-robin with 5 bits per mode (shape 32^ndim): every
    # position < 32, so the contract case packs into one key word.
    bits = 5
    return tuple(tuple(m + b * ndim for b in range(bits)) for m in range(ndim))


def _build_param(spec: dict, ndim: int, mode: int) -> df.AVal:
    kind = spec["kind"]
    if kind in ("factors", "factors-padded"):
        dt = _dtype(spec.get("dtype", "float32"))

        def rows(m):
            i = df.Dim.sym(f"I{m}")
            return i if kind == "factors" else df.Dim.atom(df.CeilMul(i, df.Dim.sym(f"S{m}")))
        return df.ATuple([df.AArray((rows(m), df.Dim.sym("R")), dt) for m in range(ndim)])
    if kind == "array":
        dt = _dtype(spec.get("dtype", "float32"))
        return df.AArray(tuple(_parse_dim(t, ndim, mode) for t in spec["shape"]), dt)
    if kind == "mode":
        return df.AConst(mode)
    if kind == "out-dim":
        return df.AInt(df.Dim.sym(f"I{mode}"))
    if kind == "dims":
        return df.ATuple([df.AInt(df.Dim.sym(f"S{m}")) for m in range(ndim)])
    if kind == "dim":
        return df.AInt(_parse_dim(spec["sym"], ndim, mode))
    if kind == "const":
        return df.AConst(spec["value"])
    if kind == "inner-mode":
        return df.AConst(ndim - 1 if mode != ndim - 1 else 0)
    if kind == "mid-modes":
        inner = ndim - 1 if mode != ndim - 1 else 0
        return df.AConst(tuple(m for m in range(ndim) if m not in (mode, inner)))
    if kind == "alto-positions":
        return df.AConst(_alto_case_positions(ndim))
    raise ValueError(f"unknown contract param kind {kind!r}")


def _instantiate(params: dict, sig: dict, ndim: int, mode: int) -> tuple[list, dict]:
    args: list[df.AVal] = []
    for name in sig.get("args", []):
        if name not in params:
            break
        args.append(_build_param(params[name], ndim, mode))
    kwargs = {name: _build_param(params[name], ndim, mode)
              for name in sig.get("kwonly", []) if name in params}
    return args, kwargs


# ---------------------------------------------------------------------------
# The shared interpretation pass (computed once per ProjectContext)
# ---------------------------------------------------------------------------

def contract_report(ctx: ProjectContext) -> dict:
    """Interpret every contracted function over the case grid; cache on the
    context.  Returns {"shape": {(rel, line, message), ...}, deduplicated
    (symmetric cases produce identical messages), and "returns": {(key,
    ndim, mode): the symbolic value the caller sees}}."""
    cached = getattr(ctx, "_kernel_contract_report", None)
    if cached is not None:
        return cached
    shape: set[tuple] = set()
    returns: dict[tuple, df.AVal] = {}
    report = {"shape": shape, "returns": returns}
    contracts = load_contracts(ctx.root)
    if contracts is None:
        ctx._kernel_contract_report = report   # the drift rule reports the why
        return report

    program = df.Program({fc.rel: fc.source for fc in ctx.walk("src/repro_torch")})
    for key, entry in contracts.get("functions", {}).items():
        params = entry.get("params")
        if params is None:
            continue
        rel, _, name = key.partition("::")
        module = program.module(rel)
        fndef = module.functions.get(name) if module else None
        sig = entry.get("signature") or {}
        if fndef is None or not sig:
            continue                           # the drift rule owns these
        for ndim, mode in CONTRACT_CASES:
            interp = df.Interpreter(program)
            try:
                args, kwargs = _instantiate(params, sig, ndim, mode)
                returns[(key, ndim, mode)] = interp.call_function(fndef, module, args, kwargs)
            except (ValueError, RecursionError):
                continue
            for p in interp.problems:
                shape.add((p.rel or rel, p.line, p.message))
            _check_returns(entry, interp.returns, rel, fndef, ndim, mode, shape)
            _check_index_adds(entry, interp.index_adds, rel, fndef, ndim, mode, shape)

    ctx._kernel_contract_report = report
    return report


def _check_returns(entry: dict, results: list, rel: str, fndef: ast.FunctionDef,
                   ndim: int, mode: int, out: set) -> None:
    """Each return statement's value against the pinned shape and dtype,
    reported where the value last left a function: the innermost return it
    passed through, or this function's own."""
    ret = entry.get("returns")
    if ret is None:
        return
    expected = tuple(_parse_dim(t, ndim, mode) for t in ret["shape"])
    want_dt = _dtype(ret["dtype"])
    for result, line in results:
        where = (result.via[-1][0], result.via[-1][2]) \
            if isinstance(result, df.AArray) and result.via else (rel, line)
        if isinstance(result, df.AUnknown):
            continue                            # quiet on ignorance
        if not isinstance(result, df.AArray):
            out.add((*where, f"{fndef.name} is contracted to return a tensor but the "
                             f"interpreter derives {type(result).__name__}"))
            continue
        if len(result.shape) != len(expected):
            out.add((*where, f"{fndef.name} returns rank {len(result.shape)} "
                             f"({_fmt(result.shape)}) but the contract pins rank "
                             f"{len(expected)} ({_fmt(expected)})"))
            continue
        for i, (got, want) in enumerate(zip(result.shape, expected, strict=True)):
            if not (got.has_opaque or want.has_opaque) and got != want:
                out.add((*where, f"{fndef.name} return dim {i} is {got} but the contract "
                                 f"pins {want}"))
        if result.dtype != want_dt:
            out.add((*where, f"{fndef.name} returns dtype {result.dtype} but the contract "
                             f"pins {want_dt}"))


def _check_index_adds(entry: dict, calls: list, rel: str, fndef: ast.FunctionDef,
                      ndim: int, mode: int, out: set) -> None:
    """The `index_add_` calls, in interpretation order, against the pinned
    target rows; a wrong target is reported where it was allocated."""
    specs = entry.get("index_adds")
    if specs is None:
        return
    if len(calls) != len(specs):
        out.add((rel, fndef.lineno,
                 f"{fndef.name} is contracted to make {len(specs)} index_add_ call(s); the "
                 f"interpreter observed {len(calls)}"))
        return
    for i, (call, spec) in enumerate(zip(calls, specs, strict=True)):
        want = _parse_dim(spec["rows"], ndim, mode)
        got = call.target_shape[call.dim] if call.dim is not None else None
        if got is None or got.has_opaque or got == want:
            continue
        where = call.target_origin or (call.rel or rel, call.line)
        out.add((*where, f"index_add_ call #{i} (line {call.line}) adds into a target of "
                         f"{got} rows; the contract pins {want}"))


def _fmt(shape: tuple) -> str:
    return "(" + ", ".join(str(d) for d in shape) + ")"


@register_rule(
    "kernel-contract-drift",
    scope="project",
    tier="dataflow",
    description=("public kernel signatures must match the pinned "
                 "analysis/kernel_contracts.json; drift without "
                 "--regen-contracts fails"),
    rationale=("every engine backend and chip_smoke.py call this surface "
               "by keyword; a silent rename breaks callers with no test "
               "naming the contract — pinning makes API drift a reviewed "
               "JSON diff, exactly like the persist schema manifest"),
    example=("signature of mttkrp_chunked drifted from the pinned "
             "contract — run --regen-contracts"),
)
def check_kernel_contract_drift(ctx: ProjectContext):
    contracts = load_contracts(ctx.root)
    if contracts is None:
        yield ctx.finding(
            "kernel-contract-drift", _CONTRACTS, 1,
            "kernel_contracts.json is missing or unparseable — run "
            "`python -m repro_torch.analysis --regen-contracts` and commit it")
        return
    pinned = contracts.get("functions", {})
    if list(contracts.get("modules", [])) != list(CONTRACT_MODULES):
        yield ctx.finding(
            "kernel-contract-drift", _CONTRACTS, 1,
            "pinned module list differs from shape_rules.CONTRACT_MODULES "
            "— run --regen-contracts")
    live: set[str] = set()
    for rel in CONTRACT_MODULES:
        fc = ctx.file(rel)
        if fc is None:
            yield ctx.finding(
                "kernel-contract-drift", _CONTRACTS, 1,
                f"contracted module {rel} is gone — update "
                "CONTRACT_MODULES and --regen-contracts")
            continue
        try:
            tree = fc.tree
        except SyntaxError:
            continue                            # syntax-error meta rule owns it
        defs = _module_functions(tree)
        for name in _module_all(tree):
            fndef = defs.get(name)
            if fndef is None:
                continue
            key = f"{rel}::{name}"
            live.add(key)
            entry = pinned.get(key)
            if entry is None:
                yield ctx.finding(
                    "kernel-contract-drift", rel, fndef.lineno,
                    f"public function {name} has no entry in "
                    "kernel_contracts.json — run --regen-contracts")
                continue
            if entry.get("signature") != extract_signature(fndef):
                yield ctx.finding(
                    "kernel-contract-drift", rel, fndef.lineno,
                    f"signature of {name} drifted from the pinned contract "
                    "— run --regen-contracts (and review the JSON diff)")
    for key in sorted(set(pinned) - live):
        yield ctx.finding(
            "kernel-contract-drift", _CONTRACTS, 1,
            f"pinned entry {key} matches no live public function — run "
            "--regen-contracts to drop it")


@register_rule(
    "kernel-shape-contract",
    scope="project",
    tier="dataflow",
    description=("abstract interpretation proves every contracted kernel function "
                 "returns its pinned shape and dtype — (dims[mode], rank) for the "
                 "public MTTKRP variants, (T, S[mode], R) for the locals — and makes "
                 "exactly the pinned index_add_ calls into targets of the pinned rows"),
    rationale=("the MTTKRP variants are interchangeable backends — the autotuner "
               "swaps them per mode, so a shape or dtype deviation, a scatter target "
               "one row short (index_add_drop's spare row) or an int16 product that "
               "wraps in ONE variant corrupts results only for the workloads that pick "
               "it; symbolic interpretation over the (ndim, mode) case grid proves the "
               "contract without running a kernel"),
    example=("index_add_ call #0 (line 46) adds into a target of I0 rows; the "
             "contract pins I0+1"),
)
def check_kernel_shape_contract(ctx: ProjectContext):
    for rel, line, message in sorted(contract_report(ctx)["shape"]):
        yield ctx.finding("kernel-shape-contract", rel, line, message)
