"""Integer-width rules over the port (counterparts of
`repro.analysis.width_rules`): the places where a silently wrapped index
or accumulator loses.

The port has one deliberate width seam: host-side packing code
(`core/chunking.py`, `core/baselines.py`, `formats/*.py`) linearizes in
`np.int64`/`np.uint64`, while the CUDA kernels take int32 coordinates
(`kernels/mttkrp_kernel.py`, `kernels/tiles.py`) and the ALTO key words go
to the card as int32 views.  Each crossing is a narrowing cast whose safety
is an argument about reachable magnitudes; NumPy's `astype` and torch's
`.to(torch.int32)` both wrap silently.

  int32-index-width — dataflow over each function: names holding 64-bit
      signed values (int64 creation in numpy or torch, `.astype(np.int64)`,
      `.long()`, `np.argsort`/`torch.argsort`) are tracked through
      assignments, and every narrowing (`.astype(np.int32)`,
      `.to(torch.int32)`, `.int()`, `torch.tensor/as_tensor(...,
      dtype=torch.int32)`) of one is flagged unless the function visibly
      guards the magnitude (an `if`-gated `raise` naming the int32 limit).
  alto-key-width — the ALTO key-bit accounting is one invariant spread
      over `formats/alto.py` (pack, host decode, byte size) and
      `core/mttkrp.py::_alto_decode` (device decode): every word constant
      (`// 32`, `% 32`, the `0xFFFFFFFF` mask, 4 bytes per word) must agree.
  qformat-accumulator — re-derives the int32 accumulator bound of the fixed
      path from `core/qformat.py`'s preset table, cross-checks the values
      pinned in `kernel_contracts.json`, and checks the Alg.-2 shifts where
      they run: `core/mttkrp.py::_fixed_partials` (which
      `kernels/ref.py::mttkrp_fixed_local_ref` delegates to), the CUDA
      kernel `kernels/csrc/mttkrp_fixed.cu` (read as text), and its binding,
      which must pass `value_frac + prec_shift` as the kernel's `out_shift`.
"""
from __future__ import annotations

import ast
import re

from .engine import FileContext, ProjectContext, register_rule
from .shape_rules import _CONTRACTS as _CONTRACTS_FILE
from .shape_rules import load_contracts

__all__ = [
    "check_alto_key_width",
    "check_int32_index_width",
    "check_qformat_accumulator",
]

_WIDTH_TARGETS = ("src/repro_torch/core", "src/repro_torch/formats",
                  "src/repro_torch/kernels")


# ---------------------------------------------------------------------------
# int32-index-width
# ---------------------------------------------------------------------------

def _dotted(node: ast.AST) -> str | None:
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


_INT64_CREATORS = {"np.asarray", "np.array", "np.zeros", "np.empty",
                   "np.full", "np.arange", "torch.tensor", "torch.as_tensor",
                   "torch.zeros", "torch.empty", "torch.full", "torch.arange",
                   "torch.ones"}
_INT64_NAMES = ("np.int64", "torch.int64", "torch.long")
_INT32_NAMES = ("np.int32", "torch.int32", "torch.int")


def _mentions_int64(node: ast.AST) -> bool:
    return any(_dotted(n) in _INT64_NAMES for n in ast.walk(node))


def _mentions_int32(node: ast.AST) -> bool:
    return any(_dotted(n) in _INT32_NAMES for n in ast.walk(node))


def _dtype_kw(node: ast.Call) -> ast.AST | None:
    return next((k.value for k in node.keywords if k.arg == "dtype"), None)


def _is_wide_expr(node: ast.AST, wide: set[str]) -> bool:
    """Does this RHS *itself* produce a 64-bit signed value?  Deliberately
    shallow — a producer call, a tracked name, index/slice/arithmetic on
    one — so a value laundered through an untracked library call drops
    out of the analysis instead of producing speculative findings."""
    if isinstance(node, ast.Name):
        return node.id in wide
    if isinstance(node, ast.Subscript):
        return _is_wide_expr(node.value, wide)
    if isinstance(node, ast.BinOp):
        return (_is_wide_expr(node.left, wide)
                or _is_wide_expr(node.right, wide))
    if isinstance(node, ast.UnaryOp):
        return _is_wide_expr(node.operand, wide)
    if isinstance(node, ast.Call):
        fn = _dotted(node.func)
        if fn in ("np.argsort", "torch.argsort"):
            return True
        if fn == "torch.from_numpy" and node.args:
            return _is_wide_expr(node.args[0], wide)
        dt = _dtype_kw(node)
        if fn in _INT64_CREATORS and dt is not None and _mentions_int64(dt):
            return True
        if isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            if attr == "long":
                return True
            if attr in ("astype", "to") and any(_mentions_int64(a) for a in node.args):
                return True
    return False


def _wide_names(fn: ast.FunctionDef) -> set[str]:
    wide: set[str] = set()
    changed = True
    while changed:
        changed = False
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                continue
            name = node.targets[0].id
            if name not in wide and _is_wide_expr(node.value, wide):
                wide.add(name)
                changed = True
    return wide


_GUARD_RE = re.compile(r"iinfo\s*\(\s*(?:np|torch)\.int32\s*\)|2\s*\*\*\s*31"
                       r"|2147483647|1\s*<<\s*31")


def _has_int32_guard(fn: ast.FunctionDef, source: str) -> bool:
    """An `if`-gated `raise` whose test talks about the int32 limit — the
    shape of the chunking-grid guard.  Per-function: one guard vouches
    for every downcast after it in the same function."""
    for node in ast.walk(fn):
        if isinstance(node, ast.If) \
                and any(isinstance(n, ast.Raise) for n in ast.walk(node)):
            seg = ast.get_source_segment(source, node.test) or ""
            if _GUARD_RE.search(seg):
                return True
    return False


def _narrowing(node: ast.AST) -> tuple[str, ast.AST] | None:
    """(spelling, operand) when `node` narrows its operand to int32."""
    if not isinstance(node, ast.Call):
        return None
    if isinstance(node.func, ast.Attribute):
        attr = node.func.attr
        if attr == "int" and not node.args:
            return ".int()", node.func.value
        if attr in ("astype", "to") and (
                any(_mentions_int32(a) for a in node.args)
                or (_dtype_kw(node) is not None and _mentions_int32(_dtype_kw(node)))):
            spelling = ".astype(np.int32)" if attr == "astype" else ".to(torch.int32)"
            return spelling, node.func.value
    fn = _dotted(node.func)
    if fn in ("torch.tensor", "torch.as_tensor") and node.args \
            and _dtype_kw(node) is not None and _mentions_int32(_dtype_kw(node)):
        return f"{fn}(..., dtype=torch.int32)", node.args[0]
    return None


@register_rule(
    "int32-index-width",
    scope="file",
    tier="dataflow",
    packages=_WIDTH_TARGETS,
    description=("a 64-bit index value (int64 creation, .astype(np.int64), "
                 ".long(), argsort) narrowed to int32 (.astype(np.int32), "
                 ".to(torch.int32), .int(), torch.tensor/as_tensor with "
                 "dtype=torch.int32) in a function with no visible int32 "
                 "magnitude guard"),
    rationale=("host packing code linearizes in 64 bits while the CUDA "
               "kernels take int32 coordinates — numpy's astype and torch's "
               "casts wrap silently, so an unguarded narrowing turns a >2^31 "
               "extent into negative coordinates that scatter into wrong "
               "output rows with no error anywhere; an explicit if/raise "
               "naming the int32 limit is both the fix and what quiets the "
               "rule"),
    example=("chunking.py: `st.coords // cs.astype(np.int32)` where "
             "cs = np.asarray(chunk_shape, dtype=np.int64)"),
)
def check_int32_index_width(ctx: FileContext):
    for fn in ast.walk(ctx.tree):
        if not isinstance(fn, ast.FunctionDef):
            continue
        wide = _wide_names(fn)
        if not wide:
            continue
        guarded = _has_int32_guard(fn, ctx.source)
        for node in ast.walk(fn):
            hit = _narrowing(node)
            if hit is None:
                continue
            spelling, operand = hit
            names = sorted({n.id for n in ast.walk(operand)
                            if isinstance(n, ast.Name) and n.id in wide})
            if not names or guarded:
                continue
            yield ctx.finding(
                "int32-index-width", node,
                f"{fn.name} narrows 64-bit index value(s) "
                f"{', '.join(names)} with {spelling} and has no "
                "int32 magnitude guard — the cast wraps silently past 2^31; "
                "gate it with an if/raise naming the int32 limit "
                "(np.iinfo(np.int32) / torch.iinfo(torch.int32))")


# ---------------------------------------------------------------------------
# alto-key-width
# ---------------------------------------------------------------------------

_ALTO_FILE = "src/repro_torch/formats/alto.py"
_ALTO_DECODE_FILE = "src/repro_torch/core/mttkrp.py"
#: functions whose word-geometry constants must agree with the 32-bit pack
_ALTO_WORD_FNS = {
    _ALTO_FILE: ("build_alto", "alto_decode_mode"),
    _ALTO_DECODE_FILE: ("_alto_decode",),
}
_WORD_SUSPECTS = (8, 16, 64, 128)          # a //,% or shift by these ≠ 32
_MASK_SUSPECTS = {(1 << 8) - 1, (1 << 16) - 1, (1 << 64) - 1}


def _module_const(tree: ast.Module, name: str):
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == name \
                        and isinstance(node.value, ast.Constant):
                    return node.value.value
    return None


def _fn(tree: ast.Module, name: str) -> ast.FunctionDef | None:
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name == name:
            return node
    return None


@register_rule(
    "alto-key-width",
    scope="project",
    tier="dataflow",
    description=("ALTO key-bit accounting: MAX_KEY_BITS capacity raise in "
                 "build_alto, 32-bit word geometry (// 32, % 32, 32*w, "
                 "0xFFFFFFFF, 4 bytes/word) consistent across formats/alto.py "
                 "and core/mttkrp.py::_alto_decode"),
    rationale=("the packed key layout is one invariant implemented twice — "
               "host pack/decode in formats/alto.py, device decode of the "
               "int32 word views in core/mttkrp.py — plus a byte-size model "
               "the autotuner costs with; a partial edit decodes garbage "
               "coordinates with no runtime error"),
    example="_alto_decode splits words with p // 64 but alto.py packs 32-bit words",
)
def check_alto_key_width(ctx: ProjectContext):
    alto = ctx.file(_ALTO_FILE)
    if alto is None:
        yield ctx.finding("alto-key-width", _ALTO_FILE, 1,
                          "formats/alto.py is gone — update alto-key-width's "
                          "anchors if the format moved")
        return
    try:
        tree = alto.tree
    except SyntaxError:
        return                              # syntax-error meta rule owns it

    max_bits = _module_const(tree, "MAX_KEY_BITS")
    if max_bits is None:
        yield ctx.finding(
            "alto-key-width", _ALTO_FILE, 1,
            "MAX_KEY_BITS constant not found in formats/alto.py — the "
            "capacity raise and this rule both key off it")
    elif max_bits > 64:
        yield ctx.finding(
            "alto-key-width", _ALTO_FILE, 1,
            f"MAX_KEY_BITS={max_bits} exceeds 64, but the packed key is "
            "built in a np.uint64 before word-splitting — lifting the cap "
            "(BLCO) needs a multi-word build path first")

    build = _fn(tree, "build_alto")
    if build is None:
        yield ctx.finding("alto-key-width", _ALTO_FILE, 1,
                          "build_alto not found in formats/alto.py")
    else:
        has_guard = any(
            isinstance(n, ast.If)
            and any(isinstance(r, ast.Raise) for r in ast.walk(n))
            and any(isinstance(m, ast.Name) and m.id == "MAX_KEY_BITS"
                    for m in ast.walk(n.test))
            for n in ast.walk(build))
        if not has_guard:
            yield ctx.finding(
                "alto-key-width", _ALTO_FILE, build.lineno,
                "build_alto has no `raise` gated on MAX_KEY_BITS — tensors "
                "whose key exceeds the uint64 build word would pack "
                "truncated keys silently")

    for rel, names in _ALTO_WORD_FNS.items():
        fc = ctx.file(rel)
        if fc is None:
            continue
        try:
            ftree = fc.tree
        except SyntaxError:
            continue
        for name in names:
            fn = _fn(ftree, name)
            if fn is None:
                yield ctx.finding(
                    "alto-key-width", rel, 1,
                    f"{name} not found in {rel} — alto-key-width anchors "
                    "the word-geometry check there")
                continue
            for node in ast.walk(fn):
                if isinstance(node, ast.BinOp) \
                        and isinstance(node.op, (ast.FloorDiv, ast.Mod)) \
                        and isinstance(node.right, ast.Constant) \
                        and node.right.value in _WORD_SUSPECTS:
                    yield ctx.finding(
                        "alto-key-width", rel, node.lineno,
                        f"{name} splits key words by {node.right.value}, "
                        "but the pack geometry is 32-bit words — every "
                        "`// 32`/`% 32` site must change together")
                if isinstance(node, ast.Constant) \
                        and node.value in _MASK_SUSPECTS:
                    yield ctx.finding(
                        "alto-key-width", rel, node.lineno,
                        f"{name} masks with {node.value:#x}; the 32-bit "
                        "word mask is 0xFFFFFFFF")

    size_fn = _fn(tree, "alto_index_bytes")
    if size_fn is None:
        yield ctx.finding("alto-key-width", _ALTO_FILE, 1,
                          "alto_index_bytes not found in formats/alto.py")
    else:
        bad = [n for n in ast.walk(size_fn)
               if isinstance(n, ast.Constant) and n.value in (2, 8, 16)]
        has4 = any(isinstance(n, ast.Constant) and n.value == 4
                   for n in ast.walk(size_fn))
        if bad or not has4:
            yield ctx.finding(
                "alto-key-width", _ALTO_FILE, size_fn.lineno,
                "alto_index_bytes must cost 4 bytes per uint32 key word — "
                "the autotuner's footprint model reads this; it drifted "
                "from the 32-bit word geometry")


# ---------------------------------------------------------------------------
# qformat-accumulator
# ---------------------------------------------------------------------------

_QFORMAT_FILE = "src/repro_torch/core/qformat.py"
#: The Python function that holds the Alg.-2 shift discipline the overflow
#: derivation assumes: one `>> matrix_frac` per factor multiply, one
#: `>> (value_frac + prec_shift)` after the value multiply.
_SHIFT_FN = ("src/repro_torch/core/mttkrp.py", "_fixed_partials")
#: Plain versions that must run the Alg.-2 loop through `_SHIFT_FN`, passing
#: it the three shift amounts.
_DELEGATES = (("src/repro_torch/kernels/ref.py", "mttkrp_fixed_local_ref"),)
#: The CUDA kernel that runs on the card, and its binding.
_CUDA_FIXED = "src/repro_torch/kernels/csrc/mttkrp_fixed.cu"
_BINDING = ("src/repro_torch/kernels/mttkrp_fixed_kernel.py", "mttkrp_fixed_local")
_SHIFT_NAMES = ("matrix_frac", "value_frac", "prec_shift")


def _qformat_presets(tree: ast.Module) -> dict[str, tuple[int, int, int]]:
    """FIXED_PRESETS as {name: (int_bits, frac_bits, prec_shift)}, read
    straight off the AST (analysis never imports the runtime)."""
    qdefs: dict[str, tuple[int, int]] = {}
    presets: dict[str, tuple[int, int, int]] = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            name, v = node.targets[0].id, node.value
        elif isinstance(node, ast.AnnAssign) \
                and isinstance(node.target, ast.Name) \
                and node.value is not None:
            name, v = node.target.id, node.value
        else:
            continue
        if isinstance(v, ast.Call) and _dotted(v.func) == "QFormat" \
                and len(v.args) == 2 \
                and all(isinstance(a, ast.Constant) for a in v.args):
            qdefs[name] = (v.args[0].value, v.args[1].value)
        elif name == "FIXED_PRESETS" and isinstance(v, ast.Dict):
            for k, item in zip(v.keys, v.values):
                if not (isinstance(k, ast.Constant)
                        and isinstance(item, ast.Tuple)
                        and len(item.elts) == 2
                        and isinstance(item.elts[0], ast.Name)
                        and isinstance(item.elts[1], ast.Constant)):
                    continue
                q = qdefs.get(item.elts[0].id)
                if q is not None:
                    presets[k.value] = (q[0], q[1], item.elts[1].value)
    return presets


def _is_shift_by(node: ast.AST, match) -> bool:
    """A right shift (`>>`, torch.bitwise_right_shift) whose shift amount
    satisfies `match`."""
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.RShift):
        return match(node.right)
    if isinstance(node, ast.Call) and _dotted(node.func) in (
            "torch.bitwise_right_shift",) and len(node.args) == 2:
        return match(node.args[1])
    return False


def _names_in(node: ast.AST) -> set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _is_out_shift(node: ast.AST) -> bool:
    return (isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add)
            and _names_in(node) == {"value_frac", "prec_shift"})


def _find_fn(ctx: ProjectContext, rel: str, name: str):
    """(FunctionDef or None, finding message or None) for rel::name."""
    fc = ctx.file(rel)
    if fc is None:
        return None, None
    try:
        tree = fc.tree
    except SyntaxError:
        return None, None
    fn = next((n for n in ast.walk(tree)
               if isinstance(n, ast.FunctionDef) and n.name == name), None)
    if fn is None:
        return None, (f"{name} not found in {rel} — the Alg.-2 shift check "
                      "anchors there; update the rule if it moved")
    return fn, None


def _strip_c_comments(text: str) -> str:
    """C++ source with comments blanked out, newlines kept (so line
    numbers survive) — a shift named in a comment is not a shift."""
    def blank(m: re.Match) -> str:
        return re.sub(r"[^\n]", " ", m.group(0))
    return re.sub(r"/\*.*?\*/|//[^\n]*", blank, text, flags=re.DOTALL)


def _line_of(text: str, pos: int) -> int:
    return text.count("\n", 0, pos) + 1


def _cuda_shift_findings(ctx: ProjectContext):
    path = ctx.root / _CUDA_FIXED
    if not path.is_file():
        yield ctx.finding("qformat-accumulator", _CUDA_FIXED, 1,
                          "the fixed-point CUDA kernel is gone — update the "
                          "rule's anchors if it moved")
        return
    code = _strip_c_comments(path.read_text(encoding="utf-8"))
    for amount, why in (("matrix_frac", "per factor multiply (Alg. 2 l.11-12)"),
                        ("out_shift", "after the value multiply (Alg. 2 l.14-15)")):
        if not re.search(rf">>\s*{amount}\b", code):
            yield ctx.finding(
                "qformat-accumulator", _CUDA_FIXED, 1,
                f"the CUDA kernel has no right shift by {amount} {why} — "
                "without it the int32 bound (and accumulator_safe_nnz) no "
                "longer holds on the card")
    entry = re.search(r"int\s+prism_mttkrp_fixed_local\s*\(([^)]*)\)", code)
    if entry is None:
        yield ctx.finding(
            "qformat-accumulator", _CUDA_FIXED, 1,
            "the C entry prism_mttkrp_fixed_local is not found — the binding "
            "check pairs its `matrix_frac, out_shift` parameters with the "
            "arguments mttkrp_fixed_local passes")
    elif not re.search(r"int\s+matrix_frac\s*,\s*int\s+out_shift\b", entry.group(1)):
        yield ctx.finding(
            "qformat-accumulator", _CUDA_FIXED, _line_of(code, entry.start()),
            "the C entry no longer takes `int matrix_frac, int out_shift` in "
            "that order — the binding passes the shift amounts positionally")


def _binding_findings(ctx: ProjectContext):
    rel, name = _BINDING
    fn, missing = _find_fn(ctx, rel, name)
    if missing:
        yield ctx.finding("qformat-accumulator", rel, 1, missing)
    if fn is None:
        return
    for node in ast.walk(fn):
        # The C entry's trailing ints: the call arguments or tuple that hold
        # `matrix_frac` by position.
        args = node.args if isinstance(node, ast.Call) else \
            node.elts if isinstance(node, ast.Tuple) else []
        at = next((i for i, a in enumerate(args)
                   if isinstance(a, ast.Name) and a.id == "matrix_frac"), None)
        if at is None:
            continue
        if at + 1 < len(args) and _is_out_shift(args[at + 1]):
            return
        yield ctx.finding(
            "qformat-accumulator", rel, node.lineno,
            f"{name} passes `matrix_frac` to the C entry but not "
            "`value_frac + prec_shift` right after it as out_shift — the "
            "kernel would shift the value product by the wrong amount")
        return
    yield ctx.finding(
        "qformat-accumulator", rel, fn.lineno,
        f"{name} passes no `matrix_frac, value_frac + prec_shift` to the C "
        "entry — the kernel's shifts would not follow the preset")


@register_rule(
    "qformat-accumulator",
    scope="project",
    tier="dataflow",
    description=("fixed-point overflow bounds: factor products fit int32 "
                 "for every FIXED_PRESETS entry, the pinned "
                 "accumulator_safe_nnz values match a re-derivation from "
                 "the preset table, and the Alg.-2 renormalizing shifts "
                 "are present where the fixed inner loop runs: "
                 "_fixed_partials (and the plain versions that delegate to "
                 "it), the CUDA kernel mttkrp_fixed.cu, and its binding's "
                 "value_frac + prec_shift"),
    rationale=("device int32 arithmetic wraps without trapping, so a "
               "preset whose Q format breaks `2*frac+1 <= 31`, a pinned "
               "safe-nnz bound that no longer follows from the presets, or "
               "a dropped `>> matrix_frac` — in Python or in the C++ that "
               "actually runs on the card — corrupt results only on inputs "
               "big enough that nobody unit-tests them"),
    example=("the CUDA kernel has no right shift by matrix_frac per factor "
             "multiply (Alg. 2 l.11-12)"),
)
def check_qformat_accumulator(ctx: ProjectContext):
    fc = ctx.file(_QFORMAT_FILE)
    if fc is None:
        yield ctx.finding("qformat-accumulator", _QFORMAT_FILE, 1,
                          "core/qformat.py is gone — update the rule anchors")
        return
    try:
        tree = fc.tree
    except SyntaxError:
        return

    presets = _qformat_presets(tree)
    if not presets:
        yield ctx.finding(
            "qformat-accumulator", _QFORMAT_FILE, 1,
            "could not read FIXED_PRESETS / QFormat literals from "
            "core/qformat.py — the overflow derivation has nothing to "
            "check against")
        return

    contracts = load_contracts(ctx.root) or {}
    qpin = contracts.get("qformat") or {}
    value_frac = qpin.get("value_frac", 7)
    pinned = qpin.get("safe_nnz") or {}

    for name, (int_bits, frac, shift) in sorted(presets.items()):
        if int_bits + frac > 32:
            yield ctx.finding(
                "qformat-accumulator", _QFORMAT_FILE, 1,
                f"preset {name}: Q{int_bits}.{frac} needs "
                f"{int_bits + frac} storage bits (> 32)")
        if 2 * frac + 1 > 31:
            yield ctx.finding(
                "qformat-accumulator", _QFORMAT_FILE, 1,
                f"preset {name}: the product of two Q·.{frac} factor "
                f"values spans {2 * frac + 1} bits and overflows the "
                "int32 multiply Alg. 2 renormalizes (2*frac+1 must be "
                "<= 31)")
        if frac + 15 + 1 > 31:
            yield ctx.finding(
                "qformat-accumulator", _QFORMAT_FILE, 1,
                f"preset {name}: a Q·.{frac} partial times a 16-bit "
                "value spans more than 31 bits before the value shift")
        derived = (2**31 - 1) >> max(frac + 15 - value_frac - shift, 0)
        if name not in pinned:
            yield ctx.finding(
                "qformat-accumulator", _QFORMAT_FILE, 1,
                f"preset {name} has no pinned safe_nnz in "
                f"{_CONTRACTS_FILE} (derived bound: {derived}) — add it to "
                "the qformat block")
        elif pinned[name] != derived:
            yield ctx.finding(
                "qformat-accumulator", _QFORMAT_FILE, 1,
                f"pinned safe_nnz[{name}]={pinned[name]} but the preset "
                f"table derives {derived} — a preset changed; update the "
                f"qformat block in {_CONTRACTS_FILE} (and any callers "
                "sized by the old bound)")

    for stale in sorted(set(pinned) - set(presets)):
        yield ctx.finding(
            "qformat-accumulator", _QFORMAT_FILE, 1,
            f"pinned safe_nnz entry {stale!r} matches no FIXED_PRESETS "
            f"preset — drop it from {_CONTRACTS_FILE}")

    if not any(isinstance(n, ast.FunctionDef)
               and n.name == "accumulator_safe_nnz"
               for n in ast.walk(tree)):
        yield ctx.finding(
            "qformat-accumulator", _QFORMAT_FILE, 1,
            "accumulator_safe_nnz is missing from core/qformat.py — "
            "callers must be able to ask for the bound the analysis "
            "proves")

    rel, fname = _SHIFT_FN
    fn, missing = _find_fn(ctx, rel, fname)
    if missing:
        yield ctx.finding("qformat-accumulator", rel, 1, missing)
    if fn is not None:
        if not any(_is_shift_by(n, lambda a: isinstance(a, ast.Name)
                                and a.id == "matrix_frac")
                   for n in ast.walk(fn)):
            yield ctx.finding(
                "qformat-accumulator", rel, fn.lineno,
                f"{fname} has no right shift by matrix_frac — without the "
                "per-multiply renormalization the int32 product bound "
                "(and accumulator_safe_nnz) no longer holds")
        if not any(_is_shift_by(n, lambda a: {"value_frac", "prec_shift"}
                                <= _names_in(a))
                   for n in ast.walk(fn)):
            yield ctx.finding(
                "qformat-accumulator", rel, fn.lineno,
                f"{fname} has no right shift by value_frac + prec_shift — "
                "the accumulator magnitude derivation assumes it")

    for drel, dname in _DELEGATES:
        dfn, missing = _find_fn(ctx, drel, dname)
        if missing:
            yield ctx.finding("qformat-accumulator", drel, 1, missing)
        if dfn is None:
            continue
        delegates = any(
            isinstance(n, ast.Call) and _dotted(n.func) == fname
            and set(_SHIFT_NAMES) <= {a.id for a in n.args if isinstance(a, ast.Name)}
            for n in ast.walk(dfn))
        if not delegates:
            yield ctx.finding(
                "qformat-accumulator", drel, dfn.lineno,
                f"{dname} no longer runs the Alg.-2 loop through {fname}"
                f"(..., {', '.join(_SHIFT_NAMES)}) — a plain version with "
                "its own loop must carry both shifts, and this rule must "
                "check them there")

    yield from _cuda_shift_findings(ctx)
    yield from _binding_findings(ctx)
