"""Symbolic shape/dtype abstract interpretation over the port's torch code
(counterpart of `repro.analysis.dataflow`).

The syntactic rules see one AST node at a time; a shape mismatch between
the MTTKRP variants, a dtype that torch's promotion changes, or an
`index_add_` target of the wrong size needs dataflow: what shape and dtype
does this expression have, given symbolic input shapes?  This module is
that layer:

  * a **dtype lattice** (`DType`, `promote_types`, `promote`) matching
    `torch.result_type`: categories bool < integer < floating; dimensioned
    tensors over 0-dim tensors over Python scalars (a lower-priority operand
    only decides the type when its category is higher: a 0-dim tensor then
    gives its own dtype, a Python scalar the default dtype of its category,
    int64 or float32);
  * a **symbolic dim algebra** (`Dim`) over named sizes (`nnz`, `T`, `P`,
    `R`, per-mode `I_m`/`S_m`) with the affine structure the padding idioms
    need — `rows + (-rows) % chunk` and `-(-n // c) * c` both normalize to
    "least multiple of `c` ≥ n" (`CeilMul`);
  * an **abstract interpreter** (`Interpreter`) over function ASTs:
    flow-sensitive statements with branch joins, concrete loop unrolling,
    cross-module call following, models of the torch ops the port's MTTKRP
    variants use (the creation ops, `arange`, `where`, `gather`, `F.pad`,
    `matmul`, `index_select`, `index_add_` — each call recorded —,
    `reshape`/`view`/`expand`, casts, slicing, shifts and elementwise
    arithmetic), and of the kernel wrappers' CUDA branch: a ctypes entry
    returns an opaque int, and the wrapper returns the `out` it was given.

`shape_rules.py` drives this against the contracts pinned in
`kernel_contracts.json`.  The interpreter is quiet on ignorance: anything it
does not model evaluates to Unknown and produces no finding — only positive
evidence of a mismatch is reported.
"""
from __future__ import annotations

import ast
import dataclasses
import itertools

__all__ = [
    "AArray",
    "AConst",
    "ADType",
    "AInt",
    "ATuple",
    "AUnknown",
    "CeilDiv",
    "CeilMul",
    "DType",
    "Dim",
    "IndexAdd",
    "Interpreter",
    "ModNeg",
    "ModuleEnv",
    "Opaque",
    "Problem",
    "Program",
    "SCALAR",
    "Sym",
    "TENSOR",
    "UNKNOWN",
    "ZERO_DIM",
    "join_dims",
    "parse_dtype",
    "promote",
    "promote_types",
]


# ---------------------------------------------------------------------------
# DType lattice (torch.result_type)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DType:
    """One torch dtype of the lattice."""

    kind: str            # "bool" | "uint" | "int" | "float" | "bfloat"
    bits: int

    def __str__(self) -> str:
        if self.kind == "bool":
            return "bool"
        if self.kind == "bfloat":
            return "bfloat16"
        return f"{self.kind}{self.bits}"

    @property
    def category(self) -> int:
        """bool 0 < integer 1 < floating 2: the order torch promotes by."""
        return {"bool": 0, "uint": 1, "int": 1}.get(self.kind, 2)


_DTYPE_NAMES = {
    "bool": DType("bool", 8), "uint8": DType("uint", 8),
    "int8": DType("int", 8), "int16": DType("int", 16), "short": DType("int", 16),
    "int32": DType("int", 32), "int": DType("int", 32),
    "int64": DType("int", 64), "long": DType("int", 64),
    "float16": DType("float", 16), "half": DType("float", 16),
    "bfloat16": DType("bfloat", 16),
    "float32": DType("float", 32), "float": DType("float", 32),
    "float64": DType("float", 64), "double": DType("float", 64),
}

#: Operand priorities of `torch.result_type`: a dimensioned tensor, a 0-dim
#: tensor, a Python scalar.
TENSOR, ZERO_DIM, SCALAR = 2, 1, 0

_BOOL, _INT32, _INT64 = DType("bool", 8), DType("int", 32), DType("int", 64)
_F32, _F64 = DType("float", 32), DType("float", 64)
#: torch's default dtype of each category (int64, and float32 from
#: `torch.get_default_dtype()`), taken by a Python scalar that outranks the
#: tensors' category.
_DEFAULT = {0: _BOOL, 1: _INT64, 2: _F32}


def parse_dtype(name: str) -> DType | None:
    return _DTYPE_NAMES.get(name)


def promote_types(a: DType, b: DType) -> DType:
    """`torch.promote_types(a, b)`."""
    if a == b:
        return a
    if a.category != b.category:
        return a if a.category > b.category else b
    if a.category == 2:
        if {a.kind, b.kind} == {"float", "bfloat"} and max(a.bits, b.bits) == 16:
            return _F32                         # float16 with bfloat16
        return a if a.bits > b.bits else b if b.bits > a.bits else (
            a if a.kind == "float" else b)
    if a.kind == b.kind:
        return a if a.bits >= b.bits else b
    i, u = (a, b) if a.kind == "int" else (b, a)
    return i if i.bits > u.bits else DType("int", 2 * u.bits)


def promote(a: DType, b: DType, pa: int = TENSOR, pb: int = TENSOR) -> DType:
    """`torch.result_type` of two operands with dtypes `a`, `b` and
    priorities `pa`, `pb` (TENSOR, ZERO_DIM or SCALAR).  A Python scalar's
    dtype stands for its type: bool, int64 for int, float64 for float."""
    if pa == pb:
        return promote_types(a, b)
    hi, lo, plo = (a, b, pb) if pa > pb else (b, a, pa)
    if lo.category <= hi.category:
        return hi
    return _DEFAULT[lo.category] if plo == SCALAR else lo


def _is_int(dt: DType) -> bool:
    return dt.kind in ("int", "uint")


# ---------------------------------------------------------------------------
# Symbolic dims
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Sym:
    """A named size: `nnz`, `T`, `R`, `I0`, `S1`, ..."""

    name: str

    def __str__(self) -> str:
        return self.name


@dataclasses.dataclass(frozen=True)
class CeilDiv:
    """ceil(base / div) — `-(-n // c)`."""

    base: "Dim"
    div: "Dim"

    def __str__(self) -> str:
        return f"ceildiv({self.base},{self.div})"


@dataclasses.dataclass(frozen=True)
class CeilMul:
    """Least multiple of `mult` that is ≥ `base` — the padded extent."""

    base: "Dim"
    mult: "Dim"

    def __str__(self) -> str:
        return f"ceil({self.base},{self.mult})"


@dataclasses.dataclass(frozen=True)
class ModNeg:
    """(-base) % mod — the `rpad = (-rows) % chunk` padding amount."""

    base: "Dim"
    mod: "Dim"

    def __str__(self) -> str:
        return f"padto({self.base},{self.mod})"


_OPAQUE_COUNTER = itertools.count()


@dataclasses.dataclass(frozen=True)
class Opaque:
    """A size the algebra cannot express; fresh per creation, equal only
    to itself — two unknowns must never compare equal."""

    tag: str
    uid: int

    def __str__(self) -> str:
        return f"?{self.tag}"


def _fresh(tag: str = "dim") -> Dim:
    return Dim.atom(Opaque(tag, next(_OPAQUE_COUNTER)))


def _akey(a) -> tuple:
    return (type(a).__name__, str(a), getattr(a, "uid", 0))


class Dim:
    """A symbolic nonnegative integer: `const + Σ coeff·mono` where each
    mono is a sorted product of atoms.  Hashable/structural equality."""

    __slots__ = ("terms", "const")

    def __init__(self, terms: dict | tuple = (), const: int = 0):
        if isinstance(terms, dict):
            items = {m: c for m, c in terms.items() if c != 0}
            self.terms = tuple(sorted(
                items.items(), key=lambda mc: tuple(_akey(a) for a in mc[0])))
        else:
            self.terms = tuple(terms)
        self.const = const

    @staticmethod
    def const_(n: int) -> Dim:
        return Dim((), int(n))

    @staticmethod
    def sym(name: str) -> Dim:
        return Dim({(Sym(name),): 1})

    @staticmethod
    def atom(a) -> Dim:
        return Dim({(a,): 1})

    @staticmethod
    def of(x) -> Dim:
        if isinstance(x, Dim):
            return x
        if isinstance(x, bool):
            return Dim.const_(int(x))
        if isinstance(x, int):
            return Dim.const_(x)
        if isinstance(x, str):
            return Dim.sym(x)
        return Dim.atom(x)

    def __eq__(self, other) -> bool:
        return (isinstance(other, Dim) and self.terms == other.terms
                and self.const == other.const)

    def __hash__(self) -> int:
        return hash((self.terms, self.const))

    def __repr__(self) -> str:
        return f"Dim({self})"

    def __str__(self) -> str:
        parts = []
        for mono, c in self.terms:
            m = "*".join(str(a) for a in mono)
            parts.append(m if c == 1 else f"{c}*{m}")
        if self.const or not parts:
            parts.append(str(self.const))
        return "+".join(parts)

    @property
    def is_const(self) -> bool:
        return not self.terms

    @property
    def has_opaque(self) -> bool:
        return any(isinstance(a, Opaque) for mono, _ in self.terms for a in mono)

    def __add__(self, other) -> Dim:
        other = Dim.of(other)
        terms = dict(self.terms)
        for m, c in other.terms:
            terms[m] = terms.get(m, 0) + c
        return _recognize_ceil(Dim(terms, self.const + other.const))

    __radd__ = __add__

    def __neg__(self) -> Dim:
        return Dim({m: -c for m, c in self.terms}, -self.const)

    def __sub__(self, other) -> Dim:
        return self + (-Dim.of(other))

    def __rsub__(self, other) -> Dim:
        return Dim.of(other) + (-self)

    def __mul__(self, other) -> Dim:
        other = Dim.of(other)
        terms: dict = {}
        const = self.const * other.const
        for m, c in self.terms:
            terms[m] = terms.get(m, 0) + c * other.const
        for m, c in other.terms:
            terms[m] = terms.get(m, 0) + c * self.const
        for (m1, c1), (m2, c2) in itertools.product(self.terms, other.terms):
            mono = _mul_monos(m1, m2)
            terms[mono] = terms.get(mono, 0) + c1 * c2
        return Dim(terms, const)

    __rmul__ = __mul__

    def __floordiv__(self, other) -> Dim:
        other = Dim.of(other)
        exact = _try_exact_div(self, other)
        if exact is not None:
            return exact
        neg = -self
        if all(c > 0 for _, c in neg.terms) and neg.const >= 0 and neg.terms:
            # (-x) // d == -ceil(x / d) for d > 0 — the `-(-n // c)`
            # ceil idiom's inner half.
            return -Dim.atom(CeilDiv(neg, other))
        return _fresh("floordiv")

    def __mod__(self, other) -> Dim:
        other = Dim.of(other)
        if self.divisible_by(other):
            return Dim.const_(0)
        neg = -self
        if all(c > 0 for _, c in neg.terms) and neg.const >= 0 and neg.terms:
            return Dim.atom(ModNeg(neg, other))
        return _fresh("mod")

    def divisible_by(self, other) -> bool:
        """Provably divisible (False means "cannot prove", not "no")."""
        other = Dim.of(other)
        if other == Dim.const_(1) or self == other:
            return True
        if other.is_const and other.const > 0:
            k = other.const
            return (self.const % k == 0
                    and all(c % k == 0 or _mono_divisible(m, other) for m, c in self.terms))
        if other.const == 0 and len(other.terms) == 1:
            return self.const == 0 and all(_mono_divisible(m, other) for m, _ in self.terms)
        return False


def _mul_monos(m1: tuple, m2: tuple) -> tuple:
    # ceildiv(b, d) * d  →  ceil(b, d): the outer half of `-(-n//c)*c`.
    for a, b in ((m1, m2), (m2, m1)):
        if len(a) == 1 and isinstance(a[0], CeilDiv) and Dim({b: 1}) == a[0].div:
            return (CeilMul(a[0].base, a[0].div),)
    return tuple(sorted(m1 + m2, key=_akey))


def _mono_divisible(mono: tuple, d: Dim) -> bool:
    """Does some atom of `mono` guarantee divisibility by `d`?"""
    for a in mono:
        if Dim({(a,): 1}) == d:
            return True
        if isinstance(a, CeilMul) and (a.mult == d or a.mult.divisible_by(d)):
            return True
    return False


def _try_exact_div(dim: Dim, d: Dim) -> Dim | None:
    if d == Dim.const_(1):
        return dim
    if d.is_const and d.const > 0:
        k = d.const
        if dim.const % k == 0 and all(c % k == 0 for _, c in dim.terms):
            return Dim({m: c // k for m, c in dim.terms}, dim.const // k)
        return None
    if d.const == 0 and len(d.terms) == 1 and d.terms[0][1] == 1:
        datoms = d.terms[0][0]
        if dim.const != 0:
            return None
        out: dict = {}
        for mono, c in dim.terms:
            rest = list(mono)
            for a in datoms:
                if a in rest:
                    rest.remove(a)
                else:
                    for x in rest:
                        # ceil(b, m) / m == ceildiv(b, m)
                        if isinstance(x, CeilMul) and Dim({(a,): 1}) == x.mult:
                            rest.remove(x)
                            rest.append(CeilDiv(x.base, x.mult))
                            break
                    else:
                        return None
            mono2 = tuple(sorted(rest, key=_akey))
            if not mono2:
                return None if c != 1 and out else Dim.const_(c)
            out[mono2] = out.get(mono2, 0) + c
        return Dim(out, 0)
    return None


def _recognize_ceil(dim: Dim) -> Dim:
    """`x + (-x) % b` → ceil-multiple of b — the `pad_factor` idiom."""
    for mono, c in dim.terms:
        if c == 1 and len(mono) == 1 and isinstance(mono[0], ModNeg):
            mn = mono[0]
            rest = Dim({m: k for m, k in dim.terms if m != mono}, dim.const)
            if rest == mn.base:
                return Dim.atom(CeilMul(mn.base, mn.mod))
    return dim


def join_dims(a: Dim, b: Dim) -> Dim | None:
    """Join of two branch values; None = no common refinement.

    `x ⊔ ceil(x, b) = ceil(x, b)` is sound here because the unpadded branch
    is only taken when x is already a multiple of b (that is what
    `if rpad:` tests), so both branches are multiples of b."""
    if a == b:
        return a
    for x, y in ((a, b), (b, a)):
        if (len(x.terms) == 1 and x.const == 0 and x.terms[0][1] == 1
                and len(x.terms[0][0]) == 1
                and isinstance(x.terms[0][0][0], CeilMul)
                and x.terms[0][0][0].base == y):
            return x
    return None


# ---------------------------------------------------------------------------
# Abstract values
# ---------------------------------------------------------------------------

class AVal:
    """Base of the abstract-value hierarchy."""


@dataclasses.dataclass
class AUnknown(AVal):
    def __repr__(self) -> str:
        return "Unknown"


UNKNOWN = AUnknown()


@dataclasses.dataclass
class AConst(AVal):
    """A concrete Python value (int, float, str, bool, None, tuple of such)."""

    value: object


@dataclasses.dataclass
class AInt(AVal):
    """A symbolic Python integer (sizes, offsets)."""

    dim: Dim


@dataclasses.dataclass
class AArray(AVal):
    """A torch tensor: symbolic shape + lattice dtype.  `origin` is the
    (file, line) of the call that allocated it, where known; `via` the
    (file, line) of each return statement it has passed through, innermost
    first — where a wrong result is reported."""

    shape: tuple
    dtype: DType
    origin: tuple = dataclasses.field(default=(), compare=False)
    via: tuple = dataclasses.field(default=(), compare=False)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def priority(self) -> int:
        return TENSOR if self.shape else ZERO_DIM


@dataclasses.dataclass
class ATuple(AVal):
    items: list
    mutable: bool = False


@dataclasses.dataclass
class ADType(AVal):
    dtype: DType


@dataclasses.dataclass
class AFunc(AVal):
    """A known callable by canonical dotted name (`torch.zeros`,
    `F.pad`, `builtin.len`) or `file::function` for a modeled function of
    the port."""

    name: str


@dataclasses.dataclass
class AClosure(AVal):
    """A function of the interpreted sources (nested ones see the module's
    names, not their enclosing function's)."""

    node: ast.FunctionDef
    name: str
    module: object        # ModuleEnv it was defined in


@dataclasses.dataclass
class AModule(AVal):
    module: object        # ModuleEnv


@dataclasses.dataclass
class ABound(AVal):
    """A method bound to an abstract receiver (`x.to`, `out.index_add_`,
    `rows.append`)."""

    base: AVal
    attr: str


@dataclasses.dataclass
class IndexAdd:
    """One recorded `Tensor.index_add_` call: the target's shape and where
    it was allocated, the index and source shapes (the counterpart of the
    reference's `segment_sum` record; torch has no `indices_are_sorted`)."""

    line: int
    target_shape: tuple
    dim: int | None
    index_shape: tuple
    source_shape: tuple
    target_origin: tuple = ()
    rel: str = ""         # repo-relative file the call lives in


@dataclasses.dataclass
class Problem:
    """One positive finding from interpretation."""

    line: int
    message: str
    rel: str = ""         # repo-relative file the defect lives in


def as_dim(v: AVal) -> Dim | None:
    if isinstance(v, AInt):
        return v.dim
    if isinstance(v, AConst) and isinstance(v.value, int) and not isinstance(v.value, bool):
        return Dim.const_(v.value)
    return None


def _shape_str(shape: tuple) -> str:
    return "(" + ", ".join(str(d) for d in shape) + ")"


def _prod(shape) -> Dim:
    total = Dim.const_(1)
    for d in shape:
        total = total * d
    return total


# ---------------------------------------------------------------------------
# Modules / import resolution
# ---------------------------------------------------------------------------

#: leading dotted paths → canonical short prefix used in the primitive table
_CANON_PREFIXES = [
    ("torch.nn.functional", "F"),
    ("torch", "torch"),
    ("numpy", "np"),
    ("ctypes", "ctypes"),
    ("math", "math"),
]


def _canon(dotted: str) -> str:
    for prefix, short in _CANON_PREFIXES:
        if dotted == prefix or dotted.startswith(prefix + "."):
            return short + dotted[len(prefix):]
    return dotted


class ModuleEnv:
    """Import aliases + top-level defs of one source file, resolved lazily
    so interpreting one function never parses the world."""

    def __init__(self, rel: str, tree: ast.Module, program: Program):
        self.rel = rel
        self.program = program
        self.functions: dict[str, ast.FunctionDef] = {}
        self.aliases: dict[str, str] = {}          # name -> external dotted
        self.internal: dict[str, tuple[str, str | None]] = {}
        self.constants: dict[str, AVal] = {}
        for node in tree.body:
            if isinstance(node, ast.FunctionDef):
                self.functions[node.name] = node
            elif isinstance(node, ast.Import):
                for alias in node.names:
                    self.aliases[alias.asname or alias.name.split(".")[0]] = (
                        alias.name if alias.asname else alias.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom):
                self._import_from(node)
            elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and isinstance(node.value, ast.Constant):
                self.constants[node.targets[0].id] = AConst(node.value.value)

    def _import_from(self, node: ast.ImportFrom) -> None:
        if node.level == 0:
            for alias in node.names:
                self.aliases[alias.asname or alias.name] = (
                    f"{node.module}.{alias.name}" if node.module else alias.name)
            return
        parts = self.rel.split("/")[:-1]
        parts = parts[: len(parts) - (node.level - 1)]
        if node.module:
            parts = parts + node.module.split(".")
        base = "/".join(parts)
        for alias in node.names:
            # `from . import ref` → sibling module; `from .m import f` →
            # member of module file m.py (or package __init__.py)
            key = alias.asname or alias.name
            if self.program.has_module(f"{base}/{alias.name}.py"):
                self.internal[key] = (f"{base}/{alias.name}.py", None)
            elif self.program.has_module(f"{base}.py"):
                self.internal[key] = (f"{base}.py", alias.name)
            elif self.program.has_module(f"{base}/__init__.py"):
                self.internal[key] = (f"{base}/__init__.py", alias.name)

    def resolve(self, name: str) -> AVal | None:
        if name in self.functions:
            key = f"{self.rel}::{name}"
            if key in _PRIMITIVES:
                return AFunc(key)
            return AClosure(self.functions[name], name, self)
        if name in self.constants:
            return self.constants[name]
        if name in self.aliases:
            return AFunc(_canon(self.aliases[name]))
        if name in self.internal:
            rel, member = self.internal[name]
            target = self.program.module(rel)
            if target is None:
                return UNKNOWN
            if member is None:
                return AModule(target)
            return target.resolve(member) or UNKNOWN
        return None


class Program:
    """A set of parseable source files (repo-relative path → source)."""

    def __init__(self, sources: dict[str, str]):
        self._sources = sources
        self._modules: dict[str, ModuleEnv | None] = {}

    def has_module(self, rel: str) -> bool:
        return rel in self._sources

    def module(self, rel: str) -> ModuleEnv | None:
        if rel not in self._modules:
            src = self._sources.get(rel)
            if src is None:
                self._modules[rel] = None
            else:
                try:
                    self._modules[rel] = ModuleEnv(rel, ast.parse(src), self)
                except SyntaxError:
                    self._modules[rel] = None
        return self._modules[rel]


# ---------------------------------------------------------------------------
# Interpreter
# ---------------------------------------------------------------------------

_NORMAL, _RETURN, _RAISE, _BREAK, _CONTINUE = range(5)

_BUILTINS = {"range", "len", "enumerate", "zip", "reversed", "tuple", "list",
             "sum", "max", "min", "int", "abs", "isinstance", "print", "sorted"}

_MAX_STEPS = 200_000


class Interpreter:
    """Abstract interpreter for one function call.  Produces a return
    value, the `Problem`s found on the way, the `IndexAdd` call records and
    the outermost call's returns, each with its line."""

    def __init__(self, program: Program, max_depth: int = 10):
        self.program = program
        self.problems: list[Problem] = []
        self.index_adds: list[IndexAdd] = []
        self.returns: list[tuple[AVal, int]] = []
        self.max_depth = max_depth
        self._depth = 0
        self._steps = 0
        self._rel_stack: list[str] = []

    @property
    def current_rel(self) -> str:
        return self._rel_stack[-1] if self._rel_stack else ""

    # -- entry -------------------------------------------------------------
    def call_function(self, fndef: ast.FunctionDef, module: ModuleEnv,
                      args: list, kwargs: dict) -> AVal:
        env = self._bind(fndef, module, args, dict(kwargs))
        self._depth += 1
        self._rel_stack.append(module.rel)
        try:
            if self._depth > self.max_depth:
                return UNKNOWN
            returns: list[tuple[AVal, int]] = []
            self._exec_block(fndef.body, env, module, returns)
            if self._depth == 1:
                self.returns = list(returns)
            if not returns:
                return AConst(None)
            site = (module.rel, fndef.name)
            vals = [dataclasses.replace(v, via=(*v.via, (*site, line)))
                    if isinstance(v, AArray) else v for v, line in returns]
            out = vals[0]
            for r in vals[1:]:
                out = self._join(out, r)
            return out
        finally:
            self._rel_stack.pop()
            self._depth -= 1

    def problem(self, node, message: str) -> None:
        line = node if isinstance(node, int) else getattr(node, "lineno", 0)
        self.problems.append(Problem(line, message, rel=self.current_rel))

    def _bind(self, fndef, module: ModuleEnv, args: list, kwargs: dict) -> dict:
        a = fndef.args
        env: dict[str, AVal] = {}
        names = [p.arg for p in a.posonlyargs + a.args]
        for i, name in enumerate(names):
            if i < len(args):
                env[name] = args[i]
            elif name in kwargs:
                env[name] = kwargs.pop(name)
        if a.vararg is not None:
            env[a.vararg.arg] = ATuple(list(args[len(names):]))
        for i, d in enumerate(a.defaults):
            name = names[len(names) - len(a.defaults) + i]
            if name not in env:
                env[name] = self._eval(d, dict(env), module)
        for p, d in zip(a.kwonlyargs, a.kw_defaults, strict=True):
            if p.arg in kwargs:
                env[p.arg] = kwargs.pop(p.arg)
            elif d is not None:
                env[p.arg] = self._eval(d, dict(env), module)
        for name in names:
            env.setdefault(name, UNKNOWN)
        for p in a.kwonlyargs:
            env.setdefault(p.arg, UNKNOWN)
        return env

    # -- statements --------------------------------------------------------
    def _exec_block(self, stmts, env, module, returns) -> int:
        for stmt in stmts:
            flow = self._exec(stmt, env, module, returns)
            if flow != _NORMAL:
                return flow
        return _NORMAL

    def _exec(self, stmt, env, module, returns) -> int:
        self._steps += 1
        if self._steps > _MAX_STEPS:
            return _RETURN                      # runaway guard: give up quietly
        if isinstance(stmt, ast.Return):
            val = self._eval(stmt.value, env, module) if stmt.value is not None else AConst(None)
            returns.append((val, stmt.lineno))
            return _RETURN
        if isinstance(stmt, ast.Raise):
            return _RAISE
        if isinstance(stmt, ast.Break):
            return _BREAK
        if isinstance(stmt, ast.Continue):
            return _CONTINUE
        if isinstance(stmt, ast.FunctionDef):
            env[stmt.name] = AClosure(stmt, stmt.name, module)
            return _NORMAL
        if isinstance(stmt, ast.Expr):
            self._eval(stmt.value, env, module)
            return _NORMAL
        if isinstance(stmt, ast.Assign):
            val = self._eval(stmt.value, env, module)
            for t in stmt.targets:
                self._assign(t, val, env, module)
            return _NORMAL
        if isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None:
                self._assign(stmt.target, self._eval(stmt.value, env, module), env, module)
            return _NORMAL
        if isinstance(stmt, ast.AugAssign):
            cur = self._eval(stmt.target, env, module)
            val = self._eval(stmt.value, env, module)
            self._assign(stmt.target, self._binop(cur, stmt.op, val, stmt), env, module)
            return _NORMAL
        if isinstance(stmt, ast.If):
            return self._exec_if(stmt, env, module, returns)
        if isinstance(stmt, ast.For):
            return self._exec_for(stmt, env, module, returns)
        if isinstance(stmt, ast.While):
            self._havoc(stmt, env)
            return _NORMAL
        if isinstance(stmt, ast.With):
            return self._exec_block(stmt.body, env, module, returns)
        if isinstance(stmt, ast.Try):
            flow = self._exec_block(stmt.body, env, module, returns)
            self._exec_block(stmt.finalbody, env, module, returns)
            return _NORMAL if flow == _RAISE else flow
        return _NORMAL                          # pass, del, global, import, assert

    def _exec_if(self, stmt, env, module, returns) -> int:
        t = self._truth(self._eval(stmt.test, env, module))
        if t is True:
            return self._exec_block(stmt.body, env, module, returns)
        if t is False:
            return self._exec_block(stmt.orelse, env, module, returns)
        env_t, env_f = dict(env), dict(env)
        flow_t = self._exec_block(stmt.body, env_t, module, returns)
        flow_f = self._exec_block(stmt.orelse, env_f, module, returns)
        live = [e for f, e in ((flow_t, env_t), (flow_f, env_f)) if f == _NORMAL]
        if not live:
            return flow_t if flow_t != _NORMAL else flow_f
        env.clear()
        if len(live) == 1:
            env.update(live[0])
            return _NORMAL
        for k in set(env_t) | set(env_f):
            env[k] = (self._join(env_t[k], env_f[k]) if k in env_t and k in env_f
                      else UNKNOWN)
        return _NORMAL

    def _exec_for(self, stmt, env, module, returns) -> int:
        it = _as_atuple(self._eval(stmt.iter, env, module))
        if it is None or len(it.items) > 256:
            self._havoc(stmt, env)
            return _NORMAL
        for item in it.items:
            self._assign(stmt.target, item, env, module)
            flow = self._exec_block(stmt.body, env, module, returns)
            if flow == _BREAK:
                return _NORMAL
            if flow in (_RETURN, _RAISE):
                return flow
        self._exec_block(stmt.orelse, env, module, returns)
        return _NORMAL

    def _havoc(self, stmt, env) -> None:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
                env[node.id] = UNKNOWN

    def _assign(self, target, val, env, module) -> None:
        if isinstance(target, ast.Name):
            env[target.id] = val
        elif isinstance(target, (ast.Tuple, ast.List)):
            seq = _as_atuple(val)
            if seq is not None and len(seq.items) == len(target.elts):
                for t, v in zip(target.elts, seq.items, strict=True):
                    self._assign(t, v, env, module)
            else:
                for t in target.elts:
                    self._assign(t.value if isinstance(t, ast.Starred) else t,
                                 UNKNOWN, env, module)
        elif isinstance(target, ast.Subscript):
            base = self._eval(target.value, env, module)
            if isinstance(base, AArray):
                region = self._index_shape(base, self._eval_index(target.slice, env, module))
                if region is not None and isinstance(val, AArray):
                    self._broadcast(region, val.shape, target, what="stored value vs target slice")
            elif isinstance(base, ATuple) and base.mutable:
                i = self._concrete_int(self._eval(target.slice, env, module))
                if i is not None and -len(base.items) <= i < len(base.items):
                    base.items[i] = val
        # attribute stores and the rest: ignore

    # -- joins -------------------------------------------------------------
    def _join(self, a: AVal, b: AVal) -> AVal:
        if a is b:
            return a
        if isinstance(a, AArray) and isinstance(b, AArray):
            if a.ndim != b.ndim:
                return UNKNOWN
            dims = tuple(join_dims(x, y) or _fresh("join")
                         for x, y in zip(a.shape, b.shape, strict=True))
            return AArray(dims, a.dtype if a.dtype == b.dtype else promote_types(a.dtype, b.dtype))
        if isinstance(a, AInt) and isinstance(b, AInt):
            return AInt(join_dims(a.dim, b.dim) or _fresh("join"))
        if isinstance(a, AConst) and isinstance(b, AConst):
            return a if a.value == b.value else UNKNOWN
        if isinstance(a, ATuple) and isinstance(b, ATuple) and len(a.items) == len(b.items):
            return ATuple([self._join(x, y) for x, y in zip(a.items, b.items, strict=True)])
        if isinstance(a, AFunc) and isinstance(b, AFunc) and a.name == b.name:
            return a
        return UNKNOWN

    def _truth(self, v: AVal) -> bool | None:
        if isinstance(v, AConst):
            try:
                return bool(v.value)
            except Exception:
                return None
        if isinstance(v, AInt) and v.dim.is_const:
            return bool(v.dim.const)
        return None

    def _concrete_int(self, v: AVal) -> int | None:
        if isinstance(v, AConst) and isinstance(v.value, int) and not isinstance(v.value, bool):
            return v.value
        if isinstance(v, AInt) and v.dim.is_const:
            return v.dim.const
        return None

    # -- expressions -------------------------------------------------------
    def _eval(self, node, env, module: ModuleEnv) -> AVal:
        self._steps += 1
        if self._steps > _MAX_STEPS:
            return UNKNOWN
        if isinstance(node, ast.Constant):
            return AConst(node.value)
        if isinstance(node, ast.Name):
            if node.id in env:
                return env[node.id]
            resolved = module.resolve(node.id)
            if resolved is not None:
                return resolved
            if node.id in _BUILTINS:
                return AFunc(f"builtin.{node.id}")
            return UNKNOWN
        if isinstance(node, ast.Attribute):
            return self._eval_attribute(node, env, module)
        if isinstance(node, ast.Subscript):
            return self._eval_subscript(node, env, module)
        if isinstance(node, ast.Call):
            return self._eval_call(node, env, module)
        if isinstance(node, (ast.Tuple, ast.List)):
            items: list[AVal] = []
            for e in node.elts:
                if isinstance(e, ast.Starred):
                    v = _as_atuple(self._eval(e.value, env, module))
                    if v is None:
                        return UNKNOWN
                    items.extend(v.items)
                else:
                    items.append(self._eval(e, env, module))
            return ATuple(items, mutable=isinstance(node, ast.List))
        if isinstance(node, ast.BinOp):
            return self._binop(self._eval(node.left, env, module), node.op,
                               self._eval(node.right, env, module), node)
        if isinstance(node, ast.UnaryOp):
            v = self._eval(node.operand, env, module)
            if isinstance(node.op, ast.USub):
                if isinstance(v, AConst) and isinstance(v.value, (int, float)):
                    return AConst(-v.value)
                d = as_dim(v)
                if d is not None:
                    return AInt(-d)
            if isinstance(node.op, ast.Not):
                t = self._truth(v)
                return AConst(not t) if t is not None else UNKNOWN
            if isinstance(node.op, ast.Invert) and isinstance(v, AConst) \
                    and isinstance(v.value, int):
                return AConst(~v.value)
            return v if isinstance(v, AArray) else UNKNOWN
        if isinstance(node, ast.Compare):
            return self._compare(node, env, module)
        if isinstance(node, ast.BoolOp):
            # Python's short circuit: the first decisive operand settles it.
            decisive = not isinstance(node.op, ast.And)
            unknown = False
            for v in node.values:
                t = self._truth(self._eval(v, env, module))
                if t is decisive:
                    return AConst(decisive)
                unknown = unknown or t is None
            return UNKNOWN if unknown else AConst(not decisive)
        if isinstance(node, ast.IfExp):
            t = self._truth(self._eval(node.test, env, module))
            if t is True:
                return self._eval(node.body, env, module)
            if t is False:
                return self._eval(node.orelse, env, module)
            return self._join(self._eval(node.body, env, module),
                              self._eval(node.orelse, env, module))
        if isinstance(node, (ast.ListComp, ast.GeneratorExp)):
            return self._eval_comp(node, env, module)
        if isinstance(node, ast.JoinedStr):
            return AConst("<fstring>")
        if isinstance(node, ast.Starred):
            return self._eval(node.value, env, module)
        return UNKNOWN

    def _eval_comp(self, node, env, module) -> AVal:
        if len(node.generators) != 1:
            return UNKNOWN
        gen = node.generators[0]
        it = _as_atuple(self._eval(gen.iter, env, module))
        if it is None or len(it.items) > 256:
            return UNKNOWN
        out: list[AVal] = []
        inner = dict(env)
        for item in it.items:
            self._assign(gen.target, item, inner, module)
            keep = True
            for cond in gen.ifs:
                t = self._truth(self._eval(cond, inner, module))
                if t is None:
                    return UNKNOWN
                if t is False:
                    keep = False
                    break
            if keep:
                out.append(self._eval(node.elt, inner, module))
        return ATuple(out, mutable=isinstance(node, ast.ListComp))

    # -- attributes --------------------------------------------------------
    _TENSOR_METHODS = {
        "to", "long", "int", "float", "double", "bool", "half", "reshape", "view",
        "expand", "index_select", "index_add_", "clamp_max", "clamp_min", "clamp",
        "contiguous", "pin_memory", "clone", "abs", "neg", "size", "dim", "numel",
        "element_size", "data_ptr",
    }

    def _eval_attribute(self, node, env, module) -> AVal:
        base = self._eval(node.value, env, module)
        attr = node.attr
        if isinstance(base, AFunc):
            if base.name == "torch" and attr in _DTYPE_NAMES:
                return ADType(_DTYPE_NAMES[attr])
            return AFunc(f"{base.name}.{attr}")
        if isinstance(base, AModule):
            return base.module.resolve(attr) or UNKNOWN
        if isinstance(base, AArray):
            if attr == "shape":
                return ATuple([AInt(d) for d in base.shape])
            if attr == "ndim":
                return AConst(base.ndim)
            if attr == "dtype":
                return ADType(base.dtype)
            if attr == "T" and base.ndim == 2:
                return AArray(tuple(reversed(base.shape)), base.dtype)
            if attr == "mT" and base.ndim >= 2:
                return AArray((*base.shape[:-2], base.shape[-1], base.shape[-2]), base.dtype)
            if attr in self._TENSOR_METHODS:
                return ABound(base, attr)
            return UNKNOWN
        if isinstance(base, ATuple) and attr in ("append", "extend", "index"):
            return ABound(base, attr)
        return UNKNOWN

    # -- subscripts --------------------------------------------------------
    def _eval_index(self, slc, env, module) -> list:
        """Normalize an index expression into a list of index items."""
        if isinstance(slc, ast.Tuple):
            return [self._eval_index_item(e, env, module) for e in slc.elts]
        return [self._eval_index_item(slc, env, module)]

    def _eval_index_item(self, node, env, module):
        if isinstance(node, ast.Slice):
            lo = self._eval(node.lower, env, module) if node.lower else None
            hi = self._eval(node.upper, env, module) if node.upper else None
            step = self._eval(node.step, env, module) if node.step else None
            return ("slice", lo, hi, step)
        v = self._eval(node, env, module)
        if isinstance(v, AConst) and v.value is Ellipsis:
            return ("ellipsis",)
        return v

    def _eval_subscript(self, node, env, module) -> AVal:
        base = self._eval(node.value, env, module)
        if isinstance(base, AConst) and isinstance(base.value, (tuple, list)):
            base = ATuple([AConst(x) for x in base.value])
        if isinstance(base, ATuple):
            if isinstance(node.slice, ast.Slice):
                lo = self._concrete_int(self._eval(node.slice.lower, env, module)) \
                    if node.slice.lower else None
                hi = self._concrete_int(self._eval(node.slice.upper, env, module)) \
                    if node.slice.upper else None
                if (node.slice.lower is None or lo is not None) and \
                        (node.slice.upper is None or hi is not None) and node.slice.step is None:
                    return ATuple(base.items[slice(lo, hi)], base.mutable)
                return UNKNOWN
            i = self._concrete_int(self._eval(node.slice, env, module))
            if i is not None and -len(base.items) <= i < len(base.items):
                return base.items[i]
            return UNKNOWN
        if isinstance(base, AArray):
            region = self._index_shape(base, self._eval_index(node.slice, env, module))
            if region is None:
                return UNKNOWN
            return AArray(region, base.dtype)
        return UNKNOWN

    def _index_shape(self, base: AArray, items: list) -> tuple | None:
        """Result shape of indexing `base` with `items` (basic slicing,
        None, Ellipsis, scalars and one-dimensional index tensors); None =
        unmodeled index."""
        def consumes(it) -> bool:
            return not (isinstance(it, AConst) and it.value is None) \
                and not (isinstance(it, tuple) and it[0] == "ellipsis")

        n_consuming = sum(1 for it in items if consumes(it))
        expanded: list = []
        for it in items:
            if isinstance(it, tuple) and it[0] == "ellipsis":
                expanded.extend([("slice", None, None, None)] * (base.ndim - n_consuming))
            else:
                expanded.append(it)
        while sum(1 for it in expanded if consumes(it)) < base.ndim:
            expanded.append(("slice", None, None, None))
        out: list = []
        pos = 0
        for it in expanded:
            if isinstance(it, AConst) and it.value is None:
                out.append(Dim.const_(1))
                continue
            if pos >= base.ndim:
                return None
            dim = base.shape[pos]
            pos += 1
            if isinstance(it, tuple) and it[0] == "slice":
                _, lo, hi, step = it
                if step is not None:
                    out.append(_fresh("strided"))
                    continue
                lo_d = as_dim(lo) if lo is not None else Dim.const_(0)
                hi_d = as_dim(hi) if hi is not None else dim
                if lo_d is None or hi_d is None:
                    out.append(_fresh("slice"))
                elif lo_d == Dim.const_(0):
                    if hi_d.is_const and dim.is_const:
                        out.append(Dim.const_(min(hi_d.const, dim.const))
                                   if hi_d.const >= 0 else _fresh("slice"))
                    else:
                        out.append(hi_d)
                else:
                    delta = hi_d - lo_d
                    out.append(delta if not delta.has_opaque else _fresh("slice"))
                continue
            if isinstance(it, AArray):
                if it.dtype.kind == "bool":
                    return None                 # boolean mask: data-dependent size
                out.extend(it.shape)
                continue
            if as_dim(it) is not None or isinstance(it, AUnknown):
                continue                        # scalar index: drops the axis
            return None
        return tuple(out)

    # -- operators ---------------------------------------------------------
    def _binop(self, lv: AVal, op, rv: AVal, node) -> AVal:
        if isinstance(lv, AConst) and isinstance(rv, AConst):
            try:
                return AConst(_PYOPS[type(op)](lv.value, rv.value))
            except Exception:
                return UNKNOWN
        ld, rd = as_dim(lv), as_dim(rv)
        if ld is not None and rd is not None:
            if isinstance(op, ast.Add):
                return AInt(ld + rd)
            if isinstance(op, ast.Sub):
                return AInt(ld - rd)
            if isinstance(op, ast.Mult):
                return AInt(ld * rd)
            if isinstance(op, ast.FloorDiv):
                return AInt(ld // rd)
            if isinstance(op, ast.Mod):
                return AInt(ld % rd)
            return UNKNOWN
        if isinstance(op, ast.MatMult) and isinstance(lv, AArray) and isinstance(rv, AArray):
            return self._matmul(lv, rv, node)
        if isinstance(lv, AArray) or isinstance(rv, AArray):
            return self._array_binop(lv, op, rv, node)
        return UNKNOWN

    def _array_binop(self, lv, op, rv, node) -> AVal:
        la, ra = _operand(lv), _operand(rv)
        if la is None or ra is None:
            return UNKNOWN
        (sa, da, pa), (sb, db, pb) = la, ra
        shape = self._broadcast(sa, sb, node)
        if isinstance(op, (ast.Lt, ast.LtE, ast.Gt, ast.GtE, ast.Eq, ast.NotEq)):
            return AArray(shape, _BOOL)
        dt = promote(da, db, pa, pb)
        if isinstance(op, ast.Div) and dt.category < 2:
            dt = _DEFAULT[2]                    # true division: the default float
        if isinstance(op, (ast.Mult, ast.LShift)) and _is_int(da) and _is_int(db) \
                and _is_int(dt) and dt.bits < 32:
            sym = "×" if isinstance(op, ast.Mult) else "<<"
            self.problem(node, f"{da} {sym} {db} stays {dt} in torch and wraps at {dt.bits} "
                               "bits: widen an operand to int32 (Alg. 2 forms int32 products)")
        return AArray(shape, dt)

    def _broadcast(self, sa: tuple, sb: tuple, node, what: str = "operands") -> tuple:
        out: list = []
        la, lb = len(sa), len(sb)
        for i in range(max(la, lb)):
            a = sa[la - 1 - i] if i < la else Dim.const_(1)
            b = sb[lb - 1 - i] if i < lb else Dim.const_(1)
            if a == b:
                out.append(a)
            elif a == Dim.const_(1):
                out.append(b)
            elif b == Dim.const_(1):
                out.append(a)
            elif a.has_opaque or b.has_opaque:
                out.append(_fresh("bcast"))
            else:
                self.problem(node, f"shape mismatch broadcasting {what}: {_shape_str(sa)} vs "
                                   f"{_shape_str(sb)} (dim {a} vs {b})")
                out.append(_fresh("bcast"))
        return tuple(reversed(out))

    def _matmul(self, a: AArray, b: AArray, node) -> AVal:
        if a.ndim == 0 or b.ndim == 0:
            return UNKNOWN
        ka = a.shape[-1]
        kb = b.shape[-2] if b.ndim >= 2 else b.shape[0]
        if not (ka.has_opaque or kb.has_opaque) and ka != kb:
            self.problem(node, f"matmul contraction mismatch: {_shape_str(a.shape)} @ "
                               f"{_shape_str(b.shape)} (contracting dim {ka} vs {kb})")
        if a.dtype != b.dtype:
            self.problem(node, f"matmul of {a.dtype} and {b.dtype}: torch requires one dtype")
        batch = self._broadcast(a.shape[:-2], b.shape[:-2], node, what="matmul batch dims")
        rows = a.shape[-2:-1]
        cols = b.shape[-1:] if b.ndim >= 2 else ()
        return AArray((*batch, *rows, *cols), a.dtype)

    def _compare(self, node, env, module) -> AVal:
        if len(node.ops) != 1:
            return UNKNOWN
        lv = self._eval(node.left, env, module)
        rv = self._eval(node.comparators[0], env, module)
        op = node.ops[0]
        if isinstance(op, (ast.Is, ast.IsNot)):
            def known_none(v):
                if isinstance(v, AConst):
                    return v.value is None
                if isinstance(v, (AArray, ATuple, AInt, ADType, AClosure)):
                    return False
                return None
            ln, rn = known_none(lv), known_none(rv)
            if isinstance(rv, AConst) and rv.value is None and ln is not None:
                return AConst(ln if isinstance(op, ast.Is) else not ln)
            if isinstance(lv, AConst) and lv.value is None and rn is not None:
                return AConst(rn if isinstance(op, ast.Is) else not rn)
            return UNKNOWN
        if isinstance(lv, AConst) and isinstance(rv, AConst):
            try:
                return AConst(_PYCMP[type(op)](lv.value, rv.value))
            except Exception:
                return UNKNOWN
        li, ri = self._concrete_int(lv), self._concrete_int(rv)
        if li is not None and ri is not None and not isinstance(op, (ast.In, ast.NotIn)):
            return AConst(_PYCMP[type(op)](li, ri))
        if (isinstance(lv, AArray) or isinstance(rv, AArray)) and type(op) in _PYCMP \
                and not isinstance(op, (ast.In, ast.NotIn)):
            return self._array_binop(lv, op, rv, node)
        return UNKNOWN

    # -- calls -------------------------------------------------------------
    def _eval_call(self, node, env, module) -> AVal:
        func = self._eval(node.func, env, module)
        args: list[AVal] = []
        for a in node.args:
            if isinstance(a, ast.Starred):
                v = _as_atuple(self._eval(a.value, env, module))
                if v is None:
                    args.append(UNKNOWN)
                else:
                    args.extend(v.items)
            else:
                args.append(self._eval(a, env, module))
        kwargs = {kw.arg: self._eval(kw.value, env, module)
                  for kw in node.keywords if kw.arg is not None}
        return self._call(func, args, kwargs, node)

    def _call(self, func: AVal, args: list, kwargs: dict, node) -> AVal:
        if isinstance(func, AClosure):
            return self.call_function(func.node, func.module, args, kwargs)
        if isinstance(func, ABound):
            return self._call_method(func, args, kwargs, node)
        if isinstance(func, ADType):
            return UNKNOWN
        if isinstance(func, AFunc):
            handler = _PRIMITIVES.get(func.name)
            if handler is not None:
                return handler(self, func, args, kwargs, node)
            if func.name.startswith("ctypes.CDLL."):
                return AInt(_fresh("ctypes"))   # a C entry's return code
        return UNKNOWN

    def _call_method(self, bound: ABound, args, kwargs, node) -> AVal:
        base, attr = bound.base, bound.attr
        if isinstance(base, ATuple):
            if attr == "append" and base.mutable and args:
                base.items.append(args[0])
                return AConst(None)
            if attr == "extend" and base.mutable and args:
                more = _as_atuple(args[0])
                if more is not None:
                    base.items.extend(more.items)
                    return AConst(None)
            return UNKNOWN
        if not isinstance(base, AArray):
            return UNKNOWN
        casts = {"long": _INT64, "int": _INT32, "float": _F32, "double": _F64,
                 "bool": _BOOL, "half": DType("float", 16)}
        if attr in casts:
            return AArray(base.shape, casts[attr])
        if attr == "to":
            dt = next((a.dtype for a in (*args, kwargs.get("dtype")) if isinstance(a, ADType)),
                      None)
            return base if dt is None else AArray(base.shape, dt)
        if attr in ("reshape", "view"):
            shape = _as_atuple(args[0]) if len(args) == 1 else None
            return self._reshape(base, shape.items if shape is not None else args)
        if attr == "expand":
            return self._expand(base, args, node)
        if attr == "index_select":
            return self._index_select(base, args, node)
        if attr == "index_add_":
            return self._index_add(base, args, node)
        if attr in ("clamp_max", "clamp_min", "clamp", "contiguous", "pin_memory", "clone",
                    "abs", "neg"):
            return base
        if attr == "size":
            i = self._concrete_int(args[0]) if args else None
            if i is not None and -base.ndim <= i < base.ndim:
                return AInt(base.shape[i])
            return ATuple([AInt(d) for d in base.shape]) if not args else UNKNOWN
        if attr == "dim":
            return AConst(base.ndim)
        if attr == "numel":
            return AInt(_prod(base.shape))
        if attr == "element_size":
            return AConst(base.dtype.bits // 8)
        if attr == "data_ptr":
            return AInt(_fresh("ptr"))
        return UNKNOWN

    def _axis(self, base: AArray, v: AVal, node, what: str) -> int | None:
        d = self._concrete_int(v)
        if d is None:
            return None
        if not -base.ndim <= d < base.ndim:
            self.problem(node, f"{what} dim {d} is out of range for rank {base.ndim} "
                               f"{_shape_str(base.shape)}")
            return None
        return d % base.ndim

    def _index_select(self, base: AArray, args, node) -> AVal:
        if len(args) < 2 or not isinstance(args[1], AArray):
            return UNKNOWN
        d, idx = self._axis(base, args[0], node, "index_select"), args[1]
        if idx.ndim != 1:
            self.problem(node, f"index_select index must be one-dimensional; got "
                               f"{_shape_str(idx.shape)}")
            return UNKNOWN
        if idx.dtype not in (_INT32, _INT64):
            self.problem(node, f"index_select index must be int32 or int64; got {idx.dtype}")
        if d is None:
            return UNKNOWN
        return AArray((*base.shape[:d], idx.shape[0], *base.shape[d + 1:]), base.dtype)

    def _index_add(self, base: AArray, args, node) -> AVal:
        if len(args) < 3 or not isinstance(args[1], AArray) or not isinstance(args[2], AArray):
            return base
        d = self._axis(base, args[0], node, "index_add_")
        idx, src = args[1], args[2]
        self.index_adds.append(IndexAdd(
            line=getattr(node, "lineno", 0), target_shape=base.shape, dim=d,
            index_shape=idx.shape, source_shape=src.shape, target_origin=base.origin,
            rel=self.current_rel))
        if idx.ndim != 1:
            self.problem(node, f"index_add_ index must be one-dimensional; got "
                               f"{_shape_str(idx.shape)}")
        elif d is not None and src.ndim == base.ndim:
            n, k = src.shape[d], idx.shape[0]
            if not (n.has_opaque or k.has_opaque) and n != k:
                self.problem(node, f"index_add_ source has {n} rows along dim {d} but the "
                                   f"index has {k}")
            for i, (a, b) in enumerate(zip(base.shape, src.shape, strict=True)):
                if i != d and a != b and not (a.has_opaque or b.has_opaque):
                    self.problem(node, f"index_add_ source {_shape_str(src.shape)} and target "
                                       f"{_shape_str(base.shape)} differ in dim {i}")
        elif d is not None:
            self.problem(node, f"index_add_ source rank {src.ndim} differs from the "
                               f"target's {base.ndim}")
        if src.dtype != base.dtype:
            self.problem(node, f"index_add_ of {src.dtype} into {base.dtype}: torch raises "
                               "unless the source has the target's dtype")
        return base

    def _expand(self, base: AArray, args, node) -> AVal:
        sizes = _as_atuple(args[0]).items if len(args) == 1 and _as_atuple(args[0]) else args
        lead = len(sizes) - base.ndim
        if lead < 0:
            self.problem(node, f"expand to {len(sizes)} dims of a rank-{base.ndim} tensor")
            return UNKNOWN
        out = []
        for i, s in enumerate(sizes):
            have = base.shape[i - lead] if i >= lead else None
            want = as_dim(s)
            if want == Dim.const_(-1) and have is not None:
                out.append(have)
            elif want is None:
                out.append(_fresh("expand"))
            elif have is None or have == Dim.const_(1) or have == want:
                out.append(want)
            elif have.has_opaque or want.has_opaque:
                out.append(_fresh("expand"))
            else:
                self.problem(node, f"expand of dim {have} to {want}: only size-1 dims expand")
                out.append(_fresh("expand"))
        return AArray(tuple(out), base.dtype)

    def _reshape(self, base: AArray, shape_args: list) -> AVal:
        dims: list[Dim | None] = []
        hole = None
        for i, a in enumerate(shape_args):
            if self._concrete_int(a) == -1:
                hole = i
                dims.append(None)
                continue
            d = as_dim(a)
            dims.append(d if d is not None else _fresh("reshape"))
        if hole is not None:
            known = _prod(d for d in dims if d is not None)
            rem = _try_exact_div(_prod(base.shape), known)
            dims[hole] = rem if rem is not None else _fresh("reshape")
        return AArray(tuple(dims), base.dtype)


_PYOPS = {
    ast.Add: lambda a, b: a + b, ast.Sub: lambda a, b: a - b,
    ast.Mult: lambda a, b: a * b, ast.Div: lambda a, b: a / b,
    ast.FloorDiv: lambda a, b: a // b, ast.Mod: lambda a, b: a % b,
    ast.Pow: lambda a, b: a ** b, ast.LShift: lambda a, b: a << b,
    ast.RShift: lambda a, b: a >> b, ast.BitOr: lambda a, b: a | b,
    ast.BitAnd: lambda a, b: a & b, ast.BitXor: lambda a, b: a ^ b,
}

_PYCMP = {
    ast.Eq: lambda a, b: a == b, ast.NotEq: lambda a, b: a != b,
    ast.Lt: lambda a, b: a < b, ast.LtE: lambda a, b: a <= b,
    ast.Gt: lambda a, b: a > b, ast.GtE: lambda a, b: a >= b,
    ast.In: lambda a, b: a in b, ast.NotIn: lambda a, b: a not in b,
}


def _operand(v: AVal) -> tuple | None:
    """(shape, dtype, priority) of an arithmetic operand: a tensor, or a
    Python scalar (bool, int64 for int, float64 for float)."""
    if isinstance(v, AArray):
        return v.shape, v.dtype, v.priority
    if isinstance(v, AConst) and isinstance(v.value, bool):
        return (), _BOOL, SCALAR
    if isinstance(v, AInt) or (isinstance(v, AConst) and isinstance(v.value, int)):
        return (), _INT64, SCALAR
    if isinstance(v, AConst) and isinstance(v.value, float):
        return (), _F64, SCALAR
    return None


def _as_atuple(v: AVal) -> ATuple | None:
    if isinstance(v, ATuple):
        return v
    if isinstance(v, AConst) and isinstance(v.value, (tuple, list, range)):
        return ATuple([AConst(x) for x in v.value])
    return None


# ---------------------------------------------------------------------------
# Primitive models
# ---------------------------------------------------------------------------

def _shape_from(args: list) -> tuple | None:
    """A size given as one tuple/list or as separate ints."""
    seq = _as_atuple(args[0]) if len(args) == 1 else None
    items = seq.items if seq is not None else args
    if not items and seq is None:
        return None
    dims = [as_dim(i) for i in items]
    return tuple(d if d is not None else _fresh("shape") for d in dims)


def _dtype_of(v: AVal | None, default: DType) -> DType:
    return v.dtype if isinstance(v, ADType) else default


def _origin(self, node) -> tuple:
    return (self.current_rel, getattr(node, "lineno", 0))


def _p_zeros(self, func, args, kwargs, node):
    shape = _shape_from(args) if args else _shape_from([kwargs["size"]]) \
        if "size" in kwargs else None
    if shape is None:
        return UNKNOWN
    return AArray(shape, _dtype_of(kwargs.get("dtype"), _F32), origin=_origin(self, node))


def _p_full(self, func, args, kwargs, node):
    if len(args) < 2:
        return UNKNOWN
    shape = _shape_from([args[0]])
    fill = _operand(args[1])
    default = _DEFAULT[fill[1].category] if fill is not None and not fill[0] else _F32
    return AArray(shape, _dtype_of(kwargs.get("dtype"), default), origin=_origin(self, node))


def _p_like(self, func, args, kwargs, node):
    if not args or not isinstance(args[0], AArray):
        return UNKNOWN
    return AArray(args[0].shape, _dtype_of(kwargs.get("dtype"), args[0].dtype),
                  origin=_origin(self, node))


def _p_arange(self, func, args, kwargs, node):
    if len(args) == 1:
        lo, hi = Dim.const_(0), as_dim(args[0])
    elif len(args) == 2:
        lo, hi = as_dim(args[0]), as_dim(args[1])
    else:
        return UNKNOWN
    is_float = any(isinstance(a, AConst) and isinstance(a.value, float) for a in args)
    if lo is None or hi is None:
        return UNKNOWN
    return AArray((hi - lo,), _dtype_of(kwargs.get("dtype"), _F32 if is_float else _INT64))


def _nested(v: AVal) -> tuple[tuple, DType | None] | None:
    """(shape, element dtype) of a nested tuple/list of scalars."""
    if isinstance(v, (AInt, AConst)) and not isinstance(getattr(v, "value", 0), (tuple, list)):
        op = _operand(v)
        return ((), _DEFAULT[op[1].category]) if op is not None else ((), None)
    seq = _as_atuple(v)
    if seq is None:
        return None
    inner = [_nested(x) for x in seq.items]
    if any(i is None for i in inner):
        return None
    shapes = {i[0] for i in inner}
    if len(shapes) > 1:
        return None
    dts = [i[1] for i in inner if i[1] is not None]
    dt = None
    for d in dts:
        dt = d if dt is None else promote_types(dt, d)
    return (Dim.const_(len(inner)), *(shapes.pop() if shapes else ())), dt


def _p_tensor(self, func, args, kwargs, node):
    if not args:
        return UNKNOWN
    if isinstance(args[0], AArray):
        return AArray(args[0].shape, _dtype_of(kwargs.get("dtype"), args[0].dtype))
    got = _nested(args[0])
    if got is None:
        return UNKNOWN
    return AArray(got[0], _dtype_of(kwargs.get("dtype"), got[1] or _F32),
                  origin=_origin(self, node))


def _p_where(self, func, args, kwargs, node):
    if len(args) != 3:
        return UNKNOWN                          # one-argument where: data-dependent size
    ops = [_operand(a) for a in args]
    if any(o is None for o in ops):
        return UNKNOWN
    shape = self._broadcast(ops[0][0], ops[1][0], node, what="where operands")
    shape = self._broadcast(shape, ops[2][0], node, what="where operands")
    (_, da, pa), (_, db, pb) = ops[1], ops[2]
    return AArray(shape, promote(da, db, pa, pb))


def _p_gather(self, func, args, kwargs, node):
    if len(args) < 3 or not isinstance(args[0], AArray) or not isinstance(args[2], AArray):
        return UNKNOWN
    src, idx = args[0], args[2]
    if src.ndim != idx.ndim:
        self.problem(node, f"torch.gather needs equal ranks: {_shape_str(src.shape)} vs "
                           f"{_shape_str(idx.shape)}")
        return UNKNOWN
    if idx.dtype != _INT64:
        self.problem(node, f"torch.gather index must be int64; got {idx.dtype}")
    return AArray(idx.shape, src.dtype)


def _p_matmul(self, func, args, kwargs, node):
    if len(args) < 2 or not isinstance(args[0], AArray) or not isinstance(args[1], AArray):
        return UNKNOWN
    return self._matmul(args[0], args[1], node)


def _p_pad(self, func, args, kwargs, node):
    if len(args) < 2 or not isinstance(args[0], AArray):
        return UNKNOWN
    arr, spec = args[0], _as_atuple(args[1])
    if spec is None:
        return UNKNOWN
    pads = [as_dim(p) for p in spec.items]
    if len(pads) % 2 or len(pads) > 2 * arr.ndim:
        self.problem(node, f"F.pad gives {len(pads)} pad sizes for a rank-{arr.ndim} tensor")
        return UNKNOWN
    if any(p is None for p in pads):
        return UNKNOWN
    shape = list(arr.shape)
    for i in range(len(pads) // 2):              # the last dim first
        shape[arr.ndim - 1 - i] = shape[arr.ndim - 1 - i] + pads[2 * i] + pads[2 * i + 1]
    return AArray(tuple(shape), arr.dtype)


def _p_pinv(self, func, args, kwargs, node):
    if not args or not isinstance(args[0], AArray) or args[0].ndim < 2:
        return UNKNOWN
    v = args[0]
    return AArray((*v.shape[:-2], v.shape[-1], v.shape[-2]), v.dtype)


def _p_load(self, func, args, kwargs, node):
    """`kernels/_build.py::load`: a ctypes library, whose entries return an
    opaque int."""
    return AFunc("ctypes.CDLL")


def _p_len(self, func, args, kwargs, node):
    seq = _as_atuple(args[0]) if args else None
    if seq is not None:
        return AConst(len(seq.items))
    if args and isinstance(args[0], AConst) and isinstance(args[0].value, str):
        return AConst(len(args[0].value))
    return UNKNOWN


def _p_range(self, func, args, kwargs, node):
    vals = [self._concrete_int(a) for a in args]
    if vals and all(v is not None for v in vals):
        return ATuple([AConst(v) for v in range(*vals)])
    return UNKNOWN


def _p_enumerate(self, func, args, kwargs, node):
    it = _as_atuple(args[0]) if args else None
    if it is not None:
        return ATuple([ATuple([AConst(i), v]) for i, v in enumerate(it.items)])
    return UNKNOWN


def _p_zip(self, func, args, kwargs, node):
    cols = [_as_atuple(a) for a in args]
    if any(c is None for c in cols):
        return UNKNOWN
    return ATuple([ATuple(list(row)) for row in zip(*(c.items for c in cols), strict=False)])


def _p_reversed(self, func, args, kwargs, node):
    it = _as_atuple(args[0]) if args else None
    return ATuple(list(reversed(it.items))) if it is not None else UNKNOWN


def _p_tuple(self, func, args, kwargs, node):
    mutable = func.name == "builtin.list"
    if not args:
        return ATuple([], mutable=mutable)
    it = _as_atuple(args[0])
    return ATuple(list(it.items), mutable=mutable) if it is not None else UNKNOWN


def _p_minmax(self, func, args, kwargs, node):
    if len(args) == 1:
        seq = _as_atuple(args[0])
        if seq is None:
            return UNKNOWN
        args = seq.items
    vals = [self._concrete_int(a) for a in args]
    if len(args) >= 2 and all(v is not None for v in vals):
        return AConst((max if func.name.endswith("max") else min)(*vals))
    dims = [as_dim(a) for a in args]
    if dims and dims[0] is not None and all(d == dims[0] for d in dims):
        return AInt(dims[0])
    return UNKNOWN


def _p_int(self, func, args, kwargs, node):
    if args:
        v = self._concrete_int(args[0])
        if v is not None:
            return AConst(v)
        d = as_dim(args[0])
        if d is not None:
            return AInt(d)
    return UNKNOWN


_PRIMITIVES = {
    "torch.zeros": _p_zeros, "torch.ones": _p_zeros, "torch.empty": _p_zeros,
    "torch.full": _p_full,
    "torch.zeros_like": _p_like, "torch.ones_like": _p_like, "torch.empty_like": _p_like,
    "torch.arange": _p_arange,
    "torch.tensor": _p_tensor, "torch.as_tensor": _p_tensor,
    "torch.where": _p_where,
    "torch.gather": _p_gather,
    "torch.matmul": _p_matmul,
    "torch.linalg.pinv": _p_pinv,
    "F.pad": _p_pad,
    "src/repro_torch/kernels/_build.py::load": _p_load,
    "builtin.len": _p_len, "builtin.range": _p_range,
    "builtin.enumerate": _p_enumerate, "builtin.zip": _p_zip,
    "builtin.reversed": _p_reversed, "builtin.tuple": _p_tuple,
    "builtin.list": _p_tuple, "builtin.max": _p_minmax,
    "builtin.min": _p_minmax, "builtin.int": _p_int,
}
