"""PyTorch hot-path rules: host-device synchronisation, hidden global RNG
state and registration-order enumeration.

The counterparts of `repro.analysis.jax_rules`.  These passes walk the
port's kernel/engine hot paths (`src/repro_torch/{kernels,core,engine,
formats,batch,serve,obs}`) for the hazards that a CPU run hides and the
card makes expensive: a host readout or a blocking copy between two
kernel launches stalls the dispatch queue, and a draw from torch's global
generator makes reruns incomparable.

The JAX rules with no counterpart here, and why:

  retrace-control, tracer-leak, trace-in-jit — the port compiles nothing
      (no `torch.compile`, no CUDA graphs): there is no trace to retrace,
      leak from or run a span inside.
  pallas-blockspec — the port has no BlockSpecs; `kernels/tiles.py::
      plan_launch` checks each launch plan against the shapes and the
      card's shared memory at run time.

Every rule is a generator over `FileContext` yielding `Finding`s; the
fixture tests in `tests/test_torch_analysis.py` hold one bad snippet (must
fire) and one good snippet (must stay quiet) per rule.
"""
from __future__ import annotations

import ast
from collections.abc import Iterator

from .engine import FileContext, Finding, register_rule

__all__ = [
    "TORCH_TARGETS",
    "check_dict_order",
    "check_host_sync",
    "check_nondeterminism",
]

TORCH_TARGETS = (
    "src/repro_torch/kernels",
    "src/repro_torch/core",
    "src/repro_torch/engine",
    "src/repro_torch/formats",
    "src/repro_torch/batch",
    "src/repro_torch/serve",
    "src/repro_torch/obs",
    "src/repro_torch/models",
    "src/repro_torch/launch",
    "src/repro_torch/optim",
    "src/repro_torch/checkpoint",
)


# ---------------------------------------------------------------------------
# shared AST helpers
# ---------------------------------------------------------------------------

def _dotted(node: ast.AST) -> str | None:
    """`a.b.c` → "a.b.c" for Name/Attribute chains, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


_LOOPS = (ast.For, ast.While, ast.AsyncFor)
_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)


def _loop_depth_map(tree: ast.AST) -> dict[ast.AST, int]:
    """node → number of enclosing for/while loops (function bodies reset
    the count: a nested def is not 'inside' its enclosing loop at runtime
    until called, and flagging it would double-report)."""
    depth: dict[ast.AST, int] = {}

    def visit(node: ast.AST, d: int) -> None:
        depth[node] = d
        for child in ast.iter_child_nodes(node):
            nd = d
            if isinstance(node, _LOOPS) and child in node.body + getattr(node, "orelse", []):
                nd = d + 1
            if isinstance(child, (*_FUNCS, ast.Lambda)):
                visit(child, 0)
            else:
                visit(child, nd)

    visit(tree, 0)
    return depth


# ---------------------------------------------------------------------------
# Which expressions are visibly device tensors
# ---------------------------------------------------------------------------

#: Tensor attributes and methods that read host-side metadata: no sync, and
#: the result is not a tensor.
_META_ATTRS = frozenset({
    "shape", "dtype", "device", "ndim", "is_cuda", "is_cpu", "layout",
    "requires_grad", "is_sparse", "itemsize", "nbytes", "names", "type",
    "index",
})
_META_METHODS = frozenset({
    "dim", "size", "numel", "nelement", "element_size", "is_contiguous",
    "data_ptr", "stride", "storage_offset", "get_device", "is_floating_point",
    "is_complex", "is_pinned",
})
#: torch functions that return host values (devices, dtypes, properties,
#: context managers), not tensors.
_HOST_TORCH = frozenset({
    "torch.device", "torch.finfo", "torch.iinfo", "torch.Size",
    "torch.get_default_dtype", "torch.is_tensor", "torch.is_floating_point",
    "torch.promote_types", "torch.result_type", "torch.can_cast",
    "torch.no_grad", "torch.inference_mode", "torch.set_grad_enabled",
    "torch.get_num_threads", "torch.set_num_threads", "torch.manual_seed",
    "torch.Generator",
})
_HOST_TORCH_PREFIXES = ("torch.cuda.", "torch.backends.", "torch.distributed.",
                        "torch.utils.", "torch.testing.", "torch.version.")
#: Device-to-host readouts: the result is a host value.
_READOUT_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})


def _torch_aliases(tree: ast.AST) -> dict[str, str]:
    """Local names bound to torch or one of its modules, with the module
    each stands for: `torch`, `F` → `torch.nn.functional`, `dist` →
    `torch.distributed`, `linalg` → `torch.linalg`."""
    aliases = {"torch": "torch"}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name.split(".")[0] == "torch" and a.asname:
                    aliases[a.asname] = a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module \
                and node.module.split(".")[0] == "torch":
            for a in node.names:
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def _mentions_tensor(ann: ast.AST | None) -> bool:
    return ann is not None and any(
        (isinstance(n, ast.Name) and n.id == "Tensor")
        or (isinstance(n, ast.Attribute) and n.attr == "Tensor")
        for n in ast.walk(ann))


class _DeviceValues:
    """Lexical device-tensor inference over one module: a name holds a
    tensor when it is a `Tensor`-annotated parameter or is assigned from an
    expression that visibly makes one (a torch call, arithmetic or methods
    on a tensor, a module function that returns one).  Metadata reads
    (`.shape`, `.device`, `.dim()`) and readouts (`.item()`) stop the
    inference.  Purely lexical, so the rules that use it fire only where the
    tensor is visible in the function itself."""

    def __init__(self, tree: ast.AST):
        self.aliases = _torch_aliases(tree)
        self.returning: set[str] = set()
        self._names: dict[ast.AST, set[str]] = {}
        fns = [n for n in ast.walk(tree) if isinstance(n, _FUNCS)]
        for fn in fns:
            if _mentions_tensor(fn.returns):
                self.returning.add(fn.name)
        # Module functions that return a tensor make their callers' names
        # tensors too: iterate to a fixed point (the call graph is small).
        for _ in range(4):
            grown = {fn.name for fn in fns if fn.name not in self.returning
                     and any(isinstance(r, ast.Return) and r.value is not None
                             and any(self.is_device(v, fn) for v in (
                                 r.value.elts if isinstance(r.value, ast.Tuple)
                                 else [r.value]))
                             for r in ast.walk(fn))}
            self._names.clear()
            if not grown:
                break
            self.returning |= grown

    def names(self, fn: ast.AST | None) -> set[str]:
        if fn is None:
            return set()
        if fn not in self._names:
            self._names[fn] = self._infer(fn)
        return self._names[fn]

    def _infer(self, fn) -> set[str]:
        a = fn.args
        names = {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs
                 if _mentions_tensor(p.annotation)}
        pairs: list[tuple[ast.AST, ast.AST]] = []
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                pairs.extend((t, node.value) for t in node.targets)
            elif isinstance(node, (ast.AnnAssign, ast.AugAssign)) and node.value is not None:
                pairs.append((node.target, node.value))
            elif isinstance(node, (ast.For, ast.comprehension)):
                pairs.append((node.target, node.iter))
        changed = True
        while changed:
            changed = False
            for target, value in pairs:
                for name in self._bound(target, value, names):
                    if name not in names:
                        names.add(name)
                        changed = True
        return names

    def _bound(self, target, value, names) -> list[str]:
        if isinstance(target, ast.Name):
            return [target.id] if self._dev(value, names) else []
        if isinstance(target, (ast.Tuple, ast.List)):
            if isinstance(value, (ast.Tuple, ast.List)) and len(value.elts) == len(target.elts):
                return [n for t, v in zip(target.elts, value.elts)
                        for n in self._bound(t, v, names)]
            if self._dev(value, names):
                return [t.id for t in target.elts if isinstance(t, ast.Name)]
        return []

    def is_device(self, expr: ast.AST, fn: ast.AST | None) -> bool:
        return self._dev(expr, self.names(fn))

    def torch_name(self, func: ast.AST) -> str | None:
        """The canonical `torch.…` name a call's function spells, through
        the module's import aliases, or None for anything else."""
        fname = _dotted(func)
        if fname is None:
            return None
        root, _, rest = fname.partition(".")
        full = self.aliases.get(root)
        if full is None:
            return None
        return f"{full}.{rest}" if rest else full

    def _dev(self, e: ast.AST, names: set[str]) -> bool:
        if isinstance(e, ast.Name):
            return e.id in names
        if isinstance(e, ast.Call):
            tname = self.torch_name(e.func)
            if tname is not None and tname not in _HOST_TORCH \
                    and not tname.startswith(_HOST_TORCH_PREFIXES):
                return True
            if isinstance(e.func, ast.Name) and e.func.id in self.returning:
                return True
            if isinstance(e.func, ast.Attribute):
                attr = e.func.attr
                return (attr not in _META_METHODS and attr not in _READOUT_METHODS
                        and self._dev(e.func.value, names))
            return False
        if isinstance(e, ast.Attribute):
            return e.attr not in _META_ATTRS and self._dev(e.value, names)
        if isinstance(e, ast.Subscript):
            return self._dev(e.value, names)
        if isinstance(e, ast.BinOp):
            return self._dev(e.left, names) or self._dev(e.right, names)
        if isinstance(e, ast.UnaryOp):
            return self._dev(e.operand, names)
        if isinstance(e, ast.Compare):
            if any(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn)) for op in e.ops):
                return False
            return any(self._dev(x, names) for x in (e.left, *e.comparators))
        if isinstance(e, ast.IfExp):
            return self._dev(e.body, names) or self._dev(e.orelse, names)
        return False


def _enclosing_functions(tree: ast.AST) -> dict[ast.AST, ast.AST | None]:
    """node → the innermost function definition holding it (None at module
    level)."""
    owner: dict[ast.AST, ast.AST | None] = {}

    def visit(node: ast.AST, fn) -> None:
        owner[node] = fn
        for child in ast.iter_child_nodes(node):
            visit(child, child if isinstance(child, _FUNCS) else fn)

    visit(tree, None)
    return owner


# ---------------------------------------------------------------------------
# dict-order-enumeration
# ---------------------------------------------------------------------------

def _module_dicts(tree: ast.AST) -> set[str]:
    """Module-level names bound to dict literals / dict() — the mutable
    registries whose iteration order is registration (import side-effect)
    order."""
    names: set[str] = set()
    body = tree.body if isinstance(tree, ast.Module) else []
    for node in body:
        value = None
        targets: list[ast.expr] = []
        if isinstance(node, ast.Assign):
            value, targets = node.value, node.targets
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            value, targets = node.value, [node.target]
        if value is None:
            continue
        is_dict = isinstance(value, (ast.Dict, ast.DictComp)) or (
            isinstance(value, ast.Call) and _dotted(value.func) == "dict")
        if not is_dict:
            continue
        for t in targets:
            if isinstance(t, ast.Name):
                names.add(t.id)
    return names


def _sorted_wrapped(node: ast.AST, parents: dict[ast.AST, ast.AST]) -> bool:
    """Is `node` (an iteration source) inside a sorted()/sorted-by-key
    normalization — sorted(...), dict(sorted(...)), min/max, len()?"""
    _ORDER_FREE = ("sorted", "len", "min", "max", "set", "frozenset", "sum",
                   "any", "all")
    cur = node
    for _ in range(6):
        parent = parents.get(cur)
        if parent is None:
            return False
        if isinstance(parent, ast.Call):
            fname = _dotted(parent.func)
            if fname in _ORDER_FREE:
                return True
        cur = parent
    return False


@register_rule(
    "dict-order-enumeration",
    packages=TORCH_TARGETS,
    description=("candidate/registry enumeration that iterates a mutable "
                 "module-level dict in insertion (registration) order "
                 "without sorting"),
    rationale=("registration order is an import-side-effect: two processes "
               "importing modules differently enumerate candidates "
               "differently, so autotune tie-breaks, probe budgets, and "
               "persisted winner lists silently diverge between runs"),
    example=("iteration over module-level dict '_REGISTRY' depends on "
             "registration order; wrap in sorted(...)"),
)
def check_dict_order(ctx: FileContext) -> Iterator[Finding]:
    tree = ctx.tree
    dicts = _module_dicts(tree)
    if not dicts:
        return
    parents: dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node

    def source_name(expr: ast.AST) -> str | None:
        """The registry name if `expr` enumerates one order-dependently:
        NAME, NAME.values(), NAME.items(), NAME.keys(), iter(NAME)…"""
        if isinstance(expr, ast.Name) and expr.id in dicts:
            return expr.id
        if isinstance(expr, ast.Call):
            f = expr.func
            if (isinstance(f, ast.Attribute)
                    and f.attr in ("values", "items", "keys")
                    and isinstance(f.value, ast.Name)
                    and f.value.id in dicts):
                return f.value.id
            if (isinstance(f, ast.Name) and f.id in ("iter", "list", "tuple",
                                                     "enumerate")
                    and expr.args):
                return source_name(expr.args[0])
        return None

    sources: list[tuple[ast.AST, str]] = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.For, ast.AsyncFor)):
            name = source_name(node.iter)
            if name:
                sources.append((node.iter, name))
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                               ast.GeneratorExp)):
            for gen in node.generators:
                name = source_name(gen.iter)
                if name:
                    sources.append((gen.iter, name))
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id in ("list", "tuple", "next"):
            # list(_REGISTRY.values()) materializes registration order too
            name = source_name(node)
            if name:
                sources.append((node, name))

    seen: set[tuple[int, str]] = set()
    for expr, name in sources:
        if _sorted_wrapped(expr, parents):
            continue
        key = (expr.lineno, name)
        if key in seen:
            continue
        seen.add(key)
        yield ctx.finding(
            "dict-order-enumeration", expr,
            f"iteration over module-level dict '{name}' depends on "
            "registration (import side-effect) order — wrap the "
            "enumeration in sorted(...) or document why order is "
            "load-bearing")


# ---------------------------------------------------------------------------
# host-sync
# ---------------------------------------------------------------------------

#: torch functions whose result size or error check needs a device value on
#: the host: each call waits for the device.  The linalg ones read their
#: info flag back (torch has no sync-free `pinv`, `svd` or `eigh`).
_SYNC_FUNCTIONS = frozenset(f"torch.{f}" for f in (
    "nonzero", "argwhere", "unique", "unique_consecutive", "masked_select",
    "bincount", "linalg.pinv", "linalg.svd", "linalg.svdvals", "linalg.eigh",
    "linalg.eigvalsh", "linalg.eig", "linalg.eigvals", "linalg.inv",
    "linalg.solve", "linalg.cholesky", "linalg.lstsq", "linalg.matrix_rank",
))
_SYNC_TENSOR_METHODS = frozenset({"nonzero", "unique", "unique_consecutive",
                                  "masked_select", "bincount", "argwhere"})
_HOST_MAKERS = frozenset({"torch.from_numpy", "torch.tensor", "torch.as_tensor"})


def _is_cpu_literal(e: ast.AST) -> bool:
    if isinstance(e, ast.Constant):
        return e.value == "cpu"
    if isinstance(e, ast.Call) and _dotted(e.func) == "torch.device" and e.args:
        return _is_cpu_literal(e.args[0])
    return False


def _is_dtype(e: ast.AST) -> bool:
    """A dtype argument of `.to(...)`: `torch.float32`, `x.dtype`, or a name
    spelled like one."""
    name = _dotted(e) or ""
    leaf = name.split(".")[-1]
    return (name.startswith("torch.") and leaf != "device") or "dtype" in leaf


def _kw(node: ast.Call, name: str) -> ast.AST | None:
    return next((k.value for k in node.keywords if k.arg == name), None)


def _visibly_host(e: ast.AST, dv: _DeviceValues) -> bool:
    """A tensor made in host memory: `torch.from_numpy(...)`, or
    `torch.tensor/as_tensor(...)` with no device."""
    if not isinstance(e, ast.Call):
        return False
    tname = dv.torch_name(e.func)
    return tname in _HOST_MAKERS and (tname == "torch.from_numpy" or _kw(e, "device") is None)


def _host_data(e: ast.AST) -> bool:
    """Data that lives on the host: a list/tuple display or comprehension, or
    a numpy call."""
    if isinstance(e, (ast.List, ast.Tuple, ast.ListComp)):
        return True
    name = _dotted(e.func) if isinstance(e, ast.Call) else _dotted(e)
    return bool(name) and name.split(".")[0] in ("np", "numpy")


def _is_mask(e: ast.AST) -> bool:
    """A boolean-mask index: a comparison, or `~`/`&`/`|` over comparisons."""
    if isinstance(e, ast.Compare):
        return not any(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn)) for op in e.ops)
    if isinstance(e, ast.UnaryOp) and isinstance(e.op, ast.Invert):
        return _is_mask(e.operand)
    if isinstance(e, ast.BinOp) and isinstance(e.op, (ast.BitAnd, ast.BitOr)):
        return _is_mask(e.left) or _is_mask(e.right)
    return False


def _call_line(node: ast.Call) -> int:
    """The line the interpreter reports for a call: a method call's is the
    line of its method name (`obj\\n.to(dev)` reports the `.to` line)."""
    if isinstance(node.func, ast.Attribute):
        return node.func.end_lineno or node.lineno
    return node.lineno


def _host_sync_sites(tree: ast.AST, dv: _DeviceValues) -> Iterator[tuple[ast.AST, int, str, str]]:
    """(node, line, what, direction) for every visible synchronisation."""
    owner = _enclosing_functions(tree)

    def dev(e: ast.AST, node: ast.AST) -> bool:
        return dv.is_device(e, owner.get(node))

    for node in ast.walk(tree):
        if isinstance(node, ast.Subscript) and _is_mask(node.slice) and dev(node.value, node):
            yield node, node.lineno, "boolean-mask indexing", "d2h"
            continue
        if isinstance(node, (ast.If, ast.While, ast.Assert, ast.IfExp)) and dev(node.test, node):
            yield node.test, node.test.lineno, "the truth value of a tensor", "d2h"
            continue
        if not isinstance(node, ast.Call):
            continue
        fname = _dotted(node.func) or ""
        tname = dv.torch_name(node.func) or ""
        attr = node.func.attr if isinstance(node.func, ast.Attribute) else None
        line = _call_line(node)
        if isinstance(node.func, ast.Name) and node.func.id in ("float", "int", "bool") \
                and node.args and dev(node.args[0], node):
            yield node, line, f"`{node.func.id}(...)` over a tensor", "d2h"
        elif fname in ("np.asarray", "np.array", "numpy.asarray", "numpy.array") \
                and node.args and dev(node.args[0], node):
            yield node, line, f"`{fname}(...)` of a tensor", "d2h"
        elif tname in _SYNC_FUNCTIONS:
            yield node, line, f"`{fname}(...)`", "d2h"
        elif tname == "torch.repeat_interleave" and _kw(node, "output_size") is None:
            yield node, line, f"`{fname}(...)` without output_size", "d2h"
        elif tname == "torch.where" and len(node.args) == 1:
            yield node, line, f"one-argument `{fname}(...)`", "d2h"
        elif attr == "synchronize":
            yield node, line, f"`{fname or '.synchronize'}()`", "barrier"
        elif attr == "cpu":
            yield node, line, "`.cpu()`", "d2h"
        elif attr in ("item", "tolist") and dev(node.func.value, node):
            yield node, line, f"`.{attr}()`", "d2h"
        elif attr == "numpy" and dev(node.func.value, node):
            yield node, line, "`.numpy()`", "d2h"
        elif attr in _SYNC_TENSOR_METHODS and dev(node.func.value, node):
            yield node, line, f"`.{attr}()`", "d2h"
        elif attr == "repeat_interleave" and dev(node.func.value, node) \
                and _kw(node, "output_size") is None:
            yield node, line, "`.repeat_interleave()` without output_size", "d2h"
        elif attr == "to":
            target = _kw(node, "device") or next(
                (a for a in node.args if not _is_dtype(a)), None)
            non_blocking = _kw(node, "non_blocking")
            blocking = not (isinstance(non_blocking, ast.Constant) and non_blocking.value is True)
            if target is None:
                continue
            if _is_cpu_literal(target):
                yield node, line, "`.to(\"cpu\")`", "d2h"
            elif blocking and _visibly_host(node.func.value, dv):
                yield node, line, "`.to(device)` of a host tensor", "h2d"
        elif attr == "cuda" and _visibly_host(node.func.value, dv):
            yield node, line, "`.cuda()` of a host tensor", "h2d"
        elif tname in ("torch.tensor", "torch.as_tensor") \
                and _kw(node, "device") is not None \
                and not _is_cpu_literal(_kw(node, "device")) \
                and (tname == "torch.tensor" or (node.args and _host_data(node.args[0]))):
            yield node, line, f"`{fname}(..., device=...)` of host data", "h2d"


@register_rule(
    "host-sync",
    packages=TORCH_TARGETS,
    description=("host-device synchronization on a visibly-torch value: "
                 "float()/int()/bool() or a truth test over a tensor, "
                 ".item()/.tolist()/.cpu()/.numpy()/.to(\"cpu\"), "
                 "np.asarray/np.array of a tensor, a blocking .to(device) "
                 "of a host tensor, torch.cuda.synchronize, and the torch "
                 "ops that read a device value back (nonzero, unique, "
                 "boolean-mask indexing, the checked linalg solvers)"),
    rationale=("each sync stalls the dispatch pipeline; inside the probe/"
               "iteration hot loops one stray float() serializes the "
               "device queue and the measured timings stop measuring the "
               "kernel — on the card the stall is a full drain of the "
               "launch queue (`chip_smoke.py` phase 4y holds this rule to "
               "torch's own sync log)"),
    example=("host sync inside a loop: `float(...)` over a tensor forces a "
             "device→host transfer each iteration"),
)
def check_host_sync(ctx: FileContext) -> Iterator[Finding]:
    tree = ctx.tree
    depth = _loop_depth_map(tree)
    for node, line, what, direction in _host_sync_sites(tree, _DeviceValues(tree)):
        d = depth.get(node, 0)
        where = "inside a loop: " if d else ""
        effect = {"d2h": "forces a device→host transfer",
                  "h2d": "blocks on a host→device copy from pageable memory",
                  "barrier": "waits for every queued kernel"}[direction]
        yield ctx.finding(
            "host-sync", line,
            f"host sync {where}{what} {effect}"
            + ("; hoist it out of the loop or keep the value on device"
               if d else "; keep the reduction on device if this feeds "
               "further computation"))


# ---------------------------------------------------------------------------
# nondeterminism
# ---------------------------------------------------------------------------

#: numpy.random module-level calls that draw from the hidden global state;
#: Generator construction (default_rng/Generator/SeedSequence) and state
#: plumbing are the sanctioned seeded paths.
_NP_RANDOM_OK = ("default_rng", "Generator", "SeedSequence", "PCG64",
                 "Philox", "get_state", "set_state", "seed")
_RANDOM_OK = ("Random", "SystemRandom", "seed", "getstate", "setstate")
#: torch draws from the global generator unless passed `generator=`.
_TORCH_RANDOM = frozenset({
    "rand", "randn", "randint", "randperm", "normal", "bernoulli",
    "multinomial", "poisson", "rand_like", "randn_like", "randint_like",
})
_TORCH_SEEDING = frozenset({"torch.manual_seed", "torch.seed",
                            "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
                            "torch.cuda.seed", "torch.cuda.seed_all"})


@register_rule(
    "nondeterminism",
    packages=("src/repro_torch", "chip_smoke.py"),
    description=("wall-clock or hidden-global-state randomness in product "
                 "code: `time.time()`, module-level `random.*`, legacy "
                 "`np.random.*` (global RNG), torch draws without "
                 "`generator=` and `torch.manual_seed`"),
    rationale=("the sweep/persist pipeline promises exact-fingerprint "
               "resumability and parity gates at 1e-5 — an unseeded draw "
               "or wall-clock dependency anywhere in the data path makes "
               "reruns incomparable and CI flaky; torch's global generator "
               "is process state any import can reseed"),
    example=("`torch.randn(...)` draws from torch's global generator; pass "
             "generator=torch.Generator().manual_seed(seed)"),
)
def check_nondeterminism(ctx: FileContext) -> Iterator[Finding]:
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        fname = _dotted(node.func)
        if fname is None:
            continue
        if fname in ("time.time", "time.time_ns"):
            yield ctx.finding(
                "nondeterminism", node,
                f"`{fname}()` wall clock in product code — timestamps in "
                "persisted/compared data make reruns diverge; use "
                "time.perf_counter() for intervals or thread a timestamp "
                "in from the caller")
        elif fname.startswith("random.") and fname.count(".") == 1:
            leaf = fname.split(".")[1]
            if leaf not in _RANDOM_OK:
                yield ctx.finding(
                    "nondeterminism", node,
                    f"`{fname}()` draws from the process-global `random` "
                    "state — seedless and shared across callers; use "
                    "random.Random(seed) or np.random.default_rng(seed)")
        elif (fname.startswith(("np.random.", "numpy.random."))
                and fname.split(".")[-1] not in _NP_RANDOM_OK):
            yield ctx.finding(
                "nondeterminism", node,
                f"`{fname}(...)` draws from numpy's hidden global RNG; "
                "use np.random.default_rng(seed) so every draw is "
                "reproducible from the workload fingerprint")
        elif fname in _TORCH_SEEDING:
            yield ctx.finding(
                "nondeterminism", node,
                f"`{fname}(...)` reseeds torch's process-global generator — "
                "every other caller's draws change with it; seed a "
                "torch.Generator and pass it as generator=")
        elif (fname.startswith("torch.") and fname.count(".") == 1
                and fname.split(".")[1] in _TORCH_RANDOM
                and _kw(node, "generator") is None):
            yield ctx.finding(
                "nondeterminism", node,
                f"`{fname}(...)` without generator= draws from torch's "
                "process-global generator; pass a seeded torch.Generator "
                "(or draw with np.random.default_rng(seed) on the host)")
