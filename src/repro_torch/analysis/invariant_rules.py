"""Cross-module invariant rules over the port (counterparts of
`repro.analysis.invariant_rules`).

Each pass statically extracts facts from two or more modules and
cross-checks them:

  schema-manifest   — the port's persist.py dataclass field sets vs the
                      pinned `analysis/schema_manifest.json` fingerprint: a
                      field change without a `_SCHEMA_VERSION` bump fails
                      (stores written by either package load in the other,
                      so the port's schema is the reference's).
  byte-terms-arity  — costmodel's `byte_terms` component count vs every
                      arity-typed constant in calibrate's NNLS (design
                      columns, theta slices, coefficient unpack).
  registry-docs     — every registered backend and preset id parses via
                      `parse_candidate` and owns a `docs/torch-candidates.md`
                      anchor; every format owns a `docs/candidates.md`
                      anchor, where `format_table`'s links point.
  import-orphans    — port modules unreachable from `repro_torch/__init__`,
                      `tests/test_torch_*.py` and `chip_smoke.py`, plus the
                      port's isolation: no module of the port (nor
                      chip_smoke.py) imports `jax`, `jaxlib` or `repro`.
"""
from __future__ import annotations

import ast
import json
import re
from collections.abc import Iterator
from pathlib import Path

from .docanchors import extract_anchor_refs, extract_anchors
from .engine import Finding, ProjectContext, register_rule

__all__ = [
    "FORBIDDEN_IMPORTS",
    "SCHEMA_CLASSES",
    "check_byte_terms_arity",
    "check_import_orphans",
    "check_registry_docs",
    "check_schema_manifest",
    "extract_schema",
    "regen_manifest",
]

_PERSIST = "src/repro_torch/engine/persist.py"
_COSTMODEL = "src/repro_torch/engine/costmodel.py"
_CALIBRATE = "src/repro_torch/engine/calibrate.py"
_REGISTRY_PY = "src/repro_torch/engine/registry.py"
_CANDIDATES_DOC = "docs/torch-candidates.md"
_FORMATS_DOC = "docs/candidates.md"
_MANIFEST = "src/repro_torch/analysis/schema_manifest.json"
_PORT = "src/repro_torch"
_SMOKE = "chip_smoke.py"

#: The persisted-schema types whose field sets the manifest pins — the
#: shapes `TuningStore` serializes (see docs/store-schema.md).
SCHEMA_CLASSES = ("WorkloadKey", "StoredEntry", "Observation")

#: Top-level packages no file of the port may import: JAX, and the JAX
#: package (any `import repro.x` runs `repro/__init__`, which loads JAX).
FORBIDDEN_IMPORTS = ("jax", "jaxlib", "repro")


def _dotted(node: ast.AST) -> str | None:
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


# ---------------------------------------------------------------------------
# schema-manifest
# ---------------------------------------------------------------------------

def extract_schema(source: str) -> dict:
    """Static fingerprint of persist.py's schema surface: the declared
    `_SCHEMA_VERSION` and, per schema class, its ordered `field: annotation`
    pairs (order matters — `Observation` is a NamedTuple and `WorkloadKey`
    feeds positional construction in tests)."""
    tree = ast.parse(source)
    version = None
    classes: dict[str, list[str]] = {}
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if (isinstance(t, ast.Name) and t.id == "_SCHEMA_VERSION"
                        and isinstance(node.value, ast.Constant)):
                    version = node.value.value
        elif isinstance(node, ast.ClassDef) and node.name in SCHEMA_CLASSES:
            fields = [
                f"{stmt.target.id}: {ast.unparse(stmt.annotation)}"
                for stmt in node.body
                if isinstance(stmt, ast.AnnAssign)
                and isinstance(stmt.target, ast.Name)
            ]
            classes[node.name] = fields
    return {"schema_version": version, "classes": classes}


def regen_manifest(root: Path) -> dict:
    """Regenerate `analysis/schema_manifest.json` from the live persist.py
    — the intentional-bump workflow: bump `_SCHEMA_VERSION`, run
    `python -m repro_torch.analysis --regen-manifest`, commit both."""
    source = (Path(root) / _PERSIST).read_text(encoding="utf-8")
    manifest = extract_schema(source)
    out = Path(root) / _MANIFEST
    out.write_text(json.dumps(manifest, indent=2) + "\n", encoding="utf-8")
    return manifest


@register_rule(
    "schema-manifest",
    scope="project",
    description=("persist.py schema dataclass field sets must match the "
                 "pinned analysis/schema_manifest.json, and any change must "
                 "arrive with a _SCHEMA_VERSION bump"),
    rationale=("forgetting the version bump makes old stores deserialize "
               "into the new shape with silently-wrong warm lookups — and "
               "the port's stores are read by the JAX package too; this "
               "rule turns that miss into a commit-time failure"),
    example=("WorkloadKey fields changed (added: ['layout: str']) but "
             "_SCHEMA_VERSION is still 5"),
)
def check_schema_manifest(ctx: ProjectContext) -> Iterator[Finding]:
    fc = ctx.file(_PERSIST)
    if fc is None:
        yield ctx.finding("schema-manifest", _PERSIST, 1,
                          "persist.py not found — update the rule if the "
                          "schema moved")
        return
    live = extract_schema(fc.source)
    manifest_path = ctx.root / _MANIFEST
    if not manifest_path.is_file():
        yield ctx.finding(
            "schema-manifest", _MANIFEST, 1,
            "schema manifest missing — run `python -m repro_torch.analysis "
            "--regen-manifest` and commit it")
        return
    try:
        pinned = json.loads(manifest_path.read_text(encoding="utf-8"))
    except json.JSONDecodeError as e:
        yield ctx.finding("schema-manifest", _MANIFEST, 1,
                          f"schema manifest is not valid JSON: {e}")
        return

    live_v, pinned_v = live["schema_version"], pinned.get("schema_version")
    if live["classes"] == pinned.get("classes", {}):
        if live_v != pinned_v:
            yield ctx.finding(
                "schema-manifest", _PERSIST, 1,
                f"_SCHEMA_VERSION is {live_v} but the manifest pins "
                f"{pinned_v} with identical fields — regenerate the "
                "manifest (`--regen-manifest`) so the pin follows the bump")
        return

    for cls in SCHEMA_CLASSES:
        lf = live["classes"].get(cls, [])
        pf = pinned.get("classes", {}).get(cls, [])
        if lf == pf:
            continue
        added = [f for f in lf if f not in pf]
        removed = [f for f in pf if f not in lf]
        delta = []
        if added:
            delta.append(f"added {added}")
        if removed:
            delta.append(f"removed {removed}")
        if not delta:
            delta.append("reordered")
        if live_v == pinned_v:
            yield ctx.finding(
                "schema-manifest", _PERSIST, 1,
                f"{cls} fields changed ({'; '.join(delta)}) but "
                f"_SCHEMA_VERSION is still {live_v} — old stores would "
                "deserialize into the new shape silently; bump the version, "
                "extend _READABLE_VERSIONS/migration, then regenerate the "
                "manifest (`--regen-manifest`)")
        else:
            yield ctx.finding(
                "schema-manifest", _MANIFEST, 1,
                f"{cls} fields changed ({'; '.join(delta)}) and "
                f"_SCHEMA_VERSION moved {pinned_v}→{live_v} — regenerate "
                "the manifest (`--regen-manifest`) to pin the new schema")


# ---------------------------------------------------------------------------
# byte-terms-arity
# ---------------------------------------------------------------------------

def _annotation_arity(fn: ast.FunctionDef) -> int | None:
    """Element count of a `tuple[float, ...]` return annotation."""
    ann = fn.returns
    if (isinstance(ann, ast.Subscript)
            and _dotted(ann.value) in ("tuple", "Tuple")
            and isinstance(ann.slice, ast.Tuple)):
        return len(ann.slice.elts)
    return None


def _tuple_returns(fn: ast.FunctionDef) -> list[tuple[int, int]]:
    """(lineno, element count) for every literal-tuple return in `fn`,
    excluding nested defs."""
    out: list[tuple[int, int]] = []

    def visit(node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            if (isinstance(child, ast.Return)
                    and isinstance(child.value, ast.Tuple)):
                out.append((child.lineno, len(child.value.elts)))
            visit(child)

    visit(fn)
    return out


def _calibrate_arity_sites(tree: ast.AST) -> list[tuple[int, int, str]]:
    """Every place calibrate.py hard-codes the byte-term arity, as
    (lineno, value, what):

      `N + len(backends)`   — design-matrix width / dispatch column base
      `theta[:N]`, `a[i,:N]`— coefficient/row slices
      `a0, …, aK = (… theta[:N])` — the sanitize unpack (count of targets)
    """
    sites: list[tuple[int, int, str]] = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add)
                and isinstance(node.left, ast.Constant)
                and isinstance(node.left.value, int)
                and isinstance(node.right, ast.Call)
                and isinstance(node.right.func, ast.Name)
                and node.right.func.id == "len"):
            sites.append((node.lineno, node.left.value,
                          f"`{ast.unparse(node)}`"))
        elif isinstance(node, ast.Slice):
            if (node.lower is None and node.step is None
                    and isinstance(node.upper, ast.Constant)
                    and isinstance(node.upper.value, int)):
                sites.append((getattr(node.upper, "lineno", 0),
                              node.upper.value, "`[:N]` slice"))
        elif (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Tuple)
                and all(isinstance(t, ast.Name)
                        for t in node.targets[0].elts)
                and any(isinstance(s, ast.Slice)
                        for s in ast.walk(node.value))):
            names = [t.id for t in node.targets[0].elts]
            # Only the coefficient unpack (a0, a1, … pattern), not general
            # tuple assignments.
            if all(n.startswith("a") and n[1:].isdigit() for n in names):
                sites.append((node.lineno, len(names),
                              f"coefficient unpack `{', '.join(names)} = …`"))
    return sites


@register_rule(
    "byte-terms-arity",
    scope="project",
    description=("costmodel.byte_terms component count must equal every "
                 "arity constant in calibrate.py's NNLS (design columns, "
                 "theta slices, coefficient unpack) and every tuple "
                 "return in the byte models"),
    rationale=("a 6th byte term added in costmodel without widening the "
               "design matrix mis-fits every coefficient with no error "
               "anywhere — the fit just quietly learns garbage"),
    example=("calibrate.py:245 `6 + len(backends)` disagrees with "
             "byte_terms arity 5"),
)
def check_byte_terms_arity(ctx: ProjectContext) -> Iterator[Finding]:
    cm = ctx.file(_COSTMODEL)
    cal = ctx.file(_CALIBRATE)
    if cm is None or cal is None:
        missing = _COSTMODEL if cm is None else _CALIBRATE
        yield ctx.finding("byte-terms-arity", missing, 1,
                          "file not found — update the rule if the cost "
                          "model moved")
        return

    fns = {node.name: node for node in ast.walk(cm.tree)
           if isinstance(node, ast.FunctionDef)
           and node.name in ("byte_terms", "device_byte_terms")}
    if "byte_terms" not in fns:
        yield ctx.finding("byte-terms-arity", _COSTMODEL, 1,
                          "byte_terms() not found — update the rule if the "
                          "cost model was renamed")
        return
    arity = _annotation_arity(fns["byte_terms"])
    if arity is None:
        yield ctx.finding(
            "byte-terms-arity", _COSTMODEL, fns["byte_terms"].lineno,
            "byte_terms() has no `tuple[...]` return annotation — the "
            "annotation is the authoritative arity this rule pins; "
            "restore it")
        return

    for name, fn in fns.items():
        ann = _annotation_arity(fn)
        if ann is not None and ann != arity:
            yield ctx.finding(
                "byte-terms-arity", _COSTMODEL, fn.lineno,
                f"{name}() annotates arity {ann} but byte_terms() "
                f"declares {arity}")
        for lineno, n in _tuple_returns(fn):
            if n != arity:
                yield ctx.finding(
                    "byte-terms-arity", _COSTMODEL, lineno,
                    f"{name}() returns a {n}-tuple but the declared "
                    f"byte-term arity is {arity} — every byte model must "
                    "emit every component (pad with 0.0)")

    sites = _calibrate_arity_sites(cal.tree)
    if not sites:
        yield ctx.finding(
            "byte-terms-arity", _CALIBRATE, 1,
            "found no arity-typed constants (`N + len(..)`, `theta[:N]`) "
            "in calibrate.py — update the rule's extraction if the NNLS "
            "was restructured")
        return
    for lineno, value, what in sites:
        if value != arity:
            yield ctx.finding(
                "byte-terms-arity", _CALIBRATE, lineno,
                f"{what} uses arity {value} but costmodel.byte_terms "
                f"declares {arity} — widen the design matrix and the "
                "_sanitize unpack together with the byte model")


# ---------------------------------------------------------------------------
# registry-docs
# ---------------------------------------------------------------------------

def _doc_anchors(ctx: ProjectContext, rel: str) -> dict[str, int] | None:
    doc = ctx.root / rel
    return extract_anchors(doc.read_text(encoding="utf-8")) if doc.is_file() else None


@register_rule(
    "registry-docs",
    scope="project",
    description=("every registered backend/preset id must resolve through "
                 "parse_candidate and own a docs/torch-candidates.md anchor; "
                 "every format owns a docs/candidates.md anchor, and every "
                 "link format_table emits resolves"),
    rationale=("the candidate-id grammar is user-facing API (store files, "
               "sweep configs, engine= strings) — an id the docs can't "
               "anchor or the parser can't round-trip is a silent contract "
               "break; the port's `kernel` backend has no entry in the "
               "reference's docs/candidates.md, so the port keeps its own"),
    example=("backend 'blco' has no `<a id=\"blco\">` anchor in "
             "docs/torch-candidates.md"),
)
def check_registry_docs(ctx: ProjectContext) -> Iterator[Finding]:
    anchors = _doc_anchors(ctx, _CANDIDATES_DOC)
    format_anchors = _doc_anchors(ctx, _FORMATS_DOC)
    for rel, found in ((_CANDIDATES_DOC, anchors), (_FORMATS_DOC, format_anchors)):
        if found is None:
            yield ctx.finding("registry-docs", rel, 1,
                              f"{rel} missing — the candidate-id doc the "
                              "registry anchors point at")
    if anchors is None or format_anchors is None:
        return

    try:
        from repro_torch.engine.registry import (
            parse_candidate,
            preset_candidates,
            registered_backends,
        )
        from repro_torch.formats import format_table, registered_formats
    except Exception as e:  # pragma: no cover - import environment broken
        yield ctx.finding(
            "registry-docs", _CANDIDATES_DOC, 1,
            f"cannot import the live registries ({type(e).__name__}: {e}) "
            "— run the analysis with src/ on PYTHONPATH")
        return

    for name, spec in sorted(registered_backends().items()):
        try:
            parsed, preset = parse_candidate(name)
        except Exception as e:
            yield ctx.finding(
                "registry-docs", _REGISTRY_PY, 1,
                f"registered backend {name!r} does not parse as a "
                f"candidate id: {e}")
            continue
        if (parsed, preset) != (name, None):
            yield ctx.finding(
                "registry-docs", _REGISTRY_PY, 1,
                f"parse_candidate({name!r}) round-trips to "
                f"({parsed!r}, {preset!r}) instead of ({name!r}, None)")
        if name not in anchors:
            yield ctx.finding(
                "registry-docs", _CANDIDATES_DOC, 1,
                f"backend {name!r} has no `<a id=\"{name}\">` anchor in "
                f"{_CANDIDATES_DOC} — document it there")
        for preset_name in spec.presets:
            cand = f"{name}:{preset_name}"
            try:
                parsed, p = parse_candidate(cand)
            except Exception as e:
                yield ctx.finding(
                    "registry-docs", _REGISTRY_PY, 1,
                    f"preset candidate {cand!r} does not parse: {e}")
                continue
            if (parsed, p) != (name, preset_name):
                yield ctx.finding(
                    "registry-docs", _REGISTRY_PY, 1,
                    f"parse_candidate({cand!r}) round-trips to "
                    f"({parsed!r}, {p!r})")
            anchor = f"preset-{preset_name}"
            if anchor not in anchors:
                yield ctx.finding(
                    "registry-docs", _CANDIDATES_DOC, 1,
                    f"preset {cand!r} has no `<a id=\"{anchor}\">` anchor "
                    f"in {_CANDIDATES_DOC}")

    for name in sorted(registered_formats()):
        if name not in format_anchors:
            yield ctx.finding(
                "registry-docs", _FORMATS_DOC, 1,
                f"format {name!r} has no `<a id=\"{name}\">` anchor in "
                f"{_FORMATS_DOC}, where format_table links point")

    # preset_candidates() must only emit parseable ids (the autotuner feeds
    # these straight into build_candidate / store keys).
    for cand in preset_candidates():
        try:
            parse_candidate(cand)
        except Exception as e:
            yield ctx.finding(
                "registry-docs", _REGISTRY_PY, 1,
                f"preset_candidates() emitted unparseable id {cand!r}: {e}")

    # Every anchor link the format table emits must resolve against the doc
    # it names — this is what breaks when someone renames an anchor by hand.
    for target, frag, _line in extract_anchor_refs(format_table()):
        if target == _FORMATS_DOC and frag not in format_anchors:
            yield ctx.finding(
                "registry-docs", _FORMATS_DOC, 1,
                f"format_table() links #{frag} which is not anchored in "
                f"{_FORMATS_DOC}")


# ---------------------------------------------------------------------------
# import-orphans
# ---------------------------------------------------------------------------

def _module_name(rel: str) -> str:
    """src/repro_torch/a/b.py → repro_torch.a.b ;
    src/repro_torch/a/__init__.py → repro_torch.a"""
    parts = Path(rel).with_suffix("").parts
    parts = parts[parts.index("repro_torch"):]
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


_STR_IMPORT_RE = re.compile(
    r"^\s*(?:from\s+(repro_torch[\w.]*)\s+import"
    r"|import\s+(repro_torch[\w.]*(?:\s*,\s*repro_torch[\w.]*)*))",
    re.MULTILINE)


def _is_pkg(module: str, known: set[str]) -> bool:
    return any(m.startswith(module + ".") for m in known)


def _import_edges(tree: ast.AST, module: str, known: set[str]) -> set[str]:
    """Modules under `repro_torch` that `module`'s source imports.  Handles
    absolute and relative imports, and import statements inside string
    literals (the code that tests hand to child interpreters)."""
    pkg_parts = module.split(".")
    edges: set[str] = set()

    def add(name: str) -> None:
        # Resolve to the closest known module: `from repro_torch.engine
        # import build_engine` names an attr, not a module — strip trailing
        # parts until something in `known` matches.
        parts = name.split(".")
        while parts:
            cand = ".".join(parts)
            if cand in known:
                edges.add(cand)
                return
            parts = parts[:-1]

    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.split(".")[0] == "repro_torch":
                    add(alias.name)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                # relative: level=1 is the containing package
                base = pkg_parts[:len(pkg_parts) - node.level + 1] \
                    if module in known and _is_pkg(module, known) \
                    else pkg_parts[:len(pkg_parts) - node.level]
                prefix = ".".join(base + ([node.module] if node.module else []))
            else:
                prefix = node.module or ""
            if prefix.split(".")[0] == "repro_torch":
                add(prefix)
                for alias in node.names:
                    add(f"{prefix}.{alias.name}")
        elif (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and "repro_torch" in node.value and "import" in node.value):
            for m in _STR_IMPORT_RE.finditer(node.value):
                for name in (m.group(1) or m.group(2)).split(","):
                    add(name.strip())
    edges.discard(module)
    return edges


def _forbidden_imports(tree: ast.AST) -> list[tuple[int, str]]:
    """(line, module) of every import of JAX or the JAX package, including
    `importlib.import_module("...")` with a literal name."""
    hits: list[tuple[int, str]] = []
    for node in ast.walk(tree):
        names: list[str] = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        elif (isinstance(node, ast.Call)
                and _dotted(node.func) in ("importlib.import_module", "import_module")
                and node.args and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)):
            names = [node.args[0].value]
        hits.extend((node.lineno, n) for n in names
                    if n.split(".")[0] in FORBIDDEN_IMPORTS)
    return hits


@register_rule(
    "import-orphans",
    scope="project",
    description=("port modules unreachable from repro_torch/__init__, "
                 "tests/test_torch_*.py and chip_smoke.py; plus the port's "
                 "isolation — no file of the port imports jax, jaxlib or "
                 "repro"),
    rationale=("orphans are unreviewed, untested dead weight; and the port "
               "must run where JAX is absent — any `import repro.x` runs "
               "the JAX package's __init__, which loads JAX (the static twin "
               "of tests/test_torch_isolation.py)"),
    example=("src/repro_torch/core/old.py (repro_torch.core.old) is "
             "unreachable from repro_torch/__init__, tests/test_torch_*.py, "
             "chip_smoke.py"),
)
def check_import_orphans(ctx: ProjectContext) -> Iterator[Finding]:
    modules = {_module_name(fc.rel): fc for fc in ctx.walk(_PORT)}
    known = set(modules)

    edges: dict[str, set[str]] = {}
    for mod, fc in modules.items():
        try:
            edges[mod] = _import_edges(fc.tree, mod, known)
        except SyntaxError:
            edges[mod] = set()
        # Importing a submodule imports its ancestor packages (their
        # __init__ side effects run).
        for dep in set(edges[mod]):
            parts = dep.split(".")
            for i in range(1, len(parts)):
                anc = ".".join(parts[:i])
                if anc in known:
                    edges[mod].add(anc)

    roots: set[str] = {"repro_torch"} & known
    # `python -m repro_torch.x` entrypoints are roots by construction:
    # nothing imports a __main__ module, it is invoked.
    roots |= {m for m in known if m.endswith(".__main__")}
    tests = sorted(p.relative_to(ctx.root).as_posix()
                   for p in (ctx.root / "tests").glob("test_torch_*.py"))
    externals = list(ctx.walk(*tests, _SMOKE))
    for fc in externals:
        try:
            roots |= _import_edges(fc.tree, f"_ext.{fc.rel}", known)
        except SyntaxError:
            continue
    for dep in set(roots):
        parts = dep.split(".")
        for i in range(1, len(parts)):
            anc = ".".join(parts[:i])
            if anc in known:
                roots.add(anc)

    reachable: set[str] = set()
    stack = sorted(roots)
    while stack:
        mod = stack.pop()
        if mod in reachable:
            continue
        reachable.add(mod)
        stack.extend(edges.get(mod, ()))

    for mod in sorted(known - reachable):
        yield ctx.finding(
            "import-orphans", modules[mod].rel, 1,
            f"{mod} is unreachable from repro_torch/__init__, "
            "tests/test_torch_*.py and chip_smoke.py — delete it or add it "
            "to the supported surface")

    # Isolation: nothing the port ships imports JAX or the JAX package.
    for fc in [*(modules[m] for m in sorted(modules)),
               *(fc for fc in externals if fc.rel == _SMOKE)]:
        try:
            hits = _forbidden_imports(fc.tree)
        except SyntaxError:
            continue
        for line, name in hits:
            yield ctx.finding(
                "import-orphans", fc.rel, line,
                f"{fc.rel} imports {name} — the port must not import JAX or "
                "the JAX package `repro` (it runs where JAX is absent; keep "
                "a copy of any numpy-only code it needs)")
