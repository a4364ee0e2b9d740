"""Repo-aware static-analysis pass engine for the PyTorch/CUDA port: rule
registry + suppression + reporting (the port's own copy of
`repro.analysis.engine`, which the port may not import).

The port rests on invariants no stock linter checks: the persist schema
version must move with the persist dataclasses, the cost model's byte-term
arity must match the calibration design matrix, the Alg.-2 shifts must stay
in the fixed-point inner loops (the CUDA one included), and the kernel and
engine hot paths must not hide a host-device synchronisation.  Rules plug
into one registry (same register/lookup/table idiom as
`repro_torch.engine.registry`), and every consumer (`python -m
repro_torch.analysis`, the pytest gate, `chip_smoke.py`) goes through one
`run_analysis` API.

Rule kinds:

  file     — an AST pass over one Python file (`check(ctx: FileContext)`);
             the engine walks every file under the rule's declared
             `packages` prefixes (default: all of `src/repro_torch`).
  project  — a whole-repo pass (`check(ctx: ProjectContext)`) for
             cross-module invariants: schema manifests, arity cross-checks,
             registry/docs agreement, import-graph reachability, the CUDA
             source's shifts.
  meta     — engine-built-in checks (suppression hygiene); registered so
             their ids are documented and valid suppression targets, but
             the engine itself runs them.

The suite walks `src/repro_torch` and `chip_smoke.py` only; the JAX package
`src/repro` has its own suite (`python -m repro.analysis`).

Suppression — every finding can be waived *in the file it fires in*:

  x = float(y)  # repro-lint: disable=host-sync -- reason why this is fine
  # repro-lint: disable=host-sync -- applies to the NEXT line
  # repro-lint: disable-file=nondeterminism -- whole-file waiver

The rule-id list is comma-separated; the reason string after ``--`` (or an
em-dash, or ``:``) is required under ``--strict``, and ``--strict`` also
fails on suppressions naming unknown rule ids (stale disables left behind
by a rule rename) and on suppressions that no longer match any finding.
"""
from __future__ import annotations

import ast
import dataclasses
import io
import json
import os
import re
import tokenize
from collections.abc import Callable, Iterable
from pathlib import Path

__all__ = [
    "AnalysisResult",
    "FileContext",
    "Finding",
    "ProjectContext",
    "RuleSpec",
    "Suppression",
    "check_source",
    "default_root",
    "get_rule",
    "register_rule",
    "registered_rules",
    "rule_table",
    "run_analysis",
]

#: Repo-relative package prefixes the file rules default to: the port, never
#: the JAX package.  Rules can widen (`chip_smoke.py`) or narrow via
#: `packages=`.
DEFAULT_FILE_TARGETS = ("src/repro_torch",)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a (file, line)."""

    rule: str
    path: str                   # repo-relative, posix separators
    line: int
    message: str
    suppressed: bool = False
    reason: str | None = None   # suppression reason, when suppressed

    def to_json(self) -> dict:
        d = {"rule": self.rule, "path": self.path, "line": self.line,
             "message": self.message}
        if self.suppressed:
            d["suppressed"] = True
            d["reason"] = self.reason
        return d

    def render(self) -> str:
        tag = " [suppressed]" if self.suppressed else ""
        return f"{self.path}:{self.line}: {self.rule}: {self.message}{tag}"


@dataclasses.dataclass(frozen=True)
class RuleSpec:
    """Capability declaration for one registered analysis pass.

    scope      — "file" (per-file AST pass), "project" (whole-repo
                 invariant), or "meta" (engine-built-in).
    tier       — "syntactic" (cheap per-node passes, every PR) or
                 "dataflow" (abstract-interpretation passes; same CI job,
                 separate timed step).  Meta rules ignore tier.
    packages   — repo-relative path prefixes a file rule walks; () means
                 the engine default (`DEFAULT_FILE_TARGETS`).
    rationale  — why the rule exists (rendered into
                 docs/torch-static-analysis.md by `rule_table`).
    example    — one illustrative finding message for the docs.
    """

    name: str
    check: Callable | None
    scope: str = "file"
    tier: str = "syntactic"
    packages: tuple[str, ...] = ()
    description: str = ""
    rationale: str = ""
    example: str = ""


_RULES: dict[str, RuleSpec] = {}

_ID_RE = re.compile(r"^[a-z][a-z0-9]*(-[a-z0-9]+)*$")


def register_rule(
    name: str,
    *,
    scope: str = "file",
    tier: str = "syntactic",
    packages: tuple[str, ...] = (),
    description: str = "",
    rationale: str = "",
    example: str = "",
):
    """Decorator registering a check under `name` (last wins, so tests and
    downstream code can override a rule — same policy as the backend
    registry)."""
    if not _ID_RE.match(name):
        raise ValueError(
            f"rule id {name!r} must be kebab-case ([a-z0-9-]) — ids appear "
            "in suppression comments and docs anchors")
    if scope not in ("file", "project", "meta"):
        raise ValueError(f"unknown rule scope {scope!r}")
    if tier not in ("syntactic", "dataflow"):
        raise ValueError(f"unknown rule tier {tier!r}")

    def deco(check: Callable | None) -> Callable | None:
        _RULES[name] = RuleSpec(
            name=name, check=check, scope=scope, tier=tier,
            packages=tuple(packages),
            description=description, rationale=rationale, example=example)
        return check
    return deco


def get_rule(name: str) -> RuleSpec:
    try:
        return _RULES[name]
    except KeyError:
        raise ValueError(
            f"unknown rule {name!r}; registered: {sorted(_RULES)}") from None


def registered_rules() -> dict[str, RuleSpec]:
    """Registered rules in id order (never registration order: the listing
    feeds docs and reports, which must not depend on import side-effect
    ordering)."""
    return {name: _RULES[name] for name in sorted(_RULES)}


#: The rule catalog every report and rule-table link points at.
DOCS_BASE = "docs/torch-static-analysis.md"


def rule_table(docs_base: str | None = DOCS_BASE) -> str:
    """Markdown catalog of the registered rules (used by the docs and
    `--list-rules`).  Each rule row anchors to its section of
    `docs/torch-static-analysis.md`; pass ``docs_base=None`` for plain
    terminal output."""
    def _name(n: str) -> str:
        return f"[`{n}`]({docs_base}#{n})" if docs_base else f"`{n}`"

    rows = [
        "| rule | scope | description |",
        "|------|-------|-------------|",
    ]
    for spec in registered_rules().values():
        rows.append(f"| {_name(spec.name)} | {spec.scope} | {spec.description} |")
    return "\n".join(rows)


# ---------------------------------------------------------------------------
# Suppressions
# ---------------------------------------------------------------------------

_SUPPRESS_RE = re.compile(
    r"#\s*repro-lint:\s*(?P<kind>disable-file|disable)\s*=\s*"
    r"(?P<rules>[A-Za-z0-9_,\- ]+?)"
    r"(?:\s*(?:--|—|:)\s*(?P<reason>.*\S))?\s*$")


@dataclasses.dataclass(frozen=True)
class Suppression:
    """One parsed `# repro-lint:` comment."""

    path: str
    line: int
    rules: tuple[str, ...]
    scope: str               # "line" | "file"
    reason: str | None
    own_line: bool           # comment-only line: also covers the next line

    def covers(self, f: Finding) -> bool:
        if f.path != self.path or f.rule not in self.rules:
            return False
        if self.scope == "file":
            return True
        return f.line == self.line or (self.own_line and f.line == self.line + 1)


def parse_suppressions(source: str, rel: str) -> list[Suppression]:
    """Extract suppressions from real COMMENT tokens (a `# repro-lint:`
    inside a string literal must not waive anything)."""
    out: list[Suppression] = []
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except (tokenize.TokenError, SyntaxError, IndentationError):
        return out
    line_has_code: dict[int, bool] = {}
    for tok in tokens:
        if tok.type in (tokenize.COMMENT, tokenize.NL, tokenize.NEWLINE,
                        tokenize.INDENT, tokenize.DEDENT, tokenize.ENDMARKER):
            continue
        for ln in range(tok.start[0], tok.end[0] + 1):
            line_has_code[ln] = True
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _SUPPRESS_RE.search(tok.string)
        if not m:
            continue
        rules = tuple(sorted({r.strip() for r in m.group("rules").split(",")
                              if r.strip()}))
        if not rules:
            continue
        out.append(Suppression(
            path=rel, line=tok.start[0], rules=rules,
            scope="file" if m.group("kind") == "disable-file" else "line",
            reason=m.group("reason"),
            own_line=not line_has_code.get(tok.start[0], False)))
    return out


# ---------------------------------------------------------------------------
# Contexts
# ---------------------------------------------------------------------------

class FileContext:
    """One parsed source file, handed to file-scope rules."""

    def __init__(self, root: Path, path: Path):
        self.root = Path(root)
        self.path = Path(path)
        self.rel = self.path.relative_to(self.root).as_posix()
        self.source = self.path.read_text(encoding="utf-8")
        self._tree: ast.AST | None = None
        self._parse_error: SyntaxError | None = None

    @classmethod
    def from_source(cls, source: str, rel: str,
                    root: str | Path = ".") -> FileContext:
        """Build a context from an in-memory snippet (the fixture-test
        path) without touching the filesystem."""
        ctx = cls.__new__(cls)
        ctx.root = Path(root)
        ctx.path = Path(root) / rel
        ctx.rel = rel
        ctx.source = source
        ctx._tree = None
        ctx._parse_error = None
        return ctx

    @property
    def tree(self) -> ast.AST:
        if self._tree is None:
            self._tree = ast.parse(self.source, filename=self.rel)
        return self._tree

    def finding(self, rule: str, node: ast.AST | int, message: str) -> Finding:
        line = node if isinstance(node, int) else getattr(node, "lineno", 1)
        return Finding(rule=rule, path=self.rel, line=line, message=message)


class ProjectContext:
    """The whole repo, handed to project-scope rules."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self._files: dict[str, FileContext] = {}

    def file(self, rel: str) -> FileContext | None:
        """The parsed file at repo-relative `rel`, or None when absent —
        project rules degrade to a finding, not a crash, on a moved file."""
        if rel not in self._files:
            p = self.root / rel
            self._files[rel] = FileContext(self.root, p) if p.is_file() else None
        return self._files[rel]

    def walk(self, *prefixes: str) -> Iterable[FileContext]:
        """Every .py file under the repo-relative `prefixes`, sorted."""
        seen: set[str] = set()
        for prefix in prefixes:
            base = self.root / prefix
            if not base.exists():
                continue
            paths = [base] if base.is_file() else sorted(base.rglob("*.py"))
            for p in paths:
                rel = p.relative_to(self.root).as_posix()
                if rel not in seen:
                    seen.add(rel)
                    fc = self.file(rel)
                    if fc is not None:
                        yield fc

    def finding(self, rule: str, rel: str, line: int, message: str) -> Finding:
        return Finding(rule=rule, path=rel, line=line, message=message)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AnalysisResult:
    """Everything one `run_analysis` pass produced."""

    root: str
    n_files: int
    findings: list[Finding]              # active (unsuppressed), sorted
    suppressed: list[Finding]            # waived findings, with reasons
    unused_suppressions: list[Suppression]
    rules: tuple[str, ...]               # rule ids that ran
    strict: bool = False

    @property
    def ok(self) -> bool:
        return not self.findings

    def to_json(self) -> dict:
        return {
            "root": self.root,
            "strict": self.strict,
            "n_files": self.n_files,
            "rules": list(self.rules),
            "counts": {
                "active": len(self.findings),
                "suppressed": len(self.suppressed),
                "unused_suppressions": len(self.unused_suppressions),
            },
            "findings": [f.to_json() for f in self.findings],
            "suppressed": [f.to_json() for f in self.suppressed],
            "unused_suppressions": [
                {"path": s.path, "line": s.line, "rules": list(s.rules),
                 "scope": s.scope, "reason": s.reason}
                for s in self.unused_suppressions],
        }

    def human(self) -> str:
        lines = [f.render() for f in self.findings]
        if self.suppressed:
            lines.append(f"-- {len(self.suppressed)} finding(s) suppressed:")
            lines.extend(
                f"   {f.path}:{f.line}: {f.rule} ({f.reason or 'no reason'})"
                for f in self.suppressed)
        verdict = "clean" if self.ok else f"{len(self.findings)} finding(s)"
        lines.append(
            f"repro_torch.analysis: {verdict} over {self.n_files} file(s), "
            f"{len(self.rules)} rule(s)"
            + (" [strict]" if self.strict else ""))
        return "\n".join(lines)


def default_root() -> Path:
    """The repo root this installed `repro_torch` package belongs to: the
    parent of the `src/` directory holding `repro_torch/`.  Works for the editable /
    PYTHONPATH=src layouts this repo uses; pass an explicit root (CLI
    `--root`) for anything more exotic."""
    here = Path(__file__).resolve()          # .../src/repro_torch/analysis/engine.py
    src = here.parents[2]                    # .../src
    return src.parent if src.name == "src" else src


def _sort_key(f: Finding) -> tuple:
    return (f.path, f.line, f.rule, f.message)


def _rule_targets(spec: RuleSpec) -> tuple[str, ...]:
    return spec.packages or DEFAULT_FILE_TARGETS


def run_analysis(
    root: str | os.PathLike | None = None,
    *,
    rules: Iterable[str] | None = None,
    tier: str = "all",
    strict: bool = False,
) -> AnalysisResult:
    """Run the registered passes over the repo at `root`.

    `rules` restricts to a subset of rule ids (meta checks always run);
    `tier` restricts to one rule tier ("syntactic" | "dataflow" | "all") so
    CI can time the cheap per-node passes and the abstract-interpretation
    passes as separate steps; `strict` additionally enforces suppression
    hygiene: unknown rule ids in suppression comments, suppressions without
    a reason string, and suppressions that no longer match any finding all
    become findings.
    """
    if tier not in ("syntactic", "dataflow", "all"):
        raise ValueError(f"unknown tier {tier!r}")
    root = Path(root) if root is not None else default_root()
    selected = (registered_rules() if rules is None
                else {n: get_rule(n) for n in rules})
    if tier != "all":
        selected = {n: s for n, s in selected.items()
                    if s.tier == tier or s.scope == "meta"}
    project = ProjectContext(root)

    raw: list[Finding] = []
    suppressions: list[Suppression] = []
    files_seen: set[str] = set()

    file_rules = [s for s in selected.values() if s.scope == "file"]
    targets: dict[str, list[RuleSpec]] = {}
    for spec in file_rules:
        for fc in project.walk(*_rule_targets(spec)):
            targets.setdefault(fc.rel, []).append(spec)

    for rel in sorted(targets):
        fc = project.file(rel)
        files_seen.add(rel)
        try:
            fc.tree
        except SyntaxError as e:
            raw.append(Finding(rule="syntax-error", path=rel,
                               line=e.lineno or 1,
                               message=f"file does not parse: {e.msg}"))
            continue
        suppressions.extend(parse_suppressions(fc.source, rel))
        for spec in targets[rel]:
            raw.extend(spec.check(fc))

    for spec in (s for s in selected.values() if s.scope == "project"):
        raw.extend(spec.check(project))
        # Project-rule findings land in files the file rules may not have
        # walked (docs, json manifests, …) — collect their suppressions too.
        for f in raw:
            if f.path not in files_seen and f.path.endswith(".py"):
                fc = project.file(f.path)
                if fc is not None:
                    files_seen.add(f.path)
                    suppressions.extend(parse_suppressions(fc.source, f.path))

    # -- suppression hygiene (meta rules) ----------------------------------
    known = set(_RULES) | {"syntax-error"}
    if strict:
        for s in suppressions:
            stale = [r for r in s.rules if r not in known]
            if stale:
                raw.append(Finding(
                    rule="unknown-suppression", path=s.path, line=s.line,
                    message=(f"suppression names unregistered rule id(s) "
                             f"{stale} — stale disable? registered ids: "
                             f"run `python -m repro_torch.analysis --list-rules`")))
            if not s.reason:
                raw.append(Finding(
                    rule="suppression-missing-reason", path=s.path,
                    line=s.line,
                    message=("suppression has no reason string — append "
                             "`-- <why this is safe>`")))

    # -- apply suppressions ------------------------------------------------
    active: list[Finding] = []
    waived: list[Finding] = []
    used: set[Suppression] = set()
    for f in raw:
        hit = next((s for s in suppressions if s.covers(f)), None)
        if hit is not None and f.rule not in (
                "unknown-suppression", "suppression-missing-reason"):
            used.add(hit)
            waived.append(dataclasses.replace(
                f, suppressed=True, reason=hit.reason))
        else:
            active.append(f)

    unused = [s for s in suppressions if s not in used]
    if strict:
        for s in unused:
            # Only judge a waiver against rules that actually ran this
            # pass: under `--rules`/`--tier` subsets a suppression for an
            # unselected rule cannot match anything and is not stale.
            if not any(r in selected for r in s.rules):
                continue
            # A waiver matching nothing is a stale disable: either the code
            # was fixed (delete the comment) or the rule id drifted.
            active.append(Finding(
                rule="unused-suppression", path=s.path, line=s.line,
                message=(f"suppression for {list(s.rules)} matches no "
                         "finding — the waived code is gone; delete the "
                         "comment")))

    return AnalysisResult(
        root=str(root), n_files=len(files_seen),
        findings=sorted(active, key=_sort_key),
        suppressed=sorted(waived, key=_sort_key),
        unused_suppressions=sorted(unused, key=lambda s: (s.path, s.line)),
        rules=tuple(sorted(selected)), strict=strict)


def check_source(rule: str, source: str,
                 rel: str = "src/repro_torch/core/fixture.py") -> list[Finding]:
    """Run one file rule over an in-memory snippet — the fixture-test
    entrypoint (`tests/test_torch_analysis.py` proves every rule fires on
    its bad fixture and stays quiet on the good one)."""
    spec = get_rule(rule)
    if spec.scope != "file":
        raise ValueError(f"rule {rule!r} is {spec.scope}-scope; "
                         "check_source only drives file rules")
    ctx = FileContext.from_source(source, rel)
    findings = list(spec.check(ctx))
    sup = parse_suppressions(source, rel)
    return [f for f in findings if not any(s.covers(f) for s in sup)]


# -- meta rules: registered for documentation + suppression-id validity ----

register_rule(
    "unknown-suppression", scope="meta",
    description="a `# repro-lint:` comment names a rule id that is not registered",
    rationale=("a rule rename must not leave silent, stale disables behind "
               "— strict mode fails on them"),
    example="suppression names unregistered rule id(s) ['host-snyc']",
)(None)
register_rule(
    "suppression-missing-reason", scope="meta",
    description="a suppression comment carries no `-- reason` string",
    rationale=("a waiver without a recorded why cannot be audited when the "
               "card makes these hazards expensive"),
    example="suppression has no reason string",
)(None)
register_rule(
    "unused-suppression", scope="meta",
    description="a suppression comment matches no finding (strict mode)",
    rationale="fixed code should drop its waiver, not fossilize it",
    example="suppression for ['host-sync'] matches no finding",
)(None)
register_rule(
    "syntax-error", scope="meta",
    description="a walked file does not parse",
    rationale="every other pass is meaningless on a broken tree",
    example="file does not parse: invalid syntax",
)(None)
