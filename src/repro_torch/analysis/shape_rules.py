"""Kernel signature contracts over `kernels/` + `core/mttkrp.py` (the
signature half of `repro.analysis.shape_rules`).

The public MTTKRP surface is called by keyword from every engine backend,
the autotuner and `chip_smoke.py`.  `kernel_contracts.json` pins each
public function's signature (mirroring `schema_manifest.json`):

  kernel-contract-drift — the pinned signatures vs the live ASTs: a
      renamed kwarg, a new positional arg or a vanished function fails
      until `--regen-contracts` re-pins it (making API drift a reviewed
      diff, like the persist schema).

Every entry carries `"params": null` and `"returns": null`: signature-pinned
only.  The shape contract the reference proves by abstract interpretation
(`kernel-shape-contract`: every variant returns `(dims[mode], rank)` with the
pinned dtype) needs an interpreter over torch ops and fills those fields.
"""
from __future__ import annotations

import ast
import json
from pathlib import Path

from .engine import ProjectContext, register_rule

__all__ = [
    "CONTRACT_MODULES",
    "check_kernel_contract_drift",
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
)


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
    rule reports that)."""
    p = Path(root) / _CONTRACTS
    if not p.is_file():
        return None
    try:
        data = json.loads(p.read_text(encoding="utf-8"))
    except json.JSONDecodeError:
        return None
    return data if isinstance(data, dict) else None


def regen_contracts(root: Path) -> dict:
    """Re-pin the signature blocks from the live ASTs, keeping the other
    fields of surviving functions and dropping entries for vanished ones —
    the intentional-drift workflow: change the API, run `python -m
    repro_torch.analysis --regen-contracts`, review + commit the JSON diff
    (new functions arrive with `"params": null`, signature-pinned only)."""
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
            entry = dict(old.get(key) or {"params": None, "returns": None})
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
