"""`python -m repro_torch.analysis` — run the port's static-analysis pass suite.

Exit codes: 0 clean, 1 findings, 2 usage/setup error (mirrors the
benchmark CLIs' convention).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .engine import default_root, registered_rules, rule_table, run_analysis
from .invariant_rules import regen_manifest
from .sarif import to_sarif
from .shape_rules import regen_contracts


def _baseline_key(f: dict) -> tuple:
    # Keyed without the line number: a baseline must survive unrelated
    # edits shifting a known finding up or down the file.
    return (f["rule"], f["path"], f["message"])


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="PyTorch hot-path hygiene, cross-module invariant, and "
                    "kernel-contract/width checks over the port "
                    "(see docs/torch-static-analysis.md)")
    ap.add_argument("--strict", action="store_true",
                    help="also fail on suppression hygiene: unknown rule "
                         "ids in disables, missing reasons, unused "
                         "suppressions (the CI gate)")
    ap.add_argument("--format", choices=("human", "json", "sarif"),
                    default=None,
                    help="report format (default: human)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="alias for --format json")
    ap.add_argument("--root", type=Path, default=None,
                    help="repo root (default: inferred from the installed "
                         "package location)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule ids to run (default: all)")
    ap.add_argument("--tier", choices=("syntactic", "dataflow", "all"),
                    default="all",
                    help="run only one rule tier: 'syntactic' is the "
                         "cheap per-node pass, 'dataflow' the kernel-contract "
                         "and integer-width pass (default: all)")
    ap.add_argument("--baseline", type=Path, default=None,
                    help="JSON report of accepted findings (from "
                         "--write-baseline); only findings NOT in it fail "
                         "the run — lets a new rule family land before "
                         "every legacy finding is fixed")
    ap.add_argument("--write-baseline", type=Path, default=None,
                    help="write the current findings to FILE as a baseline "
                         "and exit 0")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    ap.add_argument("--regen-manifest", action="store_true",
                    help="regenerate analysis/schema_manifest.json from "
                         "the live persist.py (the intentional-bump "
                         "workflow) and exit")
    ap.add_argument("--regen-contracts", action="store_true",
                    help="re-pin analysis/kernel_contracts.json signatures "
                         "from the live kernel ASTs (the intentional "
                         "API-drift workflow) and exit")
    args = ap.parse_args(argv)

    fmt = args.format or ("json" if args.as_json else "human")

    root = args.root if args.root is not None else default_root()
    if not (root / "src" / "repro_torch").is_dir():
        print(f"error: {root} does not look like the repo root "
              "(no src/repro_torch/) — pass --root", file=sys.stderr)
        return 2

    if args.list_rules:
        print(rule_table(docs_base=None))
        return 0

    if args.regen_manifest:
        manifest = regen_manifest(root)
        print(f"wrote src/repro_torch/analysis/schema_manifest.json "
              f"(schema_version={manifest['schema_version']}, "
              f"{len(manifest['classes'])} classes)")
        return 0

    if args.regen_contracts:
        contracts = regen_contracts(root)
        print(f"wrote src/repro_torch/analysis/kernel_contracts.json "
              f"({len(contracts['functions'])} functions)")
        return 0

    rules = None
    if args.rules:
        rules = [r.strip() for r in args.rules.split(",") if r.strip()]
        unknown = [r for r in rules if r not in registered_rules()]
        if unknown:
            print(f"error: unknown rule id(s) {unknown}; see --list-rules",
                  file=sys.stderr)
            return 2
        # Keep project/file rules as named; meta checks always apply.
        rules = [r for r in rules
                 if registered_rules()[r].scope in ("file", "project")]

    result = run_analysis(root, rules=rules, tier=args.tier,
                          strict=args.strict)

    if args.write_baseline is not None:
        payload = {"findings": [f.to_json() for f in result.findings]}
        args.write_baseline.write_text(
            json.dumps(payload, indent=2) + "\n", encoding="utf-8")
        print(f"wrote baseline {args.write_baseline} "
              f"({len(result.findings)} finding(s))")
        return 0

    new = result.findings
    if args.baseline is not None:
        try:
            recorded = json.loads(args.baseline.read_text(encoding="utf-8"))
        except (OSError, json.JSONDecodeError) as e:
            print(f"error: cannot read baseline {args.baseline}: {e}",
                  file=sys.stderr)
            return 2
        known = {_baseline_key(f) for f in recorded.get("findings", [])}
        new = [f for f in result.findings
               if _baseline_key(f.to_json()) not in known]

    if fmt == "json":
        report = result.to_json()
        if args.baseline is not None:
            report["counts"]["new"] = len(new)
            report["new_findings"] = [f.to_json() for f in new]
        print(json.dumps(report, indent=2))
    elif fmt == "sarif":
        print(json.dumps(to_sarif(result), indent=2))
    else:
        print(result.human())
        if args.baseline is not None and result.findings:
            print(f"-- baseline: {len(result.findings) - len(new)} known, "
                  f"{len(new)} new")

    return 0 if not new else 1


if __name__ == "__main__":
    sys.exit(main())
