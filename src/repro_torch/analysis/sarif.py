"""SARIF 2.1.0 reporter for the port's analysis suite (a copy of
`repro.analysis.sarif`; only the tool name and the docs base differ).

SARIF (Static Analysis Results Interchange Format) is what GitHub code
scanning ingests: uploading one from CI turns every finding into an
inline PR annotation at the offending line, with the rule's description
and docs link attached — the same report the `--json`/human reporters
print, re-shaped to the OASIS schema.

Only active (unsuppressed) findings are emitted.  Suppressed findings
carry an in-tree waiver with a reason already; re-surfacing them as
annotations would just teach people to ignore the annotations.
"""
from __future__ import annotations

from .engine import DOCS_BASE, AnalysisResult, registered_rules

__all__ = ["to_sarif"]

_SARIF_VERSION = "2.1.0"
_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/"
           "Schemata/sarif-schema-2.1.0.json")


def to_sarif(result: AnalysisResult) -> dict:
    """Render one analysis pass as a single-run SARIF log."""
    specs = registered_rules()
    rule_ids = sorted({f.rule for f in result.findings} | set(result.rules))
    rules = []
    for rid in rule_ids:
        spec = specs.get(rid)
        rule: dict = {"id": rid}
        if spec is not None and spec.description:
            rule["shortDescription"] = {"text": spec.description}
            if spec.rationale:
                rule["fullDescription"] = {"text": spec.rationale}
        rule["helpUri"] = f"{DOCS_BASE}#{rid}"
        rules.append(rule)
    index = {r["id"]: i for i, r in enumerate(rules)}

    results = []
    for f in result.findings:
        results.append({
            "ruleId": f.rule,
            "ruleIndex": index[f.rule],
            "level": "error",
            "message": {"text": f.message},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {
                        "uri": f.path,
                        "uriBaseId": "SRCROOT",
                    },
                    "region": {"startLine": max(int(f.line), 1)},
                },
            }],
        })

    return {
        "$schema": _SCHEMA,
        "version": _SARIF_VERSION,
        "runs": [{
            "tool": {
                "driver": {
                    "name": "repro_torch.analysis",
                    "informationUri": DOCS_BASE,
                    "rules": rules,
                },
            },
            "originalUriBaseIds": {"SRCROOT": {"uri": "file:///"}},
            "results": results,
        }],
    }
