"""Repo-aware static-analysis pass suite for the PyTorch/CUDA port.

The port's own copy of `repro.analysis` (which it may not import), aimed
at `src/repro_torch/`, its CUDA sources and `chip_smoke.py`; it never walks
the JAX package, which has its own suite.  Two tiers of rules over one AST
engine (`engine.py`):

**Syntactic tier** — cheap per-node passes:

- **PyTorch hot-path hygiene** (`torch_rules.py`) — host-device syncs
  (held against torch's own sync log on the card by `chip_smoke.py`),
  hidden global RNG state, registration-order enumeration.
- **Cross-module invariants** (`invariant_rules.py`) — persist-schema
  manifest pinning, byte-term arity vs the NNLS design matrix, registry ↔
  docs anchor agreement, import-graph orphans and the port's isolation from
  JAX and the JAX package.

**Dataflow tier**:

- **Kernel contracts** (`shape_rules.py` over `dataflow.py`) — the public
  MTTKRP surface pinned in `kernel_contracts.json` (`--regen-contracts` to
  re-pin the signatures) and proven by abstract interpretation over torch's
  ops and dtype lattice: every variant's return shape and dtype, every
  `index_add_` target's rows, no narrow integer product.
- **Integer widths** (`width_rules.py`) — unguarded int64→int32 index
  narrowing at the host/device seam, ALTO key word-geometry agreement
  across modules, fixed-point accumulator bounds re-derived from the QFormat
  preset table and the Alg.-2 shifts checked in the CUDA kernel's source.

Run it::

    python -m repro_torch.analysis [--strict] [--format json|sarif]
    python -m repro_torch.analysis --tier syntactic      # the fast pass
    python -m repro_torch.analysis --list-rules
    python -m repro_torch.analysis --baseline FILE       # fail only on new findings
    python -m repro_torch.analysis --regen-manifest      # after a _SCHEMA_VERSION bump
    python -m repro_torch.analysis --regen-contracts     # after a kernel API change

Suppress a finding in place, with a reason::

    x = float(y)  # repro-lint: disable=host-sync -- timing readout, cold path

See docs/torch-static-analysis.md for the rule catalog.
"""
from __future__ import annotations

from . import invariant_rules, torch_rules  # imported for side effect: register the rules
from . import shape_rules, width_rules  # noqa: F401  (dataflow-tier rules)
from .docanchors import extract_anchor_refs, extract_anchors
from .engine import (
    AnalysisResult,
    FileContext,
    Finding,
    ProjectContext,
    RuleSpec,
    Suppression,
    check_source,
    default_root,
    get_rule,
    register_rule,
    registered_rules,
    rule_table,
    run_analysis,
)
from .invariant_rules import extract_schema, regen_manifest
from .sarif import to_sarif
from .shape_rules import load_contracts, regen_contracts

__all__ = [
    "AnalysisResult",
    "FileContext",
    "Finding",
    "ProjectContext",
    "RuleSpec",
    "Suppression",
    "check_source",
    "default_root",
    "extract_anchor_refs",
    "extract_anchors",
    "extract_schema",
    "get_rule",
    "load_contracts",
    "regen_contracts",
    "regen_manifest",
    "register_rule",
    "registered_rules",
    "rule_table",
    "run_analysis",
    "to_sarif",
]
