"""Markdown anchor extraction shared by the registry-docs rule and its
tests (a copy of `repro.analysis.docanchors`, which the port may not
import; `tests/test_torch_analysis.py` holds the two equal).

`docs/torch-candidates.md` pins one `<a id="..."></a>` anchor per backend
and preset id of the port's registry, `docs/candidates.md` one per format;
`formats.format_table` emits `[...](docs/candidates.md#anchor)` links.  The
registry-docs rule cross-checks them, so this parser is the single
definition of "what counts as an anchor".
"""
from __future__ import annotations

import re

__all__ = ["extract_anchor_refs", "extract_anchors"]

#: `<a id="name"></a>` — the explicit-anchor idiom candidates.md uses
#: (GitHub keeps these stable across heading edits, unlike slugs).
_ANCHOR_RE = re.compile(r'<a\s+id="(?P<id>[^"]+)"\s*>\s*</a>')

#: `[text](target#fragment)` markdown links with a fragment.
_REF_RE = re.compile(r"\[[^\]\n]*\]\((?P<target>[^)#\s]*)#(?P<frag>[^)\s]+)\)")


def extract_anchors(markdown: str) -> dict[str, int]:
    """anchor id → first line it is defined on (1-based)."""
    anchors: dict[str, int] = {}
    for lineno, line in enumerate(markdown.splitlines(), start=1):
        for m in _ANCHOR_RE.finditer(line):
            anchors.setdefault(m.group("id"), lineno)
    return anchors


def extract_anchor_refs(markdown: str) -> list[tuple[str, str, int]]:
    """Every `[..](target#fragment)` link as (target, fragment, line).

    `target` is the path part before `#` ("" for same-document links) —
    callers filter on it before resolving fragments against a file's
    anchor set.
    """
    refs: list[tuple[str, str, int]] = []
    for lineno, line in enumerate(markdown.splitlines(), start=1):
        refs.extend((m.group("target"), m.group("frag"), lineno)
                    for m in _REF_RE.finditer(line))
    return refs
