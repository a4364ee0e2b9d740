"""CLI: `python -m repro_torch.obs summarize <trace.jsonl>` and
`python -m repro_torch.obs export <trace.jsonl> -o trace.json`
(Chrome/Perfetto), over traces the port writes (`REPRO_TRACE_PATH` or
`export.write_jsonl`; the JAX package's traces share the schema).

Exit codes: 0 OK, 1 invalid trace, 2 usage error (argparse).
"""
from __future__ import annotations

import argparse
import sys

from .export import (
    read_jsonl,
    summarize_text,
    validate_spans,
    write_chrome_trace,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Inspect and convert trace JSONL files of the PyTorch port")
    sub = ap.add_subparsers(dest="command", required=True)

    p_sum = sub.add_parser(
        "summarize",
        help="per-span-kind latency table + tune-decision breakdown")
    p_sum.add_argument("trace", help="trace JSONL path (REPRO_TRACE_PATH "
                                     "output or export.write_jsonl)")

    p_exp = sub.add_parser(
        "export", help="convert to Chrome trace-event JSON for Perfetto")
    p_exp.add_argument("trace")
    p_exp.add_argument("-o", "--out", required=True,
                       help="output .json path (load at ui.perfetto.dev)")

    args = ap.parse_args(argv)
    try:
        meta, spans = read_jsonl(args.trace)
        validate_spans(spans)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    if args.command == "summarize":
        print(summarize_text(meta, spans))
    else:
        out = write_chrome_trace(spans, args.out, meta)
        print(f"wrote {out} ({len(spans)} spans) — open in ui.perfetto.dev "
              "or chrome://tracing")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
