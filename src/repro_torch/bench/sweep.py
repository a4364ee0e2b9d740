"""Offline design-space sweep CLI (counterpart of `benchmarks/sweep.py`).

Fill a tuning store from a declared grid, resumably, and report the Pareto
front over (wall time, accuracy, index bytes)::

  PYTHONPATH=src python -m repro_torch.bench.sweep \\
      --config benchmarks/sweep_ci.toml --store sweep-store.json --report

Run it twice against the same store and the second run performs zero
probes: the filled store ships keyed on `--fingerprint`, and a fresh
checkout that loads it autotunes warm (`--require-warm` gates exactly
that).  On the card the report's peak fractions are against
`roofline.H100_SXM5`; on the CPU against `sweep.report.HOST_HW`.

Exit status: 0 clean; 1 when any cell failed; 3 when `--require-warm` saw
a probe.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from ..device import resolve_device
from ..engine import TuningStore, device_fingerprint, device_fingerprint_id
from ..roofline import H100_SXM5
from ..sweep import load_config, pareto_report, run_sweep
from ..sweep.report import HOST_HW
from . import common
from .common import save, table


def main(argv=None) -> int:
    default_report = os.path.join(common.RESULTS_DIR, "torch_sweep_pareto.json")
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default=None,
                    help="sweep grid, TOML or JSON (see repro_torch.sweep.config)")
    ap.add_argument("--store", default=None,
                    help="tuning store to fill (opened with nnz_tol=0: "
                         "nnz-band cells are distinct design points)")
    ap.add_argument("--resume", action=argparse.BooleanOptionalAction, default=True,
                    help="skip cells the store already holds (default); "
                         "--no-resume forgets and re-measures every cell")
    ap.add_argument("--report", nargs="?", const=default_report, default=None,
                    metavar="PATH",
                    help="write the Pareto-front JSON (every point carries "
                         "time, rel-error, index bytes, peak-fraction); "
                         f"default path {default_report}")
    ap.add_argument("--require-warm", action="store_true",
                    help="exit 3 if any probe ran — the fresh-checkout "
                         "warm-hit gate for a shipped store artifact")
    ap.add_argument("--max-cells", type=int, default=None,
                    help="execute at most this many cells this run "
                         "(resume skips don't count); the rest defer")
    ap.add_argument("--fingerprint", action="store_true",
                    help="print this device's fingerprint id and exit "
                         "(the key of a shipped store artifact)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the plain path)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"sweep: {e}", file=sys.stderr)
        return 1
    fingerprint = device_fingerprint_id(device_fingerprint(device))

    if args.fingerprint:
        print(fingerprint)
        return 0
    if not args.config or not args.store:
        ap.error("--config and --store are required (unless --fingerprint)")

    cfg = load_config(args.config)
    store = TuningStore(args.store, nnz_tol=0.0)
    result = run_sweep(cfg, store, resume=args.resume, max_cells=args.max_cells,
                       log=print, device=device)

    rows = [o.to_json() for o in result.outcomes]
    for r in rows:
        r["winners"] = " ".join(f"m{m}={n}" for m, n in sorted(r["winners"].items()))
        r["seconds"] = f"{r['seconds']:.2f}"
    print()
    print(table(rows, ["cell", "status", "n_probes", "seconds", "winners"]))
    payload = result.to_json()
    payload["resume"] = args.resume
    payload["device"] = str(device)
    path = save("sweep", payload)
    print(f"\nwrote {path}")
    print(f"store {store.path}: {len(store)} entries, device {fingerprint}, "
          f"{result.n_probes} probes this run")

    if args.report:
        rep = pareto_report(store, hw=H100_SXM5 if device.type == "cuda" else HOST_HW,
                            device=device)
        os.makedirs(os.path.dirname(args.report) or ".", exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(rep, f, indent=1, default=float)
        print(f"wrote {args.report}: {rep['n_points']} points, "
              f"{rep['n_pareto']} on the Pareto front against {rep['hw']['name']}")
        front = [{
            "cell": p["cell"].split("/", 1)[1],  # drop the device id prefix
            "candidate": p["candidate"],
            "time_ms": f"{p['time_s'] * 1e3:.4f}",
            "rel_error": f"{p['rel_error']:.2e}",
            "index_kib": f"{p['index_bytes'] / 1024:.1f}",
            "peak": f"{p['peak_fraction']:.3%}",
        } for p in rep["front"]]
        print(table(front, ["cell", "candidate", "time_ms", "rel_error", "index_kib", "peak"]))

    if result.count("failed"):
        print(f"{result.count('failed')} cell(s) failed", file=sys.stderr)
        return 1
    if args.require_warm and result.n_probes > 0:
        print(f"--require-warm: expected a fully warm store but "
              f"{result.n_probes} probes ran", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
