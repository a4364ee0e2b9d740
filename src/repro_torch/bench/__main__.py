"""Benchmark entry point, one module per paper table/figure (counterpart of
`benchmarks/run.py`):

  PYTHONPATH=src python -m repro_torch.bench [--fast] [--only fig6,fig7,...]
      [--device cpu] [--case-a]

It runs on the CUDA card unless `--device cpu` is given, and exits non-zero
without one.  Each suite writes `results/bench/torch_<suite>.json`.  Exit
status: 0 clean; 1 when a suite failed (or there is no card); 2 for an
unknown or empty `--only` name, before any suite runs.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
import traceback

from ..device import resolve_device

SUITES = ("table1", "fig6", "fig7", "fig8_9")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench")
    ap.add_argument("--fast", action="store_true", help="reduced nnz/iters")
    ap.add_argument("--only", default=None,
                    help="comma-separated subset of suites to run; unknown "
                         "names abort before any suite runs")
    ap.add_argument("--accuracy-budget", type=float, default=None,
                    help="max per-mode MTTKRP relative error for the fig6 "
                         "format-autotuning rows: admits fixed-point preset "
                         "candidates to the tuner, each policed against it")
    ap.add_argument("--store", default=None,
                    help="autotune persistence store path, shared by every "
                         "suite that tunes; repeat invocations against the "
                         "same path start warm.  Default: an ephemeral "
                         "per-invocation store")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the plain path)")
    ap.add_argument("--case-a", action="store_true",
                    help="fig7 also times NELL-2 at its published size under "
                         "the 256 KiB plan (minutes of host set-up)")
    args = ap.parse_args(argv)

    # Validate the whole --only list before running anything: a typo'd name
    # ("fig8" for "fig8_9", a stray comma) must abort with the valid names.
    only = [t.strip() for t in args.only.split(",")] if args.only else list(SUITES)
    unknown = sorted({repr(n) for n in only if n not in SUITES})
    if unknown:
        print(f"unknown benchmark suite(s): {', '.join(unknown)}; "
              f"valid names: {', '.join(sorted(SUITES))}", file=sys.stderr)
        return 2
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"repro_torch.bench: {e}", file=sys.stderr)
        return 1

    from ..engine import CalibratedPrior, CalibrationError, TuningStore, default_prior
    from ..engine import device_fingerprint, ranking_accuracy
    from . import fig6, fig7, fig8_9, table1

    # One store for the whole invocation: a suite that autotunes warms the
    # next, and a repeat invocation against the same --store path starts
    # warm.  Without --store the store is ephemeral.
    store = TuningStore(args.store or os.path.join(
        tempfile.mkdtemp(prefix="repro-torch-bench-"), "autotune.json"))
    suites = {
        "table1": lambda: table1.run(),
        "fig6": lambda: fig6.run(fast=args.fast, accuracy_budget=args.accuracy_budget,
                                 device=device),
        "fig7": lambda: fig7.run(fast=args.fast, store=store, device=device,
                                 case_a=args.case_a),
        "fig8_9": lambda: fig8_9.run(fast=args.fast, device=device),
    }
    failed = []
    for name in only:
        print(f"\n######## repro_torch.bench.{name} on {device} ########", flush=True)
        t0 = time.perf_counter()
        try:
            suites[name]()
            print(f"######## {name} done in {time.perf_counter() - t0:.1f}s ########",
                  flush=True)
        except Exception:  # one suite's failure is reported, the rest still run
            failed.append(name)
            traceback.print_exc()
    if failed:
        print(f"benchmark suites failed: {failed}", file=sys.stderr)
        return 1

    # What the invocation left behind for the next one: the store's entries
    # are both warm-start winners and the calibration's training data.
    fingerprint = device_fingerprint(device)
    obs = store.observations(device=fingerprint)
    if obs:
        line = (f"autotune store {store.path}: {len(store)} entries, "
                f"{len(obs)} observations on {device}")
        try:
            calib = CalibratedPrior.from_store(store, device=fingerprint)
            ch, total = ranking_accuracy(store, calib, device=fingerprint)
            dh, _ = ranking_accuracy(store, default_prior, device=fingerprint)
            line += (f"; calibrated prior rel err {calib.calibration.mean_rel_err:.0%}, "
                     f"top-1 {ch}/{total} (default prior {dh}/{total})")
        except CalibrationError as e:
            line += f"; calibration unavailable ({e})"
        print(line, flush=True)
    print(f"\nall benchmark suites passed: {only}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
