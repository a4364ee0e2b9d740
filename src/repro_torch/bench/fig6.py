"""Paper Fig. 6 — number formats × lock usage: convergence (average absolute
difference) and per-iteration execution time, on Nell-2-like (mode-3),
Delicious-like (mode-4) and LBNL-like (mode-5) tensors (counterpart of
`benchmarks/fig6.py`).

Formats: Float (f32, the chunked engine), Int7 (Q9.7/16-bit), Int15-12
(Q17.15 + prec_shift 3), the fixed-point ones through the hand-written
fixed-point kernel on the card.  Locks: exact scatter ("locks") vs the
wave-collision-drop emulation ("no locks").  Expected reproduction of the
paper's findings:
  * fixed-point convergence within a fraction of a % of float;
  * Int7 slightly worse than Int15-12 on mode-4/5 tensors;
  * lock removal does not meaningfully change convergence.
`time_per_iter_s` is `CPResult.iter_times`' mean (host clock around each
iteration, ending in one device synchronisation); `total_s` the host wall
time of the whole call, set-up included.
"""
from __future__ import annotations

import time

import torch

from ..core import cp_als, table1_tensor
from ..engine import PlanCache, TunePolicy, candidate_lossless
from .common import save, table

TENSORS = ["nell2", "delicious", "lbnl"]
FORMATS = [("float", "chunked", None), ("int7", "fixed", "int7"),
           ("int15-12", "fixed", "int15-12")]
RANK = 10
ITERS = 5
#: The Fig.-6 format study as an autotune candidate space: the chunked
#: execution strategy in float against every fixed-point preset of the same
#: strategy, decided per workload under an explicit error budget.
TUNE_CANDIDATES = ["chunked", "fixed:int3", "fixed:int7", "fixed:int15-12"]


def _tune_rows(iters: int, fast: bool, accuracy_budget: float | None, *,
               device: torch.device):
    """Accuracy-budgeted format autotuning over the fig6 workloads.

    Two passes per tensor: `budget=None` (default candidates, so no lossy
    backend may win) and, when an accuracy budget was given, a budgeted pass
    over `TUNE_CANDIDATES` where each fixed-point preset competes under its
    measured error.  What the card picks is recorded, not held to a winner."""
    rows = []
    budgets = [None] if accuracy_budget is None else [None, accuracy_budget]
    for tname in TENSORS:
        st = table1_tensor(tname, nnz=8000 if fast else None)
        plans = PlanCache()
        for budget in budgets:
            tune = (TunePolicy() if budget is None else
                    TunePolicy(accuracy_budget=budget, candidates=tuple(TUNE_CANDIDATES)))
            res = cp_als(st, RANK, n_iters=iters, engine="auto", seed=0, device=device,
                         mem_bytes=256 * 1024, plans=plans, tune=tune)
            rep = res.tune_report
            picked = {str(m): w for m, w in sorted(rep.winners.items())}
            lossy_picks = sorted({w for w in rep.winners.values() if not candidate_lossless(w)})
            winner_err = max((e for w in lossy_picks for e in rep.errors.get(w, {}).values()),
                             default=None)
            rows.append(dict(
                tensor=tname, fmt="autotune",
                budget=budget,
                engine=res.engine,
                picked=picked,
                lossy_picks=lossy_picks,
                winner_max_error=winner_err,
                within_budget=(winner_err is None
                               or (budget is not None and winner_err <= budget)),
                errors={c: round(max(per.values()), 6) for c, per in rep.errors.items()},
                rejected={c: why for c, why in rep.skipped.items() if "accuracy budget" in why},
                candidates=list(rep.candidates),
                avg_abs_diff=round(res.diff_history[-1], 6),
                fit=round(res.fit_history[-1], 4),
                quant_error=res.quant_error,
            ))
            print(f"[fig6] {tname} autotune budget={budget}: {res.engine} "
                  f"lossy_picks={lossy_picks or '-'} winner_err={winner_err}", flush=True)
    return rows


def run(fast: bool = False, accuracy_budget: float | None = None, *, device: torch.device):
    rows = []
    iters = 2 if fast else ITERS
    for tname in TENSORS:
        st = table1_tensor(tname, nnz=8000 if fast else None)
        plans = PlanCache()  # all formats × lock modes share one chunking
        for fmt_name, engine, preset in FORMATS:
            for locks in (True, False):
                kw = dict(engine=engine, seed=0, mem_bytes=256 * 1024,
                          lockfree_mode=not locks, plans=plans, device=device)
                if preset:
                    kw["fixed_preset"] = preset
                t0 = time.perf_counter()
                res = cp_als(st, RANK, n_iters=iters, **kw)
                wall = time.perf_counter() - t0
                rows.append(dict(
                    tensor=tname, fmt=fmt_name,
                    locks="locks" if locks else "no-locks",
                    avg_abs_diff=round(res.diff_history[-1], 6),
                    fit=round(res.fit_history[-1], 4),
                    time_per_iter_s=sum(res.iter_times) / iters,
                    total_s=wall,
                ))
                print(f"[fig6] {tname} {fmt_name} {'locks' if locks else 'no-locks'}: "
                      f"diff={rows[-1]['avg_abs_diff']} "
                      f"t/iter={rows[-1]['time_per_iter_s']:.6f}s", flush=True)
    print("\n== Fig. 6: formats × locks — convergence and time ==")
    print(table([{**r, "time_per_iter_s": f"{r['time_per_iter_s']:.6f}"} for r in rows],
                ["tensor", "fmt", "locks", "avg_abs_diff", "fit", "time_per_iter_s"]))
    # Paper-claim checks (soft, printed).  The paper's recommendation:
    # Int7 for mode-3 tensors, Int15-12 for mode-4/5.
    by = {(r["tensor"], r["fmt"], r["locks"]): r for r in rows}
    modes = {"nell2": 3, "delicious": 4, "lbnl": 5}
    for tname in TENSORS:
        f = by[(tname, "float", "locks")]["avg_abs_diff"]
        rec_fmt = "int7" if modes.get(tname, 3) == 3 else "int15-12"
        for fmt in ("int7", "int15-12"):
            q = by[(tname, fmt, "locks")]["avg_abs_diff"]
            rel = abs(q - f) / max(abs(f), 1e-12)
            mark = ""
            if fmt == rec_fmt:
                mark = " [recommended fmt] " + ("OK" if rel < 0.05 else "DIVERGES")
            print(f"[claim] {tname} (mode-{modes.get(tname, 3)}): "
                  f"|{fmt} - float| rel diff = {rel:.3%}{mark}")

    # Accuracy-budgeted format autotuning: the same trade-off, decided by
    # the tuner under an explicit error budget.
    tune = _tune_rows(iters, fast, accuracy_budget, device=device)
    rows.extend(tune)
    print("\n== Fig. 6: accuracy-budgeted format autotuning ==")
    print(table(tune, ["tensor", "budget", "engine", "lossy_picks",
                       "winner_max_error", "within_budget", "fit"]))
    save("fig6", rows)
    return rows
