"""Paper Figs. 8+9 — heterogeneous split: execution time vs workload
distribution, and speedups over the ALTO baseline across decomposition
ranks (counterpart of `benchmarks/fig8_9.py`).

On the card the dense path (a dense block product per densified task)
plays PIM and takes the densest chunks, and the sparse path, the
hand-written float kernel, plays the CPU.  The dense workload fraction is
swept as the paper sweeps the PIM fraction, at rank 10 and 32.  Times come
from `common.timeit` (CUDA events on the card).
"""
from __future__ import annotations

import torch

from ..core import init_factors, table1_tensor
from ..engine import PlanCache, build_engine
from .common import save, table, timeit

RANKS = [10, 32]
# dense fractions beyond ~0.25 densify hyper-sparse chunks — the cost model
# (split_tasks default) never chooses that region, so the sweep stops there.
FRACTIONS = [0.0, 0.1, 0.25]


def run(fast: bool = False, *, device: torch.device):
    rows = []
    tensors = ["nell1", "amazon", "5d_large"] if not fast else ["amazon"]
    ranks = [10] if fast else RANKS
    for tname in tensors:
        st = table1_tensor(tname, nnz=6000 if fast else 12000)
        for rank in ranks:
            factors = init_factors(st.shape, rank, 0, device=device)
            plans = PlanCache()  # the fraction sweep shares one chunking
            base = build_engine(st, "alto", rank, device=device)
            t_alto = sum(timeit(base, factors, m, device=device, warmup=1, iters=1)
                         for m in range(st.ndim))
            best = None
            for frac in FRACTIONS:
                eng = build_engine(st, "hetero", rank, mem_bytes=64 * 1024,
                                   dense_fraction=frac, plans=plans, device=device)
                t = sum(timeit(eng, factors, m, device=device, warmup=1, iters=1)
                        for m in range(st.ndim))
                rows.append(dict(
                    tensor=tname, rank=rank, dense_fraction=frac,
                    time_ms=t * 1e3,
                    speedup_vs_alto=t_alto / t,
                ))
                if best is None or t < best[1]:
                    best = (frac, t)
                print(f"[fig8_9] {tname} R={rank} frac={frac}: {rows[-1]['time_ms']:.4f}ms "
                      f"speedup={rows[-1]['speedup_vs_alto']:.3f}", flush=True)
            print(f"[fig8_9] {tname} R={rank}: best dense fraction "
                  f"{best[0]} ({best[1] * 1e3:.4f} ms vs alto {t_alto * 1e3:.4f} ms)")
    print("\n== Figs. 8/9: heterogeneous split sweep + speedups ==")
    print(table([{**r, "time_ms": f"{r['time_ms']:.4f}",
                  "speedup_vs_alto": f"{r['speedup_vs_alto']:.3f}"} for r in rows],
                ["tensor", "rank", "dense_fraction", "time_ms", "speedup_vs_alto"]))
    save("fig8_9", rows)
    return rows
