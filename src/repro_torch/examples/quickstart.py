"""Quickstart (counterpart of `examples/quickstart.py`): decompose a sparse
tensor with PRISM on the card.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Walks the paper end-to-end in miniature: build a sparse tensor, let the
Fig. 5 decider pick a partition, run CP-ALS with the PRISM chunked engine
(float), the fixed-point engine (paper Alg. 2, through its CUDA kernel) and
the float CUDA kernel (`kernel`, where the JAX quickstart runs `pallas`),
and compare convergence.  It runs on the CUDA card unless `--device cpu`
is given.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..core import CPResult, cp_als, decide_partition, random_tensor
from ..device import resolve_device

PROG = "python -m repro_torch.examples.quickstart"


def run(device: torch.device) -> dict[str, CPResult]:
    """The quickstart's four runs on `device`, printed as the JAX quickstart
    prints them; returns each engine's result by name."""
    # A Nell-2-like synthetic tensor (see repro_torch.bench.table1 for the set).
    st = random_tensor((605, 460, 1440), nnz=50_000, seed=0)
    print(f"tensor: dims={st.shape} nnz={st.nnz} density={st.density:.2e}")

    rank = 10
    plan = decide_partition(st, rank, mem_bytes=256 * 1024, rank_axis=rank)
    print(f"partition plan (Fig. 5): chunk_shape={plan.chunk_shape} "
          f"capacity={plan.capacity} rank_block={plan.rank_block} "
          f"kernel_iterations={plan.kernel_iterations}")

    results = {}
    for engine, kw in [
        ("ref", {}),
        ("chunked", dict(chunk_shape=plan.chunk_shape, capacity=plan.capacity)),
        ("fixed", dict(chunk_shape=plan.chunk_shape, capacity=plan.capacity,
                       fixed_preset="int7")),
        # The JAX quickstart's `pallas` row, with its capacity cap.
        ("kernel", dict(chunk_shape=plan.chunk_shape,
                        capacity=min(plan.capacity, 128))),
    ]:
        res = cp_als(st, rank, n_iters=3, engine=engine, seed=0, device=device, **kw)
        print(f"engine={engine:8s} fit={res.fit_history[-1]:+.4f} "
              f"avg|X-X̂|={res.diff_history[-1]:.5f} "
              f"t/iter={np.mean(res.iter_times):.2f}s", flush=True)
        results[engine] = res
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog=PROG)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the plain path)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"{PROG}: {e}", file=sys.stderr)
        return 1
    run(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
