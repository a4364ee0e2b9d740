"""End-to-end driver #1 (counterpart of `examples/decompose_tensor.py`):
full CP-ALS decomposition of a TABLE1 tensor through the backend registry
(the hand-written kernels, the hetero split, the distributed mesh, or the
empirical autotuner) with convergence tracking.

  PYTHONPATH=src python -m repro_torch.examples.decompose_tensor [--tensor amazon]
      [--rank 10] [--iters 5]
      [--engine auto|hetero|chunked|fixed|distributed|ref|alto|csf|kernel]
      [--store [PATH]] [--max-probes K] [--list-backends] [--device cpu]

`--store` persists autotune winners (default ~/.cache/repro/autotune.json,
or $REPRO_AUTOTUNE_CACHE): re-running the same decomposition skips the
probe phase.  `--max-probes` caps a cold start to the cost-model prior's
top-K candidates.  It runs on the CUDA card unless `--device cpu` is given.

`--engine distributed` in one process runs on a one-rank mesh.  Under
`python -m torch.distributed.run --nproc-per-node N -m
repro_torch.examples.decompose_tensor ...` every rank joins the launcher's
group (`launch.join_launched_group`: NCCL on cuda:LOCAL_RANK, gloo with
`--device cpu`) before its first line, and the mesh spans them; every
rank decomposes the same tensor (`--engine auto` is then a collective)
and only rank 0 prints.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch
import torch.distributed as dist

from ..core import CPResult, cp_als, decide_partition, table1_tensor
from ..device import resolve_device
from ..engine import TunePolicy, backend_table, build_engine, registered_backends
from ..launch import join_launched_group, world_rank

PROG = "python -m repro_torch.examples.decompose_tensor"


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog=PROG)
    ap.add_argument("--tensor", default="amazon")
    ap.add_argument("--rank", type=int, default=10)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--engine", default="auto",
                    choices=["auto", *sorted(registered_backends())])
    ap.add_argument("--store", nargs="?", const=True, default=None,
                    help="persist autotune winners (optional PATH; bare flag "
                         "uses the default store)")
    ap.add_argument("--max-probes", type=int, default=None,
                    help="cold-start probe budget (prior's top-K)")
    ap.add_argument("--list-backends", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the plain path)")
    return ap.parse_args(argv)


def say(*args) -> None:
    """Print on rank 0 only (every process prints without a group)."""
    if world_rank() == 0:
        print(*args, flush=True)


def run(args: argparse.Namespace, device: torch.device) -> CPResult:
    """The decomposition `args` name, on `device`, printed line for line as
    the JAX example prints it; returns its result."""
    st = table1_tensor(args.tensor)
    say(f"[decompose] {args.tensor}: dims={st.shape} nnz={st.nnz}")
    plan = decide_partition(st, args.rank, mem_bytes=256 * 1024, rank_axis=args.rank)
    say(f"[decompose] plan: chunks={plan.chunk_shape} cap={plan.capacity}")

    t0 = time.perf_counter()
    engine = build_engine(st, args.engine, args.rank, device=device,
                          chunk_shape=plan.chunk_shape, capacity=plan.capacity,
                          tune=TunePolicy(store=args.store, max_probes=args.max_probes))
    if engine.report is not None:
        say(engine.report.summary())
        say(f"[decompose] tuning: source={engine.report.source} "
            f"probes={engine.report.n_probes} ({time.perf_counter()-t0:.2f}s)")

    t0 = time.perf_counter()
    res = cp_als(st, args.rank, n_iters=args.iters, engine=engine, seed=0)
    say(f"[decompose] engine={engine.name} iters={args.iters} "
        f"wall={time.perf_counter()-t0:.1f}s")
    for i, (f, d) in enumerate(zip(res.fit_history, res.diff_history, strict=True)):
        say(f"  iter {i+1}: fit={f:+.4f} avg|X-X̂|={d:.5f}")
    return res


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.list_backends:
        print(backend_table())
        return 0
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"{PROG}: {e}", file=sys.stderr)
        return 1
    # A group this call makes (the launcher's, or the one-rank group that
    # the distributed engine makes for a lone process) ends with it.
    owned = not dist.is_initialized()
    try:
        join_launched_group(device)  # before the first line: rank 0 alone prints
        run(args, device)
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
