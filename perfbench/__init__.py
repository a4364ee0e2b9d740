"""The benchmark of the PyTorch and CUDA port (`repro_torch`).

`python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of `BENCHMARK.json` once and prints one JSON result line.  Everything
that belongs to one configuration, traffic mix, cell or per-layer metric is a file of
its own, found by the name `BENCHMARK.json` gives it:

  configs/<config>.json    the tensor as it is run (sizes, distribution, rank)
  traffic/<traffic>.json   the mix: the engine and how each decomposition is called
  workloads/<cell>.json    the cell's correctness sample and limits
  metrics/<metric>.py      the reader of one per-layer metric

The yardstick lives here too: the seeded tensor generator (`tensorgen`), the plain
CP-ALS reference (`reference`), the comparison that decides `correct` (`check`),
the bytes and operations of the work (`roofline`) and the reduction of the device
trace (`devtrace`).  None of it imports `jax`, `repro` or `benchmarks`.
"""
