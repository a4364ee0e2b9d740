"""The paper's benchmark harness on the port (counterpart of `benchmarks/`):
Table I (`table1`), Fig. 6 formats × locks (`fig6`), Fig. 7 spMTTKRP time
and peak fraction per backend (`fig7`), Figs. 8/9 the hetero split and rank
sweep (`fig8_9`), the serving benchmark (`serve_bench`) and the sweep CLI
(`sweep`).

  PYTHONPATH=src python -m repro_torch.bench --fast --device cpu
  PYTHONPATH=src python -m repro_torch.bench.serve_bench --fast
  PYTHONPATH=src python -m repro_torch.bench.sweep --config benchmarks/sweep_ci.toml \\
      --store sweep-store.json --report

Every suite runs on the CUDA card unless `--device cpu` is given, and writes
`results/bench/torch_<suite>.json` beside the JAX harness's files.
"""
