"""The example drivers on the port (counterpart of `examples/`):

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
  PYTHONPATH=src python -m repro_torch.examples.decompose_tensor [--tensor amazon]
      [--rank 10] [--iters 5] [--engine auto|kernel|fixed|distributed|...]
      [--store [PATH]] [--max-probes K] [--list-backends] [--device cpu]
  PYTHONPATH=src python -m repro_torch.examples.serve_lm [--arch gemma3-4b]
      [--batch 4] [--prompt-len 24] [--gen 12] [--device cpu]

All run on the CUDA card unless `--device cpu` is given, and exit 1
without one.  `decompose_tensor` also runs under
`python -m torch.distributed.run --nproc-per-node N -m ...`, one rank per
card (NCCL) or per CPU process (gloo with `--device cpu`); only rank 0
prints.  The `kernel` engine stands where the JAX examples' `pallas` stood.
"""
