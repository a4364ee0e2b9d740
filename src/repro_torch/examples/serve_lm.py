"""Serve a small LM with batched requests (counterpart of
`examples/serve_lm.py`): prefill (teacher-forced) and batched greedy decode
against ring-buffer KV caches.

  PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch gemma3-4b --batch 4 [--device cpu]

The arch's smoke config, weights drawn from `torch.Generator` seed 0 on the
device, prompts from `SyntheticTokens` step 0.  It runs on the CUDA card
unless `--device cpu` is given, and exits 1 without one.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch
import torch.distributed as dist

from ..configs import get_smoke_config
from ..data import SyntheticTokens
from ..device import resolve_device
from ..launch.mesh import make_local_mesh
from ..launch.steps import generate, make_ctx
from ..models import LM

PROG = "python -m repro_torch.examples.serve_lm"


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog=PROG)
    ap.add_argument("--arch", default="gemma3-4b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--gen", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs on the CPU)")
    return ap.parse_args(argv)


def run(args: argparse.Namespace, device: torch.device) -> torch.Tensor:
    """Serve one batch and print it as the JAX example does; returns the
    generated tokens (B, gen) on the host."""
    cfg = get_smoke_config(args.arch)
    lm = LM(cfg)
    ctx = make_ctx(make_local_mesh(device=device), seq_sharded=False)
    params, _ = lm.init(torch.Generator(device).manual_seed(0))
    prompts = torch.from_numpy(
        SyntheticTokens(cfg.vocab, args.prompt_len, args.batch).batch(0)).to(device)
    t0 = time.perf_counter()
    toks = generate(lm, params, ctx, prompts, args.gen).cpu()
    dt = time.perf_counter() - t0
    print(f"[serve_lm] {args.arch}: batch={args.batch} "
          f"prompt={args.prompt_len} gen={args.gen} -> {tuple(toks.shape)} "
          f"in {dt:.2f}s ({args.batch*args.gen/dt:.1f} tok/s)")
    print(toks.numpy())
    return toks


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"{PROG}: {e}", file=sys.stderr)
        return 1
    owned = not dist.is_initialized()  # the mesh's group ends with this call
    try:
        run(args, device)
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
