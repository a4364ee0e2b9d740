"""The LM stack across cards: tensor, expert and FSDP parallelism measured
under `torch.distributed.run` (one rank per card, NCCL; gloo with
`--device cpu`).

  python -m torch.distributed.run --standalone --nproc-per-node 4 \\
      -m repro_torch.bench.tp --part serve      # command-r-35b whole on (1, 4)
  ... --part agree     # command-r-35b at 8 layers on (1, 4), (2, 2) and (1, 1), held to each other
  ... --part moe       # qwen3-moe-30b-a3b whole on (1, 4)
  ... --part train     # command-r-35b at 8 layers on (2, 2): one 8-bit train step, a checkpoint
  python -m torch.distributed.run --standalone --nproc-per-node 2 \\
      -m repro_torch.bench.tp --part restore    # that checkpoint resumed on (1, 2)

Weights are drawn from `torch.Generator` seed 0 on each card, every rank
drawing the whole model one part at a time and keeping its blocks
(`LM.init(..., mesh=)`); prompts and batches are `SyntheticTokens` seed 0.
Serving is `generate` at `examples/serve_lm.py`'s sizes (batch 4, prompt
24, gen 12): ms per decode step on the host clock around
`torch.cuda.synchronize` (the mean over steps 4 onward of a second run),
generated tokens/s, each card's peak memory, and one decode step's
collectives and wire bytes per rank (`models.comm.record`, ring formulas
of `roofline.collectives`).  `agree` runs float32 compute and holds the
meshes' prefill logits to the one-rank path within 1e-5 of Σ|terms| of
the final product, and their tokens equal.  `--smoke` runs the smoke
configs (for the CPU).  Rank 0 prints one JSON line per result and
appends it to `--out`.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from ..checkpoint import save_checkpoint
from ..configs import get_config, get_smoke_config
from ..data import SyntheticTokens
from ..launch import elastic, make_local_mesh
from ..launch import steps
from ..launch.shardings import gather_tree, leaves_with_paths
from ..models import LM, MeshCtx, comm, moe, nn
from ..optim import AdamWConfig, adamw_init
from ..roofline import collective_bytes

__all__ = ["main"]

BATCH, PROMPT, GEN = 4, 24, 12      # examples/serve_lm.py's sizes
TIMED_FROM = 4                      # ms per decode step: the mean over steps 4 onward
TRAIN_BATCH, TRAIN_SEQ = 4, 256
LR = 1e-4
LOGIT_REL = 1e-5                    # float32, of Σ|terms|
AGREE_LAYERS = 8


def _rank0() -> bool:
    return dist.get_rank() == 0


def _card() -> str | None:
    """`nvidia-smi`'s name and power limit of the card, None without one."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.splitlines()[0].strip()
    except (OSError, IndexError, subprocess.SubprocessError):
        return None


def _report(out: str | None, rec: dict) -> None:
    if _rank0():
        line = json.dumps({**rec, "card": _card()})
        print(line, flush=True)
        if out:
            os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
            with open(out, "a") as f:
                f.write(line + "\n")


def _config(arch: str, smoke: bool, n_layers: int | None = None, **over):
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if n_layers is not None:
        over["n_layers"] = n_layers
    return dataclasses.replace(cfg, **over)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def _prompts(cfg, device) -> torch.Tensor:
    return torch.from_numpy(SyntheticTokens(cfg.vocab, PROMPT, BATCH).batch(0)).to(device)


def _serve(lm, params, mesh, device) -> dict:
    """`generate` twice (the second timed step by step) and one decode
    step's collectives."""
    ctx = MeshCtx(mesh=None) if mesh is None else steps.make_ctx(mesh, seq_sharded=False)
    prompts = _prompts(lm.cfg, device)
    steps.generate(lm, params, ctx, prompts, GEN)
    times, decode = [], steps.make_decode_step(lm, ctx)
    rows = steps._rows(ctx, BATCH)
    b = prompts[rows].shape[0]
    cache = lm.init_cache(b, max_len=PROMPT + GEN + 8, dtype=torch.float32, device=device,
                          ctx=ctx)
    tok, out = prompts[rows, :1], []
    moe.drops = 0
    with torch.no_grad():
        for t in range(PROMPT + GEN - 1):
            _sync(device)
            t0 = time.perf_counter()
            logits, cache = decode(params, tok, cache, t)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
            _sync(device)
            times.append((time.perf_counter() - t0) * 1e3)
            tok = prompts[rows, t + 1:t + 2] if t + 1 < PROMPT else nxt
            if t + 1 >= PROMPT:
                out.append(nxt)
        drops = moe.drops
        with comm.record() as rec:
            decode(params, tok, cache, PROMPT + GEN - 1)
    ms = float(np.mean(times[TIMED_FROM:]))
    return {"ms_per_step": ms, "step_ms": times, "tokens_per_s": BATCH * 1e3 / ms,
            "tokens": torch.cat(out, dim=1).cpu().tolist(), "drops": drops,
            "decode_collectives": collective_bytes(rec)}


def _init(lm, mesh, device):
    t0 = time.perf_counter()
    params, _ = lm.init(torch.Generator(device).manual_seed(0), mesh=mesh)
    _sync(device)
    held = sum(a.numel() * a.element_size() for a in nn.tree_leaves(params))
    return params, held, time.perf_counter() - t0


def part_serve(args, device, arch="command_r_35b") -> None:
    cfg = _config(arch, args.smoke)
    lm = LM(cfg)
    mesh = make_local_mesh(1, dist.get_world_size(), device=device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    params, held, init_s = _init(lm, mesh, device)
    res = _serve(lm, params, mesh, device)
    drops = torch.tensor([res.pop("drops")], device=device)
    dist.all_reduce(drops)
    peaks = torch.tensor([_peak(device), held], dtype=torch.float64, device=device)
    every = [torch.zeros_like(peaks) for _ in range(dist.get_world_size())]
    dist.all_gather(every, peaks)
    _report(args.out, {"part": args.part, "arch": cfg.name, "n_layers": cfg.n_layers,
                       "mesh": list(mesh.shape), "backend": dist.get_backend(),
                       "n_params": sum(a.numel() for a in nn.tree_leaves(lm.init(nn.SHAPES)[0])),
                       "param_dtype": cfg.param_dtype, "compute_dtype": cfg.compute_dtype,
                       "init_s": init_s, "held_gib": [float(e[1]) / 2**30 for e in every],
                       "peak_gib": [float(e[0]) / 2**30 for e in every], "drops": int(drops),
                       **res})


def _agree_run(lm, mesh, device) -> dict:
    """Prefill logits (B, V) and `generate`'s tokens of the float32 model."""
    params, _, _ = _init(lm, mesh, device)
    ctx = MeshCtx(mesh=None) if mesh is None else steps.make_ctx(mesh)
    prompts = _prompts(lm.cfg, device)
    with torch.no_grad():
        logits = steps.make_prefill_step(lm, ctx)(params, {"tokens": prompts})[:, 0]
    tokens = steps.generate(lm, params, MeshCtx(mesh=None) if mesh is None else
                            steps.make_ctx(mesh, seq_sharded=False), prompts, GEN)
    out = {"logits": logits.float().cpu(), "tokens": tokens.cpu()}
    if mesh is None:  # Σ|terms| of each logit's final product: |h| @ |W|
        seen, logits_of = [], lm._logits

        def record(p, x, *ctx_):
            seen.append(x.float())
            return logits_of(p, x, *ctx_)
        lm._logits = record
        with torch.no_grad():
            lm.prefill(params, MeshCtx(mesh=None), {"tokens": prompts})
        del lm._logits
        w = params["embed"]["w"].T if lm.cfg.tie_embeddings else params["unembed"]["w"]
        out["terms"] = (seen[-1][:, -1].abs() @ w.float().abs()).cpu()
    del params
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def part_agree(args, device, arch="command_r_35b") -> None:
    cfg = _config(arch, args.smoke, None if args.smoke else AGREE_LAYERS,
                  compute_dtype="float32")
    lm = LM(cfg)
    n = dist.get_world_size()
    runs = {}
    for shape in ((1, n), (n // 2, 2)):
        runs[shape] = _agree_run(lm, make_local_mesh(*shape, device=device), device)
    dist.barrier()
    if _rank0():
        one = _agree_run(lm, None, device)
        rec = {"part": args.part, "arch": cfg.name, "n_layers": cfg.n_layers,
               "backend": dist.get_backend(), "tolerance": LOGIT_REL}
        ok = True
        for shape, r in runs.items():
            rel = float(((r["logits"] - one["logits"]).abs() / one["terms"]).max())
            same = bool(torch.equal(r["tokens"], one["tokens"]))
            rec[f"{shape[0]}x{shape[1]}"] = {"max_rel_of_terms": rel, "tokens_equal": same}
            ok &= rel <= LOGIT_REL and same
        rec["ok"] = ok
        rec["tokens"] = one["tokens"].tolist()
        _report(args.out, rec)
    dist.barrier()


def _train_batch(cfg, device) -> dict:
    return {"tokens": torch.from_numpy(
        SyntheticTokens(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH).batch(0)).to(device)}


def part_train(args, device, arch="command_r_35b") -> None:
    cfg = _config(arch, args.smoke, None if args.smoke else AGREE_LAYERS)
    lm = LM(cfg)
    mesh = make_local_mesh(dist.get_world_size() // 2, 2, device=device)
    ctx = steps.make_ctx(mesh)
    params, held, _ = _init(lm, mesh, device)
    opt_cfg = AdamWConfig(lr=LR, use_8bit=True)
    opt = adamw_init(params, opt_cfg, specs=steps.param_specs(lm, ctx), mesh=mesh)
    step = steps.make_train_step(lm, ctx, opt_cfg)
    batch = _train_batch(cfg, device)
    _sync(device)
    t0 = time.perf_counter()
    with comm.record() as rec:
        params, opt, loss = step(params, opt, batch)
        _sync(device)
    step_s = time.perf_counter() - t0
    rec = {"part": args.part, "arch": cfg.name, "n_layers": cfg.n_layers,
           "mesh": list(mesh.shape), "backend": dist.get_backend(),
           "compute_dtype": cfg.compute_dtype, "loss": float(loss), "step_s": step_s,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_s, "held_gib": held / 2**30,
           "peak_gib": _peak(device) / 2**30, "step_collectives": collective_bytes(rec)}
    ckpt = args.ckpt or tempfile.mkdtemp(prefix="tp_ckpt_")
    os.makedirs(ckpt, exist_ok=True)
    sh = steps.state_shardings(lm, mesh, opt_cfg)
    structs, _ = lm.init(nn.SHAPES)
    need = sum(a.numel() * a.element_size() for a in nn.tree_leaves(
        {"params": structs, "opt": steps.init_opt_shapes(structs, opt_cfg)}))
    free = torch.tensor([float(shutil.disk_usage(ckpt).free)], device=device)
    dist.broadcast(free, 0)
    rec.update(ckpt=ckpt, ckpt_gib=need / 2**30, disk_free_gib=float(free) / 2**30)
    if float(free) < 1.1 * need:  # say so rather than fill the disk
        rec["saved"] = False
        _report(args.out, rec)
        return
    t0 = time.perf_counter()
    save_checkpoint(ckpt, 1, {"params": params, "opt": opt}, shardings=sh, mesh=mesh)
    dist.barrier()
    rec.update(saved=True, save_s=time.perf_counter() - t0)
    _, _, next_loss = step(params, opt, batch)  # what the resumed run must take
    rec["next_loss"] = float(next_loss)
    _report(args.out, rec)


def part_restore(args, device, arch="command_r_35b") -> None:
    cfg = _config(arch, args.smoke, None if args.smoke else AGREE_LAYERS)
    lm = LM(cfg)
    opt_cfg = AdamWConfig(lr=LR, use_8bit=True)
    t0 = time.perf_counter()
    mesh, params, opt, start = elastic.elastic_restore(lm, args.ckpt, opt_cfg,
                                                       n_model=dist.get_world_size(),
                                                       device=device)
    restore_s = time.perf_counter() - t0
    # the restored blocks put back together equal the checkpoint, bit for bit
    specs = [s for _, s in leaves_with_paths(steps.state_shardings(lm, mesh, opt_cfg))]
    equal = True
    with np.load(os.path.join(args.ckpt, f"step_{start:08d}", "arrays.npz")) as data:
        leaves = nn.tree_leaves({"params": params, "opt": opt})
        for i, (a, spec) in enumerate(zip(leaves, specs, strict=True)):
            whole = gather_tree(a, spec, mesh)  # one leaf at a time
            if _rank0():
                equal &= bool(np.array_equal(whole.cpu().numpy(), data[f"a{i}"]))
            del whole
    _, _, loss = steps.make_train_step(lm, steps.make_ctx(mesh), opt_cfg)(
        params, opt, _train_batch(cfg, device))
    _report(args.out, {"part": args.part, "arch": cfg.name, "n_layers": cfg.n_layers,
                       "mesh": list(mesh.shape), "backend": dist.get_backend(), "step": start,
                       "restored_equal": equal, "loss": float(loss), "restore_s": restore_s})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench.tp")
    ap.add_argument("--part", required=True,
                    choices=("serve", "agree", "moe", "train", "restore"))
    ap.add_argument("--device", default=None, help="cpu: gloo ranks on the host")
    ap.add_argument("--smoke", action="store_true", help="the smoke configs")
    ap.add_argument("--ckpt", default=None, help="the checkpoint directory (train, restore)")
    ap.add_argument("--out", default=None, help="append the JSON lines to this file")
    args = ap.parse_args(argv)
    device = torch.device(args.device) if args.device else torch.device(
        "cuda", int(os.environ.get("LOCAL_RANK", "0")))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    make_local_mesh(device=device)  # joins the launcher's group
    if args.part == "moe":
        part_serve(args, device, "qwen3_moe_30b_a3b")
    else:
        {"serve": part_serve, "agree": part_agree, "train": part_train,
         "restore": part_restore}[args.part](args, device)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
