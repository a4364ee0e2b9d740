"""Production-mesh dry run (counterpart of `repro.launch.dryrun`): every
(architecture × input shape) costed on the production (16, 16) mesh, or
(2, 16, 16) across two pods, without a card and without 256 ranks.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-4b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes]

Results land in results/dryrun_torch/<arch>__<shape>__<mesh>.json.

A cell is costed from what the port itself does:

* bytes a device holds: each leaf's block under the resolved specs
  (`launch.shardings`) for the params, the AdamW state (train) and the
  decode cache (decode; the reference's cache placement);
* collectives and wire bytes per step: the port's own schedule.  The
  step (`make_train_step`, `make_prefill_step`, `LM.decode_step`) runs on
  meta tensors over a mesh of the production sizes whose groups are
  `comm.DryGroup`s: every collective it runs is recorded with its bytes
  and group (`comm.record`), and `roofline.collectives` turns the log into
  wire bytes per device by the ring formulas.  The step runs at one and at
  two repeats of the layer pattern, and the difference is extrapolated to
  the full depth, as the reference calibrates its scan (the per-repeat
  collectives do not depend on the depth); a train or prefill step runs
  at two short lengths likewise (each collective is affine in the rows),
  and attention runs as one block and Mamba's scan as one chunk, which
  changes no collective;
* FLOPs: 6·N·T (train) or 2·N·T (serve) over the active non-embedding
  params (`model_flops`), plus the mixers' inner loops
  (`inner_loop_correction`), over the chips; bytes: the weights a device
  multiplies (each leaf over its model-axis factor: FSDP gathers them
  whole over `data`) once per pass (three in training: forward, remat,
  backward), plus the params and AdamW state read and written once
  (train) or the cache read once (decode), plus the inner loops' bytes.

The reference lowers and compiles each cell with XLA and reads its
`cost_analysis` and `memory_analysis`, then corrects the scan bodies XLA
counts once; the port has no compiler whose analysis it could read, so
those numbers, and the temporary and peak memory XLA reports, have no
counterpart here.  Unlike the reference's module, this one sets nothing
in the environment when it is imported.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from ..configs import ARCHS, get_config
from ..models import LM, comm, nn
from ..optim import AdamWConfig
from ..roofline import collective_bytes, model_flops, roofline_terms
from .shardings import (batch_shardings, block_shape, cache_shardings, init_shapes,
                        leaves_with_paths, map_with_specs, opt_shardings, param_shardings)
from .steps import init_opt_shapes, make_ctx, make_prefill_step, make_train_step

__all__ = ["SHAPES", "input_structs", "count_active_params", "should_skip",
           "inner_loop_correction", "run_cell", "DryMesh", "main"]

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}


class DryMesh:
    """A mesh of the given axis sizes whose ranks do not exist: its groups
    are `comm.DryGroup`s and this process is every axis's rank 0."""

    def __init__(self, sizes: dict):
        self.mesh_dim_names = tuple(sizes)
        self.shape = tuple(sizes.values())

    def get_group(self, axis: str):
        return comm.DryGroup(dict(zip(self.mesh_dim_names, self.shape))[axis])

    def get_local_rank(self, axis: str) -> int:
        return 0


def production_sizes(multi_pod: bool) -> dict:
    """16×16 = 256 chips per pod; 2 pods = 512 chips multi-pod."""
    return {"pod": 2, "data": 16, "model": 16} if multi_pod else {"data": 16, "model": 16}


def input_structs(cfg, kind: str, seq: int, batch: int) -> dict:
    """Meta-tensor stand-ins for every model input (no allocation)."""
    def tok(b, s):
        return torch.empty((b, s), dtype=torch.int32, device="meta")
    if kind in ("train", "prefill"):
        if cfg.encoder_decoder:
            return {"frames": torch.empty((batch, seq, cfg.d_model), device="meta"),
                    "tokens": tok(batch, max(seq // cfg.dec_ratio, 16))}
        if cfg.n_image_tokens:
            return {"tokens": tok(batch, seq - cfg.n_image_tokens),
                    "image_embeds": torch.empty((batch, cfg.n_image_tokens, cfg.d_model),
                                                device="meta")}
        return {"tokens": tok(batch, seq)}
    raise ValueError(kind)


def count_active_params(cfg, structs) -> float:
    """Non-embedding params, MoE experts scaled by the activated fraction."""
    total = 0.0
    for path, leaf in leaves_with_paths(structs):
        if "embed" in path or "unembed" in path:
            continue
        n = math.prod(leaf.shape)
        if any(k in ("wg", "wu", "wd") for k in path) and "moe" in path:
            n *= cfg.top_k / max(cfg.n_experts, 1)
        total += n
    return total


def should_skip(cfg, shape_name: str) -> str | None:
    if shape_name == "long_500k" and not cfg.supports_long_context:
        return ("pure full attention — long_500k needs a sub-quadratic path "
                "(DESIGN.md §5)")
    return None


def inner_loop_correction(cfg, kind: str, seq: int, batch: int):
    """The global (flops, bytes) of the mixers' inner loops — attention's
    scores and values, Mamba's and the mLSTM's chunk scans, the sLSTM's
    steps — that a count of params times tokens leaves out (the
    reference's analytic add-back; decode has none).  mult: train = fwd(1)
    + remat recompute(1) + bwd(2); prefill = fwd only."""
    if kind == "decode":
        return 0.0, 0.0
    from ..models.transformer import segment_layout
    mult = 4.0 if kind == "train" else 1.0
    b = batch
    add_f, add_by = 0.0, 0.0

    def attn_cost(s_q, s_kv, eff, n_heads, n_kv, dh, q_block):
        f = 4.0 * b * s_q * eff * n_heads * dh            # QKᵀ + PV
        nq = -(-s_q // min(q_block, s_q))
        by = nq * s_kv * b * n_kv * dh * 2 * 2            # K,V re-read / block
        return f, by

    pattern_layers = []
    for pat, reps in segment_layout(cfg.n_layers, cfg.pattern):
        pattern_layers += list(pat) * reps
    d = cfg.d_model
    for spec in pattern_layers:
        if spec.mixer == "attn":
            s_q = max(seq // cfg.dec_ratio, 16) if cfg.encoder_decoder else seq
            if spec.attn_kind == "local" and cfg.window:
                eff = min(cfg.window, s_q)
            elif spec.attn_kind == "chunked" and cfg.chunk_attn:
                eff = min(cfg.chunk_attn, s_q) / 2
            else:
                eff = s_q / 2 if spec.causal else s_q
            f, by = attn_cost(s_q, s_q, eff, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                              cfg.q_block)
            add_f += mult * f
            add_by += mult * by
            if spec.cross_attn:
                f, by = attn_cost(s_q, seq, seq, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                                  cfg.q_block)
                add_f += mult * f
                add_by += mult * by
        elif spec.mixer == "mamba":
            di, n = 2 * d, cfg.d_state
            add_f += mult * 10.0 * b * seq * di * n       # discretize+scan+C
            add_by += mult * 3.0 * b * seq * di * n * 4   # chunk state IO
        elif spec.mixer == "mlstm":
            di = 2 * d
            l = min(cfg.mlstm_chunk, seq)
            add_f += mult * 4.0 * b * seq * l * di        # intra-chunk scores
            add_by += mult * 2.0 * b * seq * l * cfg.n_heads * 4
        elif spec.mixer == "slstm":
            dh = d // cfg.n_heads
            add_f += mult * b * seq * (8.0 * d * dh + 30.0 * d)
            add_by += mult * b * seq * d * 4 * 4
    if cfg.encoder_decoder:  # encoder stack (bidirectional full attention)
        f, by = attn_cost(seq, seq, seq, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                          cfg.q_block)
        add_f += cfg.n_enc_layers * mult * f
        add_by += cfg.n_enc_layers * mult * by
    return add_f, add_by


def _bytes(tree, specs, sizes) -> float:
    """Bytes of every leaf's block under `specs`."""
    flat = dict(leaves_with_paths(specs))
    return float(sum(math.prod(block_shape(tuple(a.shape), flat[path], sizes))
                     * a.element_size() for path, a in leaves_with_paths(tree)))


def _compute_bytes(tree, specs, sizes) -> float:
    """Bytes of every leaf as a device multiplies it: split over `model`
    only (FSDP gathers the `data` blocks whole)."""
    flat = dict(leaves_with_paths(specs))
    model = sizes.get("model", 1)
    return float(sum(a.numel() * a.element_size() / (model if "model" in flat[path] else 1)
                     for path, a in leaves_with_paths(tree)))


def _dry_cfg(cfg, n_layers: int, seq: int):
    """cfg at n_layers (and as many encoder layers, up to its own), its
    attention one block and its Mamba scan one chunk: the same collectives."""
    return dataclasses.replace(
        cfg, n_layers=n_layers, q_block=seq, kv_block=seq, mamba_scan_chunk=seq,
        n_enc_layers=min(n_layers, cfg.n_enc_layers) if cfg.encoder_decoder else 0)


def _step_log(cfg, kind: str, seq: int, batch: int, sizes: dict, grad_accum: int) -> list:
    """The collectives of one step of cfg on the dry mesh."""
    lm = LM(cfg)
    mesh = DryMesh({"data": sizes.get("data", 1) * sizes.get("pod", 1),
                    "model": sizes.get("model", 1)})
    structs, specs = init_shapes(lm)
    p_sh = param_shardings(mesh, structs, specs)
    params = _meta_blocks(structs, p_sh, mesh)
    grad = contextlib.nullcontext() if kind == "train" else torch.no_grad()
    with comm.record() as log, grad:
        if kind == "train":
            opt_cfg = AdamWConfig(use_8bit=cfg.opt_8bit)
            o_structs = init_opt_shapes(structs, opt_cfg)
            opt = _meta_blocks(o_structs, opt_shardings(mesh, o_structs, p_sh), mesh)
            step = make_train_step(lm, make_ctx(mesh), opt_cfg, grad_accum=grad_accum)
            step(params, opt, input_structs(cfg, "train", seq, batch))
        elif kind == "prefill":
            make_prefill_step(lm, make_ctx(mesh))(params,
                                                   input_structs(cfg, "prefill", seq, batch))
        else:
            ctx = make_ctx(mesh, seq_sharded=False)
            n_dp = sizes.get("data", 1) * sizes.get("pod", 1)
            rows = batch // n_dp if batch % n_dp == 0 else batch  # a data rank's rows
            enc_len = seq if cfg.encoder_decoder else 0
            max_len = max(seq // cfg.dec_ratio, 448) if cfg.encoder_decoder else seq
            cache = lm.init_cache(rows, max_len, enc_len=enc_len, device="meta", ctx=ctx)
            lm.decode_step(params, ctx, torch.empty((rows, 1), dtype=torch.int32,
                                                    device="meta"), cache, 0)
    return log


def _meta_blocks(structs, specs, mesh):
    """Meta tensors of a rank's blocks."""
    return map_with_specs(lambda path, a, spec: torch.empty(
        block_shape(tuple(a.shape), spec, mesh), dtype=a.dtype, device="meta"), structs, specs)


def _seq_points(cfg, seq: int, tp: int) -> tuple[int, int]:
    """Two short sequence lengths at which a train or prefill step's
    collectives are affine in the length: multiples of the model axis
    (its rows split), past the image prefix, and an enc-dec decoder's rows
    (seq // dec_ratio) a multiple of it too."""
    base = tp * (-(-(cfg.n_image_tokens + tp) // tp))
    if cfg.encoder_decoder:
        base = max(base, tp * cfg.dec_ratio)
    return min(base, seq), min(2 * base, seq)


def _combine(points: dict, at: tuple) -> dict:
    """{"total_wire_bytes", "count", "by_op"} at `at` = (seq, n_layers),
    bilinear in the two from the four corners (s1|s2, n1|n2) of `points`."""
    ss, (n1, n2) = sorted({k[0] for k in points}), sorted({k[1] for k in points})
    s1, s2 = ss[0], ss[-1]
    if s1 == s2:  # one length: constant in it
        s2 = s1 + 1
        points = {**points, (s2, n1): points[(s1, n1)], (s2, n2): points[(s1, n2)]}
    u, v = (at[0] - s1) / (s2 - s1), (at[1] - n1) / (n2 - n1)

    def lerp(get):
        f11, f21 = get(points[(s1, n1)]), get(points[(s2, n1)])
        f12, f22 = get(points[(s1, n2)]), get(points[(s2, n2)])
        return f11 + u * (f21 - f11) + v * (f12 - f11) + u * v * (f22 - f21 - f12 + f11)
    ops = set().union(*(p["by_op"] for p in points.values()))
    return {"total_wire_bytes": lerp(lambda p: p["total_wire_bytes"]),
            "count": lerp(lambda p: p["count"]),
            "by_op": {op: lerp(lambda p, op=op: p["by_op"].get(op, 0.0)) for op in sorted(ops)}}


def collective_schedule(cfg, kind: str, seq: int, batch: int, sizes: dict,
                        grad_accum: int = 1, exact: bool = False) -> dict:
    """Wire bytes and collectives per device of one step at full depth and
    length: the step run at one and two repeats of the pattern and (train,
    prefill) at two short lengths, each count bilinear in depth and length
    (the per-repeat collectives do not depend on the depth, and each is
    affine in the rows), extrapolated; `exact` runs the full length."""
    plen = len(cfg.pattern)
    seqs = ((seq, seq) if exact or kind == "decode"
            else _seq_points(cfg, seq, sizes.get("model", 1)))
    points = {}
    for s in sorted(set(seqs)):
        for n in (plen, 2 * plen):
            points[(s, n)] = collective_bytes(_step_log(_dry_cfg(cfg, n, s), kind, s, batch,
                                                        sizes, grad_accum))
    return _combine(points, (seq, cfg.n_layers))


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, out_dir: str = "results/dryrun_torch",
             grad_accum: int = 1, reduced: int | None = None, extra_tag: str = "",
             optimized: bool = False, write: bool = True) -> dict:
    cfg = get_config(arch)
    if optimized:  # the reference's §Perf variant (manual-SP MLP collectives)
        cfg = dataclasses.replace(cfg, manual_sp=True)
        extra_tag = extra_tag or "opt"
    sh = SHAPES[shape_name]
    mesh_tag = "pod2x16x16" if multi_pod else "pod16x16"
    rec = dict(arch=arch, shape=shape_name, mesh=mesh_tag)
    skip = should_skip(cfg, shape_name)
    if skip:
        rec["skipped"] = skip
        if write:
            _write(out_dir, rec, extra_tag)
        return rec
    sizes = production_sizes(multi_pod)
    n_chips = math.prod(sizes.values())
    seq, batch = sh["seq"], sh["batch"]
    if reduced:
        seq, batch = max(seq // reduced, 128), max(batch // reduced, 1)
    kind = sh["kind"]

    t0 = time.perf_counter()
    lm = LM(cfg)
    structs, specs = init_shapes(lm)
    p_sh = param_shardings(sizes, structs, specs)
    n_active = count_active_params(cfg, structs)
    rec["n_params"] = float(sum(a.numel() for a in nn.tree_leaves(structs)))
    rec["n_params_active_nonembed"] = float(n_active)
    tokens = batch * seq if kind in ("train", "prefill") else batch
    rec["model_flops"] = model_flops(n_active, tokens, "train" if kind == "train" else "serve")
    mem = {"param_bytes": _bytes(structs, p_sh, sizes), "opt_bytes": 0.0, "cache_bytes": 0.0,
           "batch_bytes": 0.0}
    w_dev = _compute_bytes(structs, p_sh, sizes)
    if kind == "train":
        o_structs = init_opt_shapes(structs, AdamWConfig(use_8bit=cfg.opt_8bit))
        mem["opt_bytes"] = _bytes(o_structs, opt_shardings(sizes, o_structs, p_sh), sizes)
        b_structs = input_structs(cfg, "train", seq, batch)
        mem["batch_bytes"] = _bytes(b_structs, batch_shardings(sizes, b_structs), sizes)
    elif kind == "decode":
        enc_len = seq if cfg.encoder_decoder else 0
        max_len = max(seq // cfg.dec_ratio, 448) if cfg.encoder_decoder else seq
        c_structs = lm.init_cache(batch, max_len, enc_len=enc_len, device="meta")
        mem["cache_bytes"] = _bytes(c_structs, cache_shardings(
            sizes, c_structs, long_context=seq >= 500_000), sizes)
    rec["memory"] = dict(mem, held_bytes=sum(mem.values()))

    coll = collective_schedule(cfg, kind, seq, batch, sizes, grad_accum)
    rec["collectives"] = coll
    add_f, add_by = inner_loop_correction(cfg, kind, seq, batch)
    flops = (rec["model_flops"] + add_f) / n_chips
    if kind == "train":
        bytes_acc = 3 * w_dev + 2 * (mem["param_bytes"] + mem["opt_bytes"]) + add_by / n_chips
    elif kind == "prefill":
        bytes_acc = w_dev + add_by / n_chips
    else:
        bytes_acc = w_dev + mem["cache_bytes"]
    rec["cost"] = dict(per_device_flops=flops, per_device_bytes=bytes_acc,
                       weight_bytes_multiplied=w_dev, inner_loop_flops_global=add_f,
                       inner_loop_bytes_global=add_by)
    rec["roofline"] = roofline_terms(flops, bytes_acc, coll["total_wire_bytes"])
    rec["n_chips"] = n_chips
    rec["cost_s"] = time.perf_counter() - t0
    if write:
        _write(out_dir, rec, extra_tag)
    return rec


def _write(out_dir, rec, extra_tag=""):
    os.makedirs(out_dir, exist_ok=True)
    tag = f"__{extra_tag}" if extra_tag else ""
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}{tag}.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(rec, f, indent=1, default=float)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--opt", action="store_true",
                    help="cost the reference's optimized variant (manual-SP MLP); "
                         "records tagged __opt")
    args = ap.parse_args(argv)

    archs = ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = sorted(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}×{shape}×{'2x16x16' if mp else '16x16'}"
                try:
                    rec = run_cell(arch, shape, multi_pod=mp, out_dir=args.out,
                                   grad_accum=args.grad_accum, optimized=args.opt)
                    status = ("SKIP: " + rec["skipped"]) if "skipped" in rec else (
                        f"ok cost={rec['cost_s']:.1f}s "
                        f"held={rec['memory']['held_bytes'] / 2**30:.2f}GiB "
                        f"wire={rec['collectives']['total_wire_bytes'] / 2**30:.2f}GiB "
                        f"dominant={rec['roofline']['dominant']}")
                    print(f"[dryrun] {tag}: {status}", flush=True)
                except Exception as e:  # noqa: BLE001 — a cell's failure is reported, the sweep goes on
                    failures += 1
                    print(f"[dryrun] {tag}: FAIL {e}", flush=True)
                    traceback.print_exc()
    if failures:
        print(f"{failures} dry-run cells failed", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
