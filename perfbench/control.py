"""The readings a cell's correctness limits are set from.  Not run by the benchmark.

    python3 perfbench/control.py --workload <cell> --seeds 11,12,... \\
        [--control-seeds 11,12,13] [--decompositions 2] [--out readings.jsonl]

For each seed, in one process: the cell's tensor and engine as a run builds them,
`--decompositions` of the window's own calls, and `check.readings` of each against
the reference (the lower reading is the largest over the seeds).  For each control
seed, the same decompositions with the control in the program's place: the
traffic's `control` names either a reference precision (the float engines: TF32,
the step below float32) or engine options of the program's own lower path (the
fixed engine: its int7 preset, the step below int15-12).  The upper reading is the
smallest over the control seeds.  Each seed prints one JSON line.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="perfbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--decompositions", type=int, default=2)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from perfbench import check, harness, manifest, reference

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = manifest.load_cell(manifest.load_manifest(), args.workload)
    control = cell.traffic["control"]
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control_seeds = {int(s) for s in args.control_seeds.split(",") if s}
    out = open(args.out, "a") if args.out else None  # noqa: SIM115
    for seed in sorted(set(seeds) | control_seeds):
        t = time.perf_counter()
        line = {"cell": cell.name, "seed": seed}
        indices = list(range(args.decompositions))
        if seed in seeds or "reference" in control:
            prog = harness.Program(cell, seed, args.device)
            results = [(i, prog.decompose(i)) for i in indices]
            prog.free()
            if seed in seeds:
                line["program"] = check.judge(
                    harness.reference_readings(prog, results, cell.traffic["reference"]),
                    {})[1]
            if seed in control_seeds and "reference" in control:
                c = torch.from_numpy(prog.coords).to(prog.dev)
                v = torch.from_numpy(prog.values).to(prog.dev)
                ctl = [(i, reference.cp_als_ref(
                    c, v, prog.shape, prog.rank, prog.n_iters,
                    harness.decomposition_seed(seed, i), precision=control["reference"]))
                    for i in indices]
                del c, v
                line["control"] = check.judge(
                    harness.reference_readings(prog, ctl, cell.traffic["reference"]), {})[1]
            del prog, results
        if seed in control_seeds and "engine_options" in control:
            prog = harness.Program(cell, seed, args.device,
                                   engine_options=control["engine_options"])
            results = [(i, prog.decompose(i)) for i in indices]
            prog.free()
            line["control"] = check.judge(
                harness.reference_readings(prog, results, cell.traffic["reference"]), {})[1]
            del prog, results
        line["seconds"] = time.perf_counter() - t
        text = json.dumps(line)
        print(text, flush=True)
        if out:
            print(text, file=out, flush=True)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
