"""Tiny versions of the benchmark's cells, for the CPU tests."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

from perfbench import manifest  # noqa: E402

SIZES = {
    "nell2.kernel": ((120, 92, 288), 20_000),
    "lbnl.kernel": ((40, 50, 30, 45, 9_000), 8_000),
    "lbnl.fixed-int15-12": ((40, 50, 30, 45, 9_000), 8_000),
}


def tiny_cell(name: str, **traffic) -> manifest.Cell:
    """The cell as `BENCHMARK.json` has it, its tensor cut to `SIZES[name]` and its
    traffic updated by `traffic`."""
    cell = manifest.load_cell(manifest.load_manifest(), name)
    shape, nnz = SIZES[name]
    cell.config = dict(cell.config, shape=list(shape), nnz=nnz)
    cell.traffic = dict(cell.traffic, **traffic)
    return cell
