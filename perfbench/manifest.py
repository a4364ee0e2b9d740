"""`BENCHMARK.json` and the files it names, found by name.

A cell of `workloads` names a configuration and a traffic mix; the harness reads

  configs/<config>.json, traffic/<traffic>.json, workloads/<cell>.json

under this folder, and each metric the cell reports from metrics/<metric>.py.  A
metric is reported in a cell when its entry has no `workloads` key or lists the
cell.  `check_manifest` holds the file to the benchmark's own rules of form, so a
malformed entry stops a run before any work.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

__all__ = ["Cell", "HERE", "ROOT", "check_manifest", "load_cell", "load_manifest", "reader"]

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    workload: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(manifest: dict, name: str, here: Path = HERE) -> Cell:
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: {sorted(cells)}")
    w = cells[name]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=json.loads((here / "configs" / f"{w['config']}.json").read_text()),
        traffic=json.loads((here / "traffic" / f"{w['traffic']}.json").read_text()),
        workload=json.loads((here / "workloads" / f"{name}.json").read_text()),
        end_to_end=[m for m in manifest["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in manifest["per_layer"] if _reports(m, name)],
    )


def reader(metric: str, here: Path = HERE):
    """The `read(run)` function of metrics/<metric>.py."""
    path = here / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _line(s) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def check_manifest(m: dict, here: Path = HERE) -> list[str]:
    """Every breach of form found in the manifest `m`; empty when it is sound."""
    bad = []
    keys = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    if set(m) != keys:
        bad.append(f"top-level keys {sorted(m)} are not {sorted(keys)}")
        return bad
    for kind, entry_keys in [("configs", {"name", "source", "file", "reduced", "why"}),
                             ("workloads", {"name", "config", "traffic", "chips", "why"}),
                             ("end_to_end", {"name", "unit", "better", "bound", "source"}),
                             ("per_layer", {"name", "unit", "better", "source", "layer",
                                            "moves"})]:
        for e in m[kind]:
            extra = set(e) - entry_keys - ({"workloads"} if kind in ("end_to_end", "per_layer")
                                           else set())
            if entry_keys - set(e) or extra:
                bad.append(f"{kind} entry {e.get('name')!r}: keys {sorted(e)}")
            if not NAME.fullmatch(str(e.get("name", ""))):
                bad.append(f"{kind} name {e.get('name')!r}")
    for group in (m["configs"], m["workloads"], [*m["end_to_end"], *m["per_layer"]]):
        names = [e.get("name") for e in group]
        if len(names) != len(set(names)):
            bad.append(f"duplicate names among {sorted(names)}")
    cells = {w["name"] for w in m["workloads"]}
    configs = {c["name"] for c in m["configs"]}
    e2e = {x["name"] for x in m["end_to_end"]}
    for c in m["configs"]:
        if not _line(c["source"]) or not _line(c["why"]):
            bad.append(f"config {c['name']}: source or why")
        if not (here.parent / c["file"]).is_file():
            bad.append(f"config {c['name']}: no file {c['file']}")
        if len(c["reduced"]) > 16 or not all(NAME.fullmatch(k) for k in c["reduced"]):
            bad.append(f"config {c['name']}: reduced")
    for w in m["workloads"]:
        if w["config"] not in configs or not NAME.fullmatch(w["traffic"]):
            bad.append(f"cell {w['name']}: config or traffic")
        if w["chips"] not in (1, 4) or not _line(w["why"]):
            bad.append(f"cell {w['name']}: chips or why")
        for p in (here / "traffic" / f"{w['traffic']}.json",
                  here / "workloads" / f"{w['name']}.json"):
            if not p.is_file():
                bad.append(f"cell {w['name']}: no file {p.relative_to(here.parent)}")
    for x in [*m["end_to_end"], *m["per_layer"]]:
        if not UNIT.fullmatch(str(x["unit"])) or x["better"] not in ("lower", "higher"):
            bad.append(f"metric {x['name']}: unit or better")
        if not set(x.get("workloads", [])) <= cells:
            bad.append(f"metric {x['name']}: unknown cells")
        if not (here / "metrics" / f"{x['name']}.py").is_file():
            bad.append(f"metric {x['name']}: no reader metrics/{x['name']}.py")
    for x in m["end_to_end"]:
        if x["source"] not in SOURCES_E2E or not 0 < x["bound"] <= 0.25:
            bad.append(f"metric {x['name']}: source or bound")
    for x in m["per_layer"]:
        if x["source"] not in SOURCES or not _line(x["layer"]) or x["moves"] not in e2e:
            bad.append(f"metric {x['name']}: source, layer or moves")
    if "setup_s" not in e2e:
        bad.append("no setup_s")
    return bad
