import copy
import json

import pytest

from perfbench import manifest


def test_benchmark_json_is_sound():
    m = manifest.load_manifest()
    assert manifest.check_manifest(m) == []
    assert m["command"] == ["python3", "perfbench/run.py"] and m["paths"] == ["perfbench"]
    assert 1 <= m["run_seconds"] <= 51 and isinstance(m["run_seconds"], int)
    assert len(json.dumps(m)) < 64 * 1024


def test_names_and_units_use_the_allowed_characters():
    m = manifest.load_manifest()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in m[k]]
    names += [w["config"] for w in m["workloads"]] + [w["traffic"] for w in m["workloads"]]
    assert all(manifest.NAME.fullmatch(n) for n in names), names
    units = [x["unit"] for k in ("end_to_end", "per_layer") for x in m[k]]
    assert all(manifest.UNIT.fullmatch(u) for u in units), units
    assert all(x["name"].endswith("_roofline") == (x["unit"] == "%" and "roofline" in x["name"])
               for x in m["per_layer"] if "roofline" in x["name"])


def test_every_cell_reports_setup_another_end_to_end_and_a_layer_metric():
    m = manifest.load_manifest()
    for w in m["workloads"]:
        cell = manifest.load_cell(m, w["name"])
        e2e = {x["name"] for x in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
        assert set(cell.workload["limits"]) and cell.workload["sample"] >= 1
        for x in cell.per_layer:
            assert x["moves"] in e2e


def test_every_metric_has_a_reader():
    m = manifest.load_manifest()
    for x in [*m["end_to_end"], *m["per_layer"]]:
        assert callable(manifest.reader(x["name"]))


@pytest.mark.parametrize(("path", "value", "finding"), [
    (("end_to_end", 0, "bound"), 0.3, "source or bound"),
    (("per_layer", 0, "moves"), "nothing", "moves"),
    (("workloads", 0, "chips"), 2, "chips"),
    (("per_layer", 0, "name"), "has space", "name"),
    (("end_to_end", 0, "unit"), "ms per call", "unit"),
])
def test_malformed_manifests_are_refused(path, value, finding):
    m = copy.deepcopy(manifest.load_manifest())
    kind, i, key = path
    m[kind][i][key] = value
    assert any(finding in b for b in manifest.check_manifest(m))
