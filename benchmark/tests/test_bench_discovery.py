"""The harness finds every configuration, workload, driver and metric by
the name BENCHMARK.json gives it, a new cell or metric is found as new
files and entries alone, and BENCHMARK.json keeps to its format's
shapes."""

import json
import re
import shutil

import pytest

from benchmark import harness

ROOT = harness.ROOT
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_found_by_name(cell):
    c = harness.Cell(cell)
    assert c.workload["config"] == c.entry["config"]
    assert c.workload["why"] == c.entry["why"]
    for fn in ("setup", "window", "trace", "check"):
        assert callable(getattr(c.driver, fn))
    names = [m["name"] for m in c.metrics(False) + c.metrics(True)]
    assert "setup_s" in names
    for m in names:
        assert callable(c.reader(m).read)
    assert len(c.metrics(False)) >= 2 and c.metrics(True)


def test_new_cell_and_metric_are_files_and_entries(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark")
    spec = json.loads(json.dumps(SPEC))
    wl = json.loads((ROOT / "benchmark/workloads/vo.map.json").read_text())
    wl["traffic"]["keyframes"] = 96
    (tmp_path / "benchmark/workloads/vo.half.json").write_text(
        json.dumps(wl))
    (tmp_path / "benchmark/metrics/steps_seen.py").write_text(
        "def read(record):\n    return record.get('steps')\n")
    spec["workloads"].append(dict(SPEC["workloads"][0], name="vo.half"))
    spec["per_layer"].append(dict(SPEC["per_layer"][0], name="steps_seen",
                                  workloads=["vo.half"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    c = harness.Cell("vo.half", root=tmp_path)
    assert c.workload["traffic"]["keyframes"] == 96
    assert [m["name"] for m in c.metrics(True)][-1] == "steps_seen"
    assert c.reader("steps_seen").read({"steps": 5}) == 5
    with pytest.raises(KeyError):
        harness.Cell("vo.none", root=tmp_path)


def test_spec_shapes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    for p in SPEC["paths"]:
        assert (ROOT / p).is_dir() and not p.startswith("/")
    cfgs = {c["name"] for c in SPEC["configs"]}
    used = {w["config"] for w in SPEC["workloads"]}
    assert cfgs == used
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] \
            == c["reduced"]
    pairs = {(w["config"], w["traffic"]) for w in SPEC["workloads"]}
    assert len(pairs) == len(SPEC["workloads"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("metric", SPEC["end_to_end"],
                         ids=[m["name"] for m in SPEC["end_to_end"]])
def test_bound_is_the_documented_one(metric):
    """PERF.md's table of end-to-end metrics gives each bound that
    BENCHMARK.json holds, with the readings it was set from."""
    rows = [r.split("|") for r in (ROOT / "PERF.md").read_text().splitlines()
            if r.startswith(f"| `{metric['name']}` |")]
    assert len(rows) == 1, rows
    assert float(rows[0][4]) == metric["bound"]
