"""The harness finds every cell, configuration, traffic mix, driver,
limit file and metric by name, and ``BENCHMARK.json`` keeps to the
benchmark's contract."""
import json
import re

import pytest
from conftest import ROOT

from portbench.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    assert isinstance(bench["run_seconds"], int)
    assert len(json.dumps(bench)) <= 64 * 1024
    assert bench["command"] == ["python3", "portbench/run.py"]
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()


def test_configs(bench):
    names = [c["name"] for c in bench["configs"]]
    assert len(names) == len(set(names))
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["why"])
        assert one_line(c["source"]) and c["name"] in used
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        data = spec.config(c["name"])
        assert data["name"] == c["name"]
        # every key cut from the source is listed, with its reason
        assert sorted(c["reduced"]) == sorted(data["reduced"])
        for key in c["reduced"]:
            assert NAME.match(key)
            assert data["published"][key] != data[key]
        for key, value in data["published"].items():
            if key not in c["reduced"]:
                assert data[key] == value, key


def test_cells_find_their_files(bench):
    seen = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and one_line(w["why"])
        assert w["chips"] == 1
        assert (w["config"], w["traffic"]) not in seen
        seen.add((w["config"], w["traffic"]))
        spec.config(w["config"])
        driver = spec.driver(spec.traffic(w["traffic"])["driver"])
        for method in ("setup", "window", "work", "attempted", "release",
                       "check", "failed", "close"):
            assert callable(getattr(driver, method)), method
        assert spec.limits(w["name"])
        e2e = {m["name"] for m in spec.end_to_end(bench, w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.per_layer(bench, w["name"])


def test_metrics(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert callable(spec.reader(m["name"]))
    layers = {}
    for m in bench["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert one_line(m["layer"]) and m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        for cell in m["workloads"]:
            assert m["moves"] in {x["name"] for x in
                                  spec.end_to_end(bench, cell)}
        layers.setdefault(m["layer"], []).append(m["name"])
        assert callable(spec.reader(m["name"]))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in bench["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_missing_names_are_refused(bench):
    with pytest.raises(KeyError):
        spec.workload(bench, "no-such-cell")
    for find in (spec.config, spec.traffic, spec.limits, spec.reader,
                 spec.driver):
        with pytest.raises(FileNotFoundError):
            find("no-such-name")


def test_limits_files_name_their_readings(bench):
    for w in bench["workloads"]:
        path = ROOT / "portbench" / "limits" / f"{w['name']}.json"
        data = json.loads(path.read_text())
        assert set(data) == {"limits", "set_from"}
        for name, limit in data["limits"].items():
            assert limit >= 0, name
