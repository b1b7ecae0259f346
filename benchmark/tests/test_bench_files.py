"""The harness finds its configurations, cells, phases and per-layer
readers by name, and a new file is picked up with no edit; `BENCHMARK.json`
keeps to the names and units the contract allows."""

import json
import re

import pytest

from benchmark import cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_of_benchmark_json_has_its_files():
    bench = cells.benchmark()
    for w in bench["workloads"]:
        wl = cells.workload(w["name"])
        assert wl["config"] == w["config"] and wl["chips"] == w["chips"]
        assert cells.config(wl["config"])
        assert hasattr(cells.phase(wl["phase"]), "build")
        assert wl["why"] == w["why"]
        assert wl["limits"] and set(wl["limits"]) <= {
            "loss_gap", "grad_gap", "change_gap"}
    for m in bench["per_layer"]:
        assert callable(cells.metric_reader(m["name"]).read)
    for c in bench["configs"]:
        assert cells.config(c["name"])["source"] == c["source"]


def test_names_units_and_keys_keep_to_the_contract():
    bench = cells.benchmark()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"] for m in bench["end_to_end"]} >= {"setup_s"}
    assert all(m["moves"] == "img_s" for m in bench["per_layer"])
    assert len(json.dumps(bench)) < 64 * 1024


def test_a_new_cell_and_a_new_reader_are_found_by_name(tmp_path):
    (tmp_path / "workloads").mkdir()
    (tmp_path / "metrics").mkdir()
    (tmp_path / "workloads" / "x.new.json").write_text(
        json.dumps({"config": "deit_s_ofb", "phase": "search"}))
    (tmp_path / "metrics" / "x.new_ms.py").write_text(
        "def read(t):\n    return 7.0\n")
    assert cells.workload("x.new", tmp_path)["phase"] == "search"
    assert cells.metric_reader("x.new_ms", tmp_path).read(None) == 7.0
    with pytest.raises(FileNotFoundError):
        cells.metric_reader("absent", tmp_path)


def test_a_metric_without_workloads_is_every_cells():
    bench = {"per_layer": [{"name": "a"}, {"name": "b", "workloads": ["c1"]}],
             "end_to_end": []}
    assert [m["name"] for m in cells.per_layer(bench, "c1")] == ["a", "b"]
    assert [m["name"] for m in cells.per_layer(bench, "c2")] == ["a"]
