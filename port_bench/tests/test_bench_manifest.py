"""BENCHMARK.json against the contract's limits, and the name checks."""

import copy
import json

import pytest

from bench_test_util import ROOT

from harness.manifest import Bench, ManifestError, validate


def bench_data():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_is_valid_and_every_file_is_found():
    bench = Bench(ROOT)
    for w in bench.data["workloads"]:
        cell = bench.cell(w["name"])
        assert bench.driver(cell["driver"]).make
        e2e, layer = bench.metrics(w["name"])
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert layer
        for m in e2e + layer:
            assert callable(bench.reader(m["name"]).read)
        assert set(cell["workload"]["limits"])


def test_config_files_state_every_reduced_key():
    bench = Bench(ROOT)
    for c in bench.data["configs"]:
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["reduced"] == c["reduced"]


def _broken(path, value):
    data = bench_data()
    node = data
    for key in path[:-1]:
        node = node[key]
    node[path[-1]] = value
    return data


@pytest.mark.parametrize("path, value", [
    (("workloads", 0, "name"), "has space"),
    (("workloads", 0, "name"), "slash/name"),
    (("workloads", 0, "name"), ".starts_with_dot"),
    (("workloads", 0, "name"), "x" * 65),
    (("end_to_end", 0, "unit"), "env steps per second"),
    (("end_to_end", 0, "unit"), "µs"),
    (("end_to_end", 0, "bound"), 0.3),
    (("end_to_end", 0, "bound"), 0.001),
    (("end_to_end", 0, "better"), "faster"),
    (("end_to_end", 0, "source"), "program_span"),
    (("workloads", 0, "chips"), 2),
    (("workloads", 0, "why"), "two\nlines"),
    (("configs", 0, "file"), "elsewhere/doorkey8x8.json"),
    (("per_layer", 0, "moves"), "not_a_metric"),
    (("per_layer", 0, "workloads"), ["no.such.cell"]),
    (("run_seconds",), 52),
    (("command",), ["python3", "/abs/run.py"]),
    (("paths",), ["../outside"]),
])
def test_a_broken_field_is_refused(path, value):
    with pytest.raises(ManifestError):
        validate(_broken(path, value))


@pytest.mark.parametrize("where, key", [
    ("top", "extra"), ("end_to_end", "why"), ("workloads", "extra")])
def test_an_unknown_key_is_refused(where, key):
    data = bench_data()
    if where == "top":
        data[key] = 1
    else:
        data[where][0][key] = "x"
    with pytest.raises(ManifestError):
        validate(data)


def test_setup_s_is_required_and_names_are_unique():
    data = bench_data()
    data["end_to_end"] = [m for m in data["end_to_end"]
                          if m["name"] != "setup_s"]
    with pytest.raises(ManifestError):
        validate(data)
    data = bench_data()
    data["per_layer"].append(copy.deepcopy(data["per_layer"][0]))
    with pytest.raises(ManifestError):
        validate(data)


def test_a_cell_without_a_per_layer_metric_is_refused():
    data = bench_data()
    cell = data["workloads"][0]["name"]
    data["per_layer"] = [m for m in data["per_layer"]
                         if cell not in m.get("workloads", [])]
    with pytest.raises(ManifestError):
        validate(data)
