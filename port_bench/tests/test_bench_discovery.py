"""A configuration, a cell and a per-layer metric are added as files and
entries alone: the harness finds each by its name, with no code edited."""

import json
import shutil

from bench_test_util import BENCH, ROOT, run_tiny

from harness.manifest import Bench


def test_new_config_cell_and_metric_are_found_from_files(tmp_path):
    shutil.copytree(BENCH, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    d = tmp_path / "port_bench"
    config = json.loads((d / "configs" / "doorkey8x8.json").read_text())
    config["env"].update(id="MiniGrid-DoorKey-5x5-v0", size=5, max_steps=250)
    (d / "configs" / "doorkey5x5.json").write_text(json.dumps(config))
    traffic = json.loads((d / "traffic" / "vector_regen.json").read_text())
    traffic["num_envs"] = 32
    (d / "traffic" / "vector_small.json").write_text(json.dumps(traffic))
    (d / "workloads" / "doorkey5x5.vector_small.json").write_text(json.dumps(
        {"config": "doorkey5x5", "traffic": "vector_small", "chips": 1,
         "limits": {"env_mismatches": 0}}))
    (d / "metrics" / "episodes_ended_per_s.env.py").write_text(
        '"""episodes_ended_per_s.env: episodes the host counted ended, a '
        'second."""\n\n\ndef read(run):\n'
        '    return run.window["episodes_ended"] / run.window["seconds"]\n')
    data["configs"].append({
        "name": "doorkey5x5", "source": "https://example.org/doorkey5x5",
        "file": "port_bench/configs/doorkey5x5.json", "reduced": [],
        "why": "a test's configuration"})
    data["workloads"].append({
        "name": "doorkey5x5.vector_small", "config": "doorkey5x5",
        "traffic": "vector_small", "chips": 1, "why": "a test's cell"})
    for m in data["end_to_end"]:
        if m["name"] in ("env_steps_per_s", "step_ms_p99"):
            m["workloads"].append("doorkey5x5.vector_small")
    data["per_layer"].append({
        "name": "episodes_ended_per_s.env", "unit": "episodes/s",
        "better": "higher", "source": "host_clock", "layer": "Env",
        "moves": "env_steps_per_s", "workloads": ["doorkey5x5.vector_small"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))

    bench = Bench(tmp_path)
    cell = bench.cell("doorkey5x5.vector_small")
    assert cell["config"]["env"]["size"] == 5 and cell["driver"] == "vector"
    _, layer = bench.metrics("doorkey5x5.vector_small")
    assert [m["name"] for m in layer] == ["episodes_ended_per_s.env"]

    out = run_tiny("doorkey5x5.vector_small", trace=True, root=tmp_path,
                   sizes={})
    assert out["correct"]
    assert out["metrics"]["episodes_ended_per_s.env"]["value"] > 0
    out = run_tiny("doorkey5x5.vector_small", root=tmp_path, sizes={})
    assert set(out["metrics"]) == {"env_steps_per_s", "step_ms_p99",
                                   "setup_s"}


def test_a_train_cell_of_another_reset_mode_is_data_alone(tmp_path):
    """DoorKey-8x8 trained with regen resets: a traffic file, a cell file
    and entries; the train driver and the reference already serve it."""
    shutil.copytree(BENCH, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    d = tmp_path / "port_bench"
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    traffic = {"driver": "train", "resets": "regen", "checked_steps": 3,
               "profiled_steps": 2}
    (d / "traffic" / "train_regen.json").write_text(json.dumps(traffic))
    limits = json.loads((d / "workloads" / "doorkey8x8.train_pooled.json")
                        .read_text())["limits"]
    (d / "workloads" / "doorkey8x8.train_regen.json").write_text(json.dumps(
        {"config": "doorkey8x8", "traffic": "train_regen", "chips": 1,
         "limits": limits}))
    data["workloads"].append({"name": "doorkey8x8.train_regen",
                              "config": "doorkey8x8",
                              "traffic": "train_regen", "chips": 1,
                              "why": "a test's cell"})
    for m in data["end_to_end"] + data["per_layer"]:
        if m["name"] in ("train_env_steps_per_s", "rollout_ms.train"):
            m["workloads"].append("doorkey8x8.train_regen")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    out = run_tiny("doorkey8x8.train_regen", root=tmp_path,
                   sizes={"ppo": {"num_envs": 32, "rollout_len": 8}})
    assert out["checks"]["env_mismatches"]["value"] == 0
    assert out["metrics"]["train_env_steps_per_s"]["value"] > 0


def test_a_listed_metric_that_reads_nothing_fails_the_traced_run(tmp_path):
    """A per-layer metric whose reader finds nothing in a cell that lists
    it (the program moved what it reads) stops the run: no result line
    that silently lacks it."""
    import pytest

    from harness.runner import MissingMetric

    shutil.copytree(BENCH, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    d = tmp_path / "port_bench"
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    (d / "metrics" / "nothing_ms.env.py").write_text(
        '"""nothing_ms.env: a span the program no longer has."""\n\n\n'
        'def read(run):\n    return None\n')
    # on the CPU the device's metrics read nothing too: leave them out
    data["per_layer"] = [m for m in data["per_layer"]
                         if "doorkey8x8.vector_regen" not in m["workloads"]]
    data["per_layer"].append({
        "name": "nothing_ms.env", "unit": "ms", "better": "lower",
        "source": "host_clock", "layer": "Env", "moves": "env_steps_per_s",
        "workloads": ["doorkey8x8.vector_regen"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    with pytest.raises(MissingMetric, match="nothing_ms.env"):
        run_tiny("doorkey8x8.vector_regen", trace=True, root=tmp_path)


def test_a_configuration_the_reference_does_not_implement_is_refused(
        tmp_path):
    import pytest

    shutil.copytree(BENCH, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    path = tmp_path / "port_bench" / "configs" / "doorkey8x8.json"
    config = json.loads(path.read_text())
    config["env"]["see_through_walls"] = True
    path.write_text(json.dumps(config))
    with pytest.raises(ValueError, match="see_through_walls"):
        run_tiny("doorkey8x8.vector_regen", root=tmp_path)
