"""No JAX: the check compares whole top-level module names, and a run of
the harness loads none of them."""

import subprocess
import sys

from bench_test_util import BENCH, ROOT

from harness.guard import forbidden_modules


def test_whole_top_level_names_are_compared():
    mods = ["minigrid_tpu_torch", "minigrid_tpu_torch.envs.base",
            "minigrid_tpu_tools", "jaxtyping", "jax", "jax.numpy",
            "jaxlib.xla", "flax.linen", "minigrid_tpu", "minigrid_tpu.core",
            "torch"]
    assert forbidden_modules(mods) == ["flax.linen", "jax", "jax.numpy",
                                       "jaxlib.xla", "minigrid_tpu",
                                       "minigrid_tpu.core"]


def test_a_run_of_the_harness_loads_no_jax():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import torch; torch.set_num_threads(2)\n"
        "from harness.runner import run_cell\n"
        "from harness.guard import forbidden_modules\n"
        "out = run_cell(%r, 'doorkey8x8.vector_regen', 1, 0.2, False, "
        "device='cpu', sizes={'traffic': {'num_envs': 16}})\n"
        "assert out['correct'], out\n"
        "print('FORBIDDEN', forbidden_modules())\n"
        % (str(ROOT), str(BENCH), str(ROOT)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FORBIDDEN []" in out.stdout


def test_without_the_program_a_run_fails_and_prints_no_result(tmp_path):
    import shutil

    shutil.copytree(BENCH, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload",
         "doorkey8x8.train_pooled", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
