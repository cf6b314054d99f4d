"""On the card: a short run of each cell through the command line, and
the controls at the cell's own size on one seed. Run there with
``python3 -m pytest port_bench/tests -m gpu``."""

import json
import subprocess
import sys

import pytest

from bench_test_util import ROOT, cuda_device  # noqa: F401

from harness.control import readings
from harness.manifest import Bench

CELLS = [w["name"] for w in Bench(ROOT).data["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct(cuda_device, cell):
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                          cell, "--seed", "2147483999", "--seconds", "2"],
                         capture_output=True, text=True, timeout=900,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_at_full_size(cuda_device, cell):
    lim = Bench(ROOT).cell(cell)["workload"]["limits"]
    got = readings(ROOT, cell, 7, 3.0, cuda_device)
    assert all(got["program"][k] <= lim[k] for k in lim)
    controls = [v for k, v in got.items() if k.startswith("control")]
    assert controls and all(any(c[k] > lim[k] for k in lim)
                            for c in controls)
