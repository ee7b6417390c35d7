"""On the card: one short run of a cell, untraced and traced, through the
command in BENCHMARK.json.  Skips where there is no card."""

import json
import subprocess
import sys

import pytest

from perfbench import harness


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_on_the_card(trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the port on the card")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "d4_live_b32_p10k",
                          "--seed", "2147483659", "--seconds", "2", "--trace", str(trace)],
                         cwd=harness.REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
    if trace:
        assert line["device"]["busy_s"] > 0 and "k2_roofline" in line["metrics"]
