"""The benchmark's cells on the card, each for a few seconds: the run
exits 0 and its last line is a correct result. Marked ``gpu``; skips
inside the test without a card. On the card:

    python -m pytest -q -m gpu sketchbench/tests/test_sketchbench_gpu.py
"""

import json
import subprocess
import sys

import pytest

from sketchbench.catalog import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_runs_correct_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "sketchbench/run.py", "--workload", cell,
         "--seed", "2147483659", "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
