"""On a card: each cell's run prints a result line of the contract's form,
correct, with every per-layer metric the cell lists."""
import json
import os
import subprocess
import sys

import pytest

from benchmark import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("name", [w["name"] for w in harness.manifest()["workloads"]
                                  if w["chips"] == 1])
def test_traced_run(card, name):
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name, "--seed",
                        str(2 ** 31 + 5), "--seconds", "1", "--trace", "1"], cwd=ROOT,
                       capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert out["device"]["platform"] == "gpu" and out["device"]["busy_s"] > 0
    assert set(out["metrics"]) == {m["name"] for m in harness.load_cell(name)["per_layer"]}
