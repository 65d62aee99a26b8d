"""On the card: one short run of each cell through ``run.py``, its
result line as the contract reads it. Skips without a card."""
import json
import subprocess
import sys

import pytest

import smoke


@pytest.mark.cuda
@pytest.mark.parametrize("cell,metrics", [
    ("resnet8-w4a8.frames-16384", {"setup_s", "images_per_s",
                                   "wave_p95_ms"}),
    ("phi3-mini-w4a8.prefill-8x2048", {"setup_s", "prefill_tok_s"}),
])
def test_cell_runs_on_the_card(cell, metrics):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         "2147483999", "--seconds", "2", "--trace", "0"],
        cwd=smoke.ROOT, capture_output=True, text=True, timeout=1500)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert set(res["metrics"]) == metrics
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert list(res)[-1] == "checks"
    assert proc.stderr.strip().splitlines()[-1].startswith("check ")
