"""The run's guards: no JAX and no JAX package loaded (whole top-level
names), no result without a card, no result without the port."""
import json
import shutil
import subprocess
import sys

import smoke
from portbench.harness import guard


def test_forbidden_names_compare_whole_top_level():
    assert guard.forbidden_loaded(["repro_torch", "repro_torch.kernels",
                                   "reprox", "jaxtyping", "torch"]) == []
    assert guard.forbidden_loaded(["repro.core.quantize", "repro_torch"]) \
        == ["repro"]
    assert guard.forbidden_loaded(["jax", "jaxlib.xla", "flax.linen"]) == [
        "flax", "jax", "jaxlib"]


def test_this_process_guard_reads_sys_modules():
    assert guard.forbidden_loaded() == sorted(
        t for t in guard.FORBIDDEN
        if t in {n.split(".")[0] for n in sys.modules})


def _run(cwd, script):
    return subprocess.run(
        [sys.executable, str(script), "--workload",
         "resnet8-w4a8.frames-16384", "--seed", "3000000001",
         "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def _no_result(proc):
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        try:
            json.loads(line)
        except ValueError:
            continue
        raise AssertionError(f"a result was printed: {line}")


def test_no_result_without_a_card_or_the_port(tmp_path):
    proc = _run(smoke.ROOT, smoke.BENCH / "run.py")
    _no_result(proc)
    assert "portbench:" in proc.stderr
    # a directory with BENCHMARK.json and the benchmark's files only
    shutil.copy(smoke.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(smoke.BENCH, tmp_path / "portbench")
    _no_result(_run(tmp_path, tmp_path / "portbench" / "run.py"))
