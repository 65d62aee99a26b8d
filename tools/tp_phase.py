#!/usr/bin/env python3
"""Run `chip_smoke.py`'s [tp] phase alone, then the card tests of tensor
parallelism.

    python3 tools/tp_phase.py      # from the repository root, one GPU

Builds kernels 1-3 (`qmatmul`, `qmatmul_segmented`), calls
`chip_smoke.tp_path` (qwen2.5-3b at full depth meshless and on (1,2),
(1,4), (2,2), the other families on (1,2), olmo-1b training), prints its
launch counts and writes ``chiprun_out/probe_tp.json``; a failure of
the phase is printed and the tests still run:
``pytest -m cuda tests/test_torch_cuda.py -k "tp_card or row_parallel"``.
"""
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("tp_phase: torch sees no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels.build import build_all

    t0 = time.perf_counter()
    ks = cs.kernels_by_name()
    print("build_s", build_all([ks["qmatmul"], ks["qmatmul_segmented"]]),
          flush=True)
    report = {}
    (ROOT / "build").mkdir(exist_ok=True)
    work = pathlib.Path(tempfile.mkdtemp(prefix="tp_", dir=ROOT / "build"))
    failed = False
    try:
        launches = cs.tp_path(torch.device("cuda"), work, report)
        print("launches", json.dumps(launches), flush=True)
    except Exception as e:  # printed; the card tests still run
        import traceback
        traceback.print_exc()
        print("TP PHASE FAILED", e, flush=True)
        failed = True
    finally:
        shutil.rmtree(work, ignore_errors=True)
    cs.write_report(report, "probe_tp")
    print("tp phase done at", round(time.perf_counter() - t0, 1), flush=True)
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "cuda",
         "-p", "no:cacheprovider", "tests/test_torch_cuda.py",
         "-k", "tp_card or row_parallel"], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH="src"), capture_output=True,
        text=True)
    print(r.stdout[-4000:], r.stderr[-2000:], flush=True)
    print("total", round(time.perf_counter() - t0, 1), flush=True)
    return 1 if failed or r.returncode else 0


if __name__ == "__main__":
    sys.exit(main())
