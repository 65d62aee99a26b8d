#!/usr/bin/env python3
"""Whether the W2 QAT recipe trains the same qat-cnn twice on the card.

    python3 tools/qat_reproducibility.py      # from the repository root, one GPU

Runs the reference's W2 recipe (`tests/test_qat.py::test_qat_beats_ptq_at_w2`:
400 float steps, PTQ at W2, 600 W2 QAT steps, 500 test images at noise
0.45, jitter 3, seed 0) seven times in one process: three times as
`train_qat` runs it, twice under
``torch.backends.cudnn.flags(deterministic=True)``, twice under
``torch.use_deterministic_algorithms(True)``. (`train_qat` itself runs
cuDNN deterministic since the first three runs showed three models.) Prints one line per run
(PTQ and QAT accuracy, the last losses, the sum of c1's trained weights,
seconds) and writes ``chiprun_out/qat_reproducibility.json``.
"""
import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("qat_reproducibility: torch sees no CUDA device",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.qat.data import SyntheticDigits
    from repro_torch.qat.evaluate import deploy, evaluate_int
    from repro_torch.qat.train import QATConfig, train_qat
    from repro_torch.vision.configs import get_vision_config

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_vision_config("qat-cnn")
    data = SyntheticDigits(split="train", seed=0, noise=0.45, jitter=3)
    test = SyntheticDigits(split="test", seed=0, noise=0.45, jitter=3)

    def recipe():
        torch.cuda.synchronize()
        t = time.time()
        res_f = train_qat(cfg, data, QATConfig(
            steps=400, batch=64, w_bits=None, log_every=200, seed=0),
            device="cuda")
        ptq = evaluate_int(deploy(res_f, default_w_bits=2, device="cuda"),
                           test.batches(100, 5))
        res2 = train_qat(cfg, data, QATConfig(
            steps=600, batch=64, lr=1e-2, w_bits=2, warmup=30,
            log_every=300, seed=0), init_params=res_f.params, device="cuda")
        qat = evaluate_int(deploy(res2, device="cuda"), test.batches(100, 5))
        torch.cuda.synchronize()
        return {"ptq": ptq["accuracy"], "qat": qat["accuracy"],
                "float_loss": res_f.log[-1]["loss"],
                "qat_loss": res2.log[-1]["loss"],
                "c1_sum": res2.params["c1"]["w"].double().sum().item(),
                "s": time.time() - t}

    out = {"smi": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()}
    for mode, n in (("default", 3), ("cudnn_det", 2), ("all_det", 2)):
        rows = []
        for _ in range(n):
            if mode == "default":
                rows.append(recipe())
            elif mode == "cudnn_det":
                with torch.backends.cudnn.flags(
                        enabled=True, benchmark=False, deterministic=True,
                        allow_tf32=False):
                    rows.append(recipe())
            else:
                torch.use_deterministic_algorithms(True)
                try:
                    rows.append(recipe())
                finally:
                    torch.use_deterministic_algorithms(False)
            print(mode, json.dumps(rows[-1]), flush=True)
        out[mode] = rows
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "qat_reproducibility.json").write_text(
        json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
