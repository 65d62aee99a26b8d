#!/usr/bin/env python3
"""How often a torch.profiler session holds no record of the packed GEMM
kernel, and the queued-event timer of `kernels/tune.py` beside the
profiler's device time.

    python3 tools/profiler_check.py      # from the repository root, one GPU

Builds the kernels, then for four launches of the uniform GEMM at A8W4
('raw'; the ResNet-8 head, MobileNet's block0 depthwise GEMM at its
planned and its unsplit launch, 4096x2048x1024 split 5) opens many
profiler sessions of ten launches each and counts those that hold no
kernel record, and times five `tune._queued_event_us` passes. Prints one
JSON line per launch; writes ``chiprun_out/profiler_check.json``.
"""
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profiler_check: torch sees no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(1, str(ROOT / "src"))
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke as cs
    from repro_torch.kernels import api, tune
    from repro_torch.kernels.build import build_all

    build_all(list(cs.kernels_by_name().values()))
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    out = {}
    for label, (m, k, n), launch, sessions in (
            ("head", (64, 64, 10), None, 600),
            ("dw0", (4096, 144, 16), {"splits": 2, "min_blocks": 1}, 60),
            ("dw0_unsplit", (4096, 144, 16),
             {"splits": 1, "min_blocks": 1}, 60),
            ("big2", (4096, 2048, 1024), {"splits": 5, "min_blocks": 2},
             60)):
        params, xp = tune._mk_qdot_artifact(gen, m, k, n, 8, 4, dev)

        def fn():
            return api.qdot_run(params, xp, epilogue="raw", scale=1.0,
                                pipeline="off", launch=launch)
        fn()
        torch.cuda.synchronize()
        empty, vals = [], []
        t0 = time.perf_counter()
        for i in range(sessions):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    fn()
                torch.cuda.synchronize()
            recs = [e for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and "qmatmul_kernel" in e.key]
            nrec = sum(e.count for e in recs)
            if nrec:
                vals.append(sum(e.self_device_time_total for e in recs)
                            / nrec)
            else:
                empty.append(i)
        vals.sort()
        out[label] = {
            "shape": [m, k, n], "launch": launch, "sessions": sessions,
            "empty": empty, "profiler_us_min_med_max":
            [vals[0], vals[len(vals) // 2], vals[-1]] if vals else None,
            "event_us": [tune._queued_event_us(fn, 10) for _ in range(5)],
            "s": time.perf_counter() - t0}
        print(label, json.dumps(out[label]), flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "profiler_check.json").write_text(
        json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
