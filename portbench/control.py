"""Readings that a cell's ``correct`` limits are set from: the program's
own, and its control's, on many seeds in one process.

    python3 portbench/control.py --workload phi3-mini-w4a8.prefill-8x2048 \
        --seeds 11,12,13 --seconds 3 --out chiprun_out/control.jsonl

For each seed it builds the cell as a run does, drives the timed path
for ``--seconds`` (a short window at the cell's own sizes) and compares
what it produced with the plain reference: the program's readings. Then
the control: the reference itself put in the program's place, its
activations at the configuration's ``control`` precision (the step below
the one the configuration states), compared in the same way. A sound
limit lies above every program reading and below every control reading.
One JSON line per reading; the benchmark's own runs never run this.
"""
import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def readings(root, workload: str, seeds, seconds: float, device,
             control: bool = True):
    """Yield {"seed", "kind", numbers} for the program, then the control,
    on each seed."""
    import torch

    from portbench.harness import runner, spec

    cell = spec.resolve(root, workload)
    dev = torch.device(device)
    runner.set_numerics()
    span = runner.span_factory(False)
    for seed in seeds:
        t0 = time.perf_counter()
        state = cell.system.setup(cell, seed, dev, span)
        win = runner.window(cell.system, state, seconds, span, dev)
        outs = cell.system.outputs(state)
        del state
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        got = cell.system.check(cell, seed, dev, outs)
        del outs
        yield {"seed": seed, "kind": "program", "units": len(win["steps"]),
               "seconds": time.perf_counter() - t0, **got}
        if control:
            t0 = time.perf_counter()
            low = cell.system.control_outputs(cell, seed, dev)
            got = cell.system.check(cell, seed, dev, low)
            del low
            yield {"seed": seed, "kind": "control",
                   "seconds": time.perf_counter() - t0, **got}
        if dev.type == "cuda":
            torch.cuda.empty_cache()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control-seeds", type=int, default=None,
                    help="run the control on the first N seeds only")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        sys.exit(3)
    seeds = [int(s) for s in args.seeds.split(",")]
    out = open(args.out, "a") if args.out else None
    try:
        n = 0
        for seed in seeds:
            ctl = args.control_seeds is None or n < args.control_seeds
            n += 1
            for r in readings(ROOT, args.workload, [seed], args.seconds,
                              "cuda", control=ctl):
                r["workload"] = args.workload
                r["device"] = torch.cuda.get_device_name(0)
                line = json.dumps(r)
                print(line, flush=True)
                if out:
                    out.write(line + "\n")
                    out.flush()
    finally:
        if out:
            out.close()


if __name__ == "__main__":
    main()
