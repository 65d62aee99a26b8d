"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload resnet8-w4a8.frames-16384 \
        --seed 7 --seconds 10 --trace 0

from the root of a checkout. It builds the cell's system from
``BENCHMARK.json`` and the files under ``portbench/``, warms up, measures
for ``--seconds``, checks the window's outputs against the plain
reference, and prints one JSON object as the last line of standard
output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics; with ``--trace 1`` its per-layer metrics from a
profiled window), ``device`` and, traced, ``breakdown``; the numbers
compared and their limits come last there and as the last lines of
standard error. It measures the PyTorch/CUDA port (``src/repro_torch``)
on a CUDA card only: with no card, too few, or the port missing, it
exits non-zero and prints no result, and likewise if JAX or the JAX
package was loaded.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _fail(code: int, why: str):
    print(f"portbench: {why}", file=sys.stderr)
    sys.exit(code)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    # the port's kernel libraries: built once, inside this checkout
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(
        ROOT / "build" / "repro_torch_kernels")

    from portbench.harness import guard, runner, spec

    try:
        cell = spec.resolve(ROOT, args.workload)
    except ModuleNotFoundError as e:
        _fail(5, f"the port is not importable here ({e}); run from the "
                 "root of a checkout that holds src/repro_torch")
    except (KeyError, FileNotFoundError) as e:
        _fail(2, f"cannot resolve {args.workload!r}: {e}")

    import torch
    if not torch.cuda.is_available():
        _fail(3, "torch sees no CUDA device; the benchmark measures the "
                 "port on a card and has no CPU fallback")
    if torch.cuda.device_count() < cell.chips:
        _fail(3, f"{args.workload} needs {cell.chips} card(s), torch sees "
                 f"{torch.cuda.device_count()}")
    try:
        import repro_torch  # noqa: F401
    except ModuleNotFoundError as e:
        _fail(5, f"the port is not importable here ({e})")

    result = runner.run(cell, args.seed, args.seconds, bool(args.trace),
                        "cuda", T_PROCESS)
    found = guard.forbidden_loaded()
    if found:
        _fail(4, f"the run loaded {found}; the port and the benchmark may "
                 "not import JAX or the JAX package")
    for name, c in result["checks"].items():
        print(f"check {name}={c['value']!r} limit={c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
