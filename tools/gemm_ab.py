#!/usr/bin/env python3
"""Times the two packed GEMM kernels of one tree of this repository, to
compare two versions inside one GPU call.

    python3 tools/gemm_ab.py --src DIR --out NAME

Builds ``qmatmul.cu`` and ``qmatmul_segmented.cu`` of the ``repro_torch``
under DIR (into that checkout's ``build/repro_torch_kernels/``) and runs
``chip_smoke.py``'s uniform-GEMM and mixed-operand timing phases with it,
without checks; the report goes to ``chiprun_out/NAME.json`` beside
``chip_smoke.py``. Run it on two trees in turns (parent, change, change,
parent) in one call and compare the device times there: calls on
different machines differ by up to 30% on the same code.

A tree from before the tensor-core GEMM, whose wrapper takes neither a
launch plan nor ``k_logical``, is timed through its
``qmatmul_packed_cuda`` at the padded K, its only launch.
"""
from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys
import types

ROOT = pathlib.Path(__file__).resolve().parent.parent


def dp4a_tree_shims(cs, gk):
    """Make `chip_smoke.Case` call a wrapper that contracts the padded K
    at its one launch."""
    init = cs.Case.__init__

    def __init__(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self.kw.pop("k_logical", None)

    cs.Case.__init__ = __init__
    cs.Case.launches = lambda self: [
        types.SimpleNamespace(launch="the wrapper's own")]
    cs.Case.kernel = lambda self, stages: gk.qmatmul_packed_cuda(
        self.x, self.w, *self.vecs, pipeline=cs.PIPELINE[stages], **self.kw)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", required=True,
                    help="directory holding the repro_torch to time")
    ap.add_argument("--out", required=True,
                    help="report name under chiprun_out/")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("gemm_ab: torch sees no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels.build import build_all
    from repro_torch.kernels.qmatmul import kernel as gk
    from repro_torch.vision.configs import get_vision_config

    if not hasattr(gk, "_launch_packed"):
        dp4a_tree_shims(cs, gk)
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    kernels = {"qmatmul": gk.KERNEL,
               "qmatmul_segmented": gk.SEGMENTED_KERNEL}
    report = {"nvidia_smi": smi, "src": args.src,
              "build_s": build_all(list(kernels.values())),
              "ptxas": cs.ptxas_report(kernels)}
    head = cs.net_shapes(get_vision_config("resnet8"), cs.WAVE)["head"]
    cs.gemm_timing_phase(dev, head, report)
    cs.segmented_timing_phase(dev, report)
    cs.write_report(report, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
