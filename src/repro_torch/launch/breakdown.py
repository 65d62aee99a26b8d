"""Per-op IO and collective breakdown of one dry-run cell: which aten
ops (and packed kernel calls) move the bytes of the busiest position, the
dry run's counterpart of a profiler.

    PYTHONPATH=src python -m repro_torch.launch.breakdown --arch X \\
        --shape Y [--mesh pod] [--top 20]
"""
from __future__ import annotations

import argparse

from repro_torch.launch.dryrun import run_cell


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod"])
    ap.add_argument("--quant", default="off")
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args(argv)
    rec = run_cell(args.arch, args.shape, args.mesh, args.quant, save=False,
                   breakdown=True)
    c = rec["collectives"]
    print(f"flops/dev {rec['flops_per_device']:.3e}  int ops/dev "
          f"{rec['int_ops_per_device']:.3e}  io "
          f"{rec['io_bytes_per_device'] / 1e9:.1f} GB/dev  coll_in "
          f"{c['total_in'] / 1e9:.1f} GB/dev  coll_out "
          f"{c['total_out'] / 1e9:.1f} GB/dev")
    print("collectives:", {k: f"{v / 1e9:.1f}GB"
                           for k, v in c["in_bytes"].items() if v})
    print(f"{'GB':>8} {'calls':>7} op (all traced positions) "
          "last output shape")
    rows = sorted(rec["by_op"].items(), key=lambda kv: -kv[1][0])
    for name, (nbytes, calls, shape) in rows[: args.top]:
        print(f"{nbytes / 1e9:8.1f} {calls:7d} {name:44s} {shape}")
    return rec


if __name__ == "__main__":
    main()
