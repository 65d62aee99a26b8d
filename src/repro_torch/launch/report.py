"""Render the dry run's records (`repro_torch.launch.dryrun`) as the
roofline table, one row per (arch, shape) cell.

    PYTHONPATH=src python -m repro_torch.launch.report [--mesh pod]
"""
from __future__ import annotations

import argparse
import json
import pathlib

from repro_torch.launch.dryrun import OUT_DIR


def fmt_s(x):
    if x == 0:
        return "0"
    if x < 1e-4:
        return f"{x * 1e6:.1f}us"
    if x < 0.1:
        return f"{x * 1e3:.2f}ms"
    return f"{x:.2f}s"


def fmt_b(x):
    return f"{x / 2**30:.2f}"


def load(mesh: str, tag: str = "", out_dir=None):
    """{(arch, shape): record} of ``mesh``'s unquantized records."""
    out = {}
    d = pathlib.Path(out_dir) if out_dir is not None else OUT_DIR
    for p in sorted(d.glob(f"*__{mesh}{tag}.json")):
        r = json.loads(p.read_text())
        if r.get("tag", "") != tag.lstrip("_") or \
                r.get("quant", "off") != "off":
            continue
        out[(r["arch"], r["shape"])] = r
    return out


def table(mesh: str, tag: str = "", out_dir=None) -> str:
    recs = load(mesh, tag, out_dir)
    lines = [
        "| arch | shape | GiB/dev | compute | memory | collective | "
        "dominant | roofline frac | useful/traced flops |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for key in sorted(recs):
        r = recs[key]
        t = r["roofline"]
        lines.append(
            "| {} | {} | {} | {} | {} | {} | {} | {:.1%} | {:.2f} |".format(
                key[0], key[1], fmt_b(r["bytes_per_device"]["total"]),
                fmt_s(t["compute_s"]), fmt_s(t["memory_s"]),
                fmt_s(t["collective_s"]),
                t["dominant"].replace("_s", ""),
                t["roofline_fraction"], r["useful_flops_ratio"]))
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="pod")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=None,
                    help=f"record directory (default {OUT_DIR})")
    args = ap.parse_args(argv)
    print(table(args.mesh, f"_{args.tag}" if args.tag else "", args.out))


if __name__ == "__main__":
    main()
