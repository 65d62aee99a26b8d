#!/usr/bin/env python3
"""Writes ``src/repro_torch/csrc/wgmma_bf16.cuh``: the bf16 ``wgmma``
calls of the fused attention kernel (``csrc/attn.cu``), one function per
width N.

    python3 tools/gen_wgmma_bf16.py            # rewrite the header
    python3 tools/gen_wgmma_bf16.py --check    # exit 1 if it is stale

PTX names every accumulator register of a ``wgmma`` in its operand list,
so each width is its own inline-assembly block; they are generated here
rather than written out by hand. The widths are those the kernel
instantiates: the score product at the key tiles (``SS_WIDTHS``), the
value product at the padded value widths (``RS_WIDTHS``).
"""
from __future__ import annotations

import argparse
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
HEADER = ROOT / "src" / "repro_torch" / "csrc" / "wgmma_bf16.cuh"

SS_WIDTHS = (64, 128)
RS_WIDTHS = (32, 64, 96, 128, 192, 256)

PREAMBLE = """\
// bf16 x bf16 -> float32 wgmma of the fused attention kernel (attn.cu).
// Generated by tools/gen_wgmma_bf16.py; edit that script, not this file.
//
// wgmma_bf16_ss<N>: d[64 x N] (+)= A[64 x 16] * B[16 x N], A and B read
// from shared memory through descriptors, both K-major (the scores:
// queries times keys).
// wgmma_bf16_rs<N>: the same with A from registers (four bf16x2 words in
// the m64k16 fragment layout) and B MN-major (imm-trans-b = 1: rows of K,
// N contiguous; the values).
// `accumulate` 0 overwrites d, 1 adds to it. Each thread holds N / 2
// accumulators: for each 8-column block j, d[4j], d[4j + 1] in row
// lane / 4 and d[4j + 2], d[4j + 3] in row lane / 4 + 8 of its warp's 16
// rows, at columns 8j + 2 (lane % 4) and the next.
#pragma once

#include <cstdint>

namespace rq {
namespace attn {

template <int N>
__device__ __forceinline__ void wgmma_bf16_ss(float (&d)[N / 2], uint64_t a,
                                              uint64_t b, int accumulate);

template <int N>
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[N / 2], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t b,
                                              int accumulate);
"""

CLOSE = """
}  // namespace attn
}  // namespace rq
"""


def _regs(n: int) -> str:
    return ", ".join(f"%{i}" for i in range(n))


def _outs(n: int) -> str:
    items = [f'"+f"(d[{i}])' for i in range(n)]
    return ",\n        ".join(", ".join(items[i:i + 6])
                              for i in range(0, n, 6))


def ss(width: int) -> str:
    n = width // 2
    return f"""
template <>
__device__ __forceinline__ void wgmma_bf16_ss<{width}>(float (&d)[{n}],
                                                    uint64_t a, uint64_t b,
                                                    int accumulate) {{
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{n + 2}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{width}k16.f32.bf16.bf16 {{"
      "{_regs(n)}"
      "}}, %{n}, %{n + 1}, p, 1, 1, 0, 0;\\n}}\\n"
      : {_outs(n)}
      : "l"(a), "l"(b), "r"(accumulate));
}}
"""


def rs(width: int) -> str:
    n = width // 2
    return f"""
template <>
__device__ __forceinline__ void wgmma_bf16_rs<{width}>(
    float (&d)[{n}], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
    uint64_t b, int accumulate) {{
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{n + 5}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{width}k16.f32.bf16.bf16 {{"
      "{_regs(n)}"
      "}}, {{%{n}, %{n + 1}, %{n + 2}, %{n + 3}}}, %{n + 4}, p, 1, 1, 1;\\n}}\\n"
      : {_outs(n)}
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(accumulate));
}}
"""


def render() -> str:
    return (PREAMBLE + "".join(ss(w) for w in SS_WIDTHS)
            + "".join(rs(w) for w in RS_WIDTHS) + CLOSE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--check", action="store_true",
                    help="exit 1 if the header differs from the script's")
    args = ap.parse_args(argv)
    text = render()
    if args.check:
        if HEADER.read_text() != text:
            print(f"{HEADER} is stale: run tools/gen_wgmma_bf16.py",
                  file=sys.stderr)
            return 1
        return 0
    HEADER.write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
