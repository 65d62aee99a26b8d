"""The one traffic generator: a mix's JSON file in, seeded tensors out.

A mix file gives the loop and a pool of input batches:

  {"loop": "closed", "pool": 4,
   "inputs": {"images": {"shape": [16384, "in_h", "in_w", "in_ch"],
                         "dtype": "float32", "dist": "uniform",
                         "low": 0.0, "high": 1.0}}}

A shape entry or a bound may name a number of the configuration's file
("vocab_size"). Every batch of the pool is drawn on the device from the
seed in one call per input, so the same seed gives the same inputs and
every seed the same sizes. ``closed`` runs one unit of work after
another, unit i on batch i mod pool.
"""
from __future__ import annotations

import zlib

import torch

LOOPS = ("closed",)
DTYPES = {"float32": torch.float32, "int64": torch.int64,
          "int32": torch.int32}


def sub_seed(seed: int, tag: str) -> int:
    """A seed for one purpose (weights, calibration, traffic) of a run:
    any whole ``seed`` folded with a stable hash of ``tag`` into 63
    bits."""
    return (int(seed) * 0x9E3779B97F4A7C15 + zlib.crc32(tag.encode())) \
        % (1 << 63)


def _num(v, cfg: dict):
    if isinstance(v, str):
        if not isinstance(cfg.get(v), (int, float)):
            raise KeyError(f"traffic names {v!r}, which the configuration "
                           "does not give as a number")
        return cfg[v]
    return v


def check(traffic: dict) -> None:
    if traffic.get("loop") not in LOOPS:
        raise ValueError(f"traffic loop {traffic.get('loop')!r} is not one "
                         f"of {LOOPS}")
    if int(traffic.get("pool", 0)) < 1:
        raise ValueError("traffic needs a pool of at least one batch")
    for name, s in traffic["inputs"].items():
        if s["dist"] not in ("uniform", "randint"):
            raise ValueError(f"input {name}: unknown dist {s['dist']!r}")
        if s["dtype"] not in DTYPES:
            raise ValueError(f"input {name}: unknown dtype {s['dtype']!r}")


def make_pool(traffic: dict, cfg: dict, seed: int, device) -> list:
    """``traffic['pool']`` batches, each a dict of named tensors."""
    check(traffic)
    gen = torch.Generator(device=device).manual_seed(
        sub_seed(seed, "traffic"))
    shapes = {name: tuple(int(_num(d, cfg)) for d in s["shape"])
              for name, s in traffic["inputs"].items()}
    pool = []
    for _ in range(int(traffic["pool"])):
        batch = {}
        for name in sorted(traffic["inputs"]):
            s = traffic["inputs"][name]
            lo, hi = _num(s["low"], cfg), _num(s["high"], cfg)
            dtype = DTYPES[s["dtype"]]
            if s["dist"] == "uniform":
                t = torch.rand(shapes[name], generator=gen, device=device,
                               dtype=torch.float32)
                t = (t * (hi - lo) + lo).to(dtype)
            else:
                t = torch.randint(int(lo), int(hi), shapes[name],
                                  generator=gen, device=device, dtype=dtype)
            batch[name] = t
        pool.append(batch)
    return pool
