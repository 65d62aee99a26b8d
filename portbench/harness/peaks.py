"""Published dense peaks of the cards the benchmark runs on (NVIDIA's
data sheets, no sparsity), at the card's full power limit. A roofline
share or an ``mfu`` reads against these; the run line carries the
card's power limit beside them."""
from __future__ import annotations

# name fragment -> peaks; the first fragment found in the device name wins
TABLE = (
    ("H100 80GB HBM3", {"int8_ops": 1979e12, "bf16_flops": 989e12,
                        "tf32_flops": 495e12, "fp32_flops": 67e12,
                        "hbm_bytes": 3.35e12}),
    ("H100 PCIe", {"int8_ops": 1513e12, "bf16_flops": 756e12,
                   "tf32_flops": 378e12, "fp32_flops": 51e12,
                   "hbm_bytes": 2.0e12}),
)


def peaks_for(device_name: str) -> dict:
    for frag, p in TABLE:
        if frag in device_name:
            return p
    raise KeyError(f"no published peaks for {device_name!r}; add the card "
                   "to portbench/harness/peaks.py")
