"""numpy direct-convolution oracle for the quantized conv layer.

No im2col: it convolves directly with int32 accumulation and an int64
requant, so a bug in the implicit-GEMM path cannot hide in shared code.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import packing


def qconv2d_ref(x_hat, w_hat, kappa, lam, m_mul, d, out_bits,
                stride: int = 1, padding: int = 1) -> np.ndarray:
    """x_hat: (N,H,W,Cin) int8, w_hat: (fh,fw,cin,cout) int8 (UNPACKED)."""
    x = np.asarray(x_hat, dtype=np.int32)
    w = np.asarray(w_hat, dtype=np.int32)
    n, h, ww_, c = x.shape
    fh, fw, cin, cout = w.shape
    assert cin == c
    if padding:
        x = np.pad(x, ((0, 0), (padding, padding), (padding, padding),
                       (0, 0)))
    ho = (h + 2 * padding - fh) // stride + 1
    wo = (ww_ + 2 * padding - fw) // stride + 1
    acc = np.zeros((n, ho, wo, cout), dtype=np.int64)
    for dy in range(fh):
        for dx in range(fw):
            patch = x[:, dy:dy + stride * ho:stride,
                      dx:dx + stride * wo:stride]
            acc += np.einsum("nhwc,co->nhwo", patch, w[dy, dx],
                             dtype=np.int64)
    acc = acc.astype(np.int32)
    kappa = np.asarray(kappa, dtype=np.int32)
    lam = np.asarray(lam, dtype=np.int32)
    with np.errstate(over="ignore"):
        phi_p = (acc * kappa + lam).astype(np.int32)
    y = (np.asarray(m_mul, dtype=np.int64) * phi_p.astype(np.int64)) >> d
    hi = packing.int_range(out_bits, False)[1]
    return np.clip(y, 0, hi).astype(np.int8)
