"""int8 gradient compression with error feedback.

Gradients crossing the data axis are blockwise int8-quantized
(`core.quantize`'s wire codec: 4x fewer bytes on the reduction path);
the quantization error is fed back into the next step's gradient
(error-feedback SGD), which keeps convergence unbiased in practice.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantize import (BLOCK, dequantize_int8_blockwise,
                                       quantize_int8_blockwise)
from repro_torch.nn.module import get_at, leaf_paths, tree_like

_quant_block = quantize_int8_blockwise
_dequant_block = dequantize_int8_blockwise

__all__ = ["BLOCK", "compress_grads"]


@torch.no_grad()
def compress_grads(grads, error_feedback):
    """g' = Q(g + ef); ef' = (g + ef) - g'. Returns (g', ef')."""
    gq_out, ef_out = [], []
    for path, g in leaf_paths(grads):
        ef = get_at(error_feedback, path)
        gf = g.to(torch.float32) + ef.to(torch.float32)
        codes, scale = _quant_block(gf)
        gq = _dequant_block(codes, scale, g.shape)
        gq_out.append((path, gq.to(g.dtype)))
        ef_out.append((path, (gf - gq).to(ef.dtype)))
    return tree_like(gq_out), tree_like(ef_out)
