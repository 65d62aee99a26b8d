"""Fused implicit-GEMM quantized conv (qconv's kernel)."""
