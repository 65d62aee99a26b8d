"""Packed sub-byte GEMM (qdot's kernel)."""
