"""Quantized ops (`api`), the Hopper kernels and their plain versions."""
