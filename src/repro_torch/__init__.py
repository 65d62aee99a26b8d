"""repro_torch — the XpulpNN integer-QNN pipeline on PyTorch and CUDA.

A second package beside the JAX reference ``repro``: the same artifacts
(chunk-planar packed sub-byte containers, tap-major conv panels, int32
eq. 3/4 epilogue vectors), the same module tree, and the same integers
out. The packed GEMM (``qdot``) and the fused implicit-GEMM conv
(``qconv``) run as hand-written CUDA kernels for Hopper (``csrc/``) on
CUDA tensors, and as their plain torch versions on CPU tensors.

Entry points default to ``device="cuda"`` and raise when no card is
present; pass ``device="cpu"`` for the plain path. This package never
imports ``jax`` or ``repro``.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
