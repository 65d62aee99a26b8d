"""QAT -> deploy accuracy subsystem: train -> calibrate -> plan -> pack ->
serve -> measure.

  fakequant   STE fake-quant primitives, bit-matching the deployed grids
  data        hermetic seeded 16x16 digit dataset (+ optional real MNIST)
  train       the QAT loop on the vision graphs (autograd, AdamW, EMA /
              PACT ranges, plan-resolved per-layer / segmented widths)
  evaluate    integer-path (forward_int) accuracy of the packed artifact

Entry point: ``python -m repro_torch.launch.qat``.
"""
from repro_torch.qat.fakequant import (fake_quant_act, fake_quant_weight,
                                       fake_quant_weight_segmented,
                                       ste_quantize)
from repro_torch.qat.train import QATConfig, QATResult, train_qat
from repro_torch.qat.evaluate import deploy, evaluate_int, fold_check

__all__ = [
    "ste_quantize", "fake_quant_weight", "fake_quant_weight_segmented",
    "fake_quant_act", "QATConfig", "QATResult", "train_qat", "deploy",
    "evaluate_int", "fold_check",
]
