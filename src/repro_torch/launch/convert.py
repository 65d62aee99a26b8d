"""fp LM parameter tree -> packed integer deployment artifact: quantize
and chunk-planar-pack every dense weight at one uniform width (the
held routed experts of a dropless MoE config each along its own K),
and emit the int-mode parameter tree the serving path consumes (a thin
wrapper over `repro_torch.deploy.apply.apply_plan` with no plan).

Not to be confused with `repro_torch.convert`, which carries the
reference's artifacts into the port.
"""
from __future__ import annotations

from repro_torch.deploy.apply import apply_plan
from repro_torch.nn.module import param_bytes


def convert_params(q_tree, fp_tree, w_bits: int):
    """Fill an int-mode parameter tree (zeros-initialized `w_packed` /
    `w_scale` leaves, or its `int_skeleton`) from the fp tree at one
    uniform bit-width."""
    return apply_plan(q_tree, fp_tree, None, w_bits)


def artifact_bytes(params) -> int:
    """Total bytes of a (packed or fp) parameter tree."""
    return param_bytes(params)
