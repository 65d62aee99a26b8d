"""Plan-driven checkpoint conversion: fp tree -> mixed-precision packed
tree.

The walk tracks the "/"-joined parameter path and resolves each dense
subtree's ``w_bits`` through the `PrecisionPlan` (``plan=None``: one
uniform width). Per-dense math is `nn/layers.py::pack_dense_weights`
(per-output-channel symmetric grids, chunk-planar packing); a rule with
``segments`` packs through `pack_dense_weights_segmented` into the flat
segmented container the plan-built defs expect. The out-of-range guard
of `core/packing.py` is armed, so a mis-quantized value raises instead
of corrupting the artifact. Packing runs on the device the fp tree lives
on; the card and the CPU give the same bytes.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.deploy.policy import PrecisionPlan
from repro_torch.nn.layers import (QuantConfig, pack_dense_weights,
                                   pack_dense_weights_segmented)


def _is_dense_q(node) -> bool:
    return isinstance(node, dict) and "w_packed" in node


def int_skeleton(defs):
    """The int-mode tree `apply_plan` fills, at no memory: a meta tensor
    per leaf of an int-mode ParamDef tree. `apply_plan` reads only each
    dense's ``w_packed`` shape from it and takes every other leaf from
    the fp tree, so a float leaf the two trees share (an embedding, the
    float routed experts of a MoE that does not pack them) exists once."""
    if isinstance(defs, dict):
        return {k: int_skeleton(v) for k, v in defs.items()}
    return torch.empty(defs.shape, dtype=defs.dtype, device="meta")


def apply_plan(q_tree, fp_tree, plan: Optional[PrecisionPlan],
               default_w_bits: int = 8, *, assert_range: bool = True,
               _path: Tuple[str, ...] = ()):
    """Fill an int-mode parameter tree (zeros-initialized `w_packed` /
    `w_scale` leaves) from the fp tree, quantizing each dense at its
    plan-resolved bit-width; ``q_tree`` may be its `int_skeleton`.
    Stacked layer weights pack along their own K axis, and so do the
    routed experts of the dropless MoE dispatch (``MoeSpec.experts_held``
    > 0: dense subtrees stacked (L, E, K, N), each expert on its own
    grids). Every other leaf is the fp tree's own tensor."""
    if _is_dense_q(q_tree):
        path = "/".join(_path)
        qcfg = QuantConfig(mode="int", w_bits=default_w_bits)
        if plan is not None:
            qcfg = plan.resolve(path, qcfg)
        if qcfg.segments is not None:
            packed, scale = pack_dense_weights_segmented(
                fp_tree["w"], qcfg.segments, assert_range=assert_range)
        else:
            packed, scale = pack_dense_weights(fp_tree["w"], qcfg.w_bits,
                                               assert_range=assert_range)
        if packed.shape != q_tree["w_packed"].shape:
            raise ValueError(
                f"{path}: packed shape {tuple(packed.shape)} != def shape "
                f"{tuple(q_tree['w_packed'].shape)} — the model was not "
                "built with this plan (pass the same plan via "
                "ModelConfig.quant_plan)")
        out = dict(q_tree, w_packed=packed, w_scale=scale)
        if "b" in q_tree and "b" in fp_tree:
            out["b"] = fp_tree["b"]
        return out
    if isinstance(q_tree, dict):
        return {k: (apply_plan(q_tree[k], fp_tree[k], plan, default_w_bits,
                               assert_range=assert_range,
                               _path=_path + (k,))
                    if k in fp_tree else q_tree[k]) for k in q_tree}
    # non-dense leaves (norms, embeddings, ...) pass through
    return fp_tree


def quantized_dense_paths(defs,
                          _path: Tuple[str, ...] = ()) -> Tuple[str, ...]:
    """Paths of every dense subtree the int deployment mode packs (walked
    from a ParamDef tree built with ``quant.mode == "int"``): the
    planner's decision universe."""
    if isinstance(defs, dict):
        if "w_packed" in defs:
            return ("/".join(_path),)
        out: list = []
        for k in sorted(defs):
            out.extend(quantized_dense_paths(defs[k], _path + (k,)))
        return tuple(out)
    return ()


def dense_weight(fp_params, path: str) -> torch.Tensor:
    """The fp ``w`` leaf of the dense subtree at "/"-joined ``path``."""
    node = fp_params
    for part in path.split("/"):
        node = node[part]
    return node["w"]


def dense_inventory(fp_params, paths) -> Dict[str, Tuple[int, int, int]]:
    """path -> (n_stacked_layers, d_in, d_out) for each quantized dense,
    read off the fp tree ((K,N) or stacked (L,K,N) `w` leaves)."""
    out = {}
    for path in paths:
        w = dense_weight(fp_params, path)
        if w.dim() == 3:
            out[path] = (int(w.shape[0]), int(w.shape[1]), int(w.shape[2]))
        else:
            out[path] = (1, int(w.shape[0]), int(w.shape[1]))
    return out
