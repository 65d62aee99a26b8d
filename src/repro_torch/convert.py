"""Carry the reference's artifacts into the port, without re-quantizing.

Both functions take *neutral* descriptions made of plain dicts, lists,
numpy arrays, ints, floats and strings, so the port never needs the
reference package:

* `fp_params_from_numpy(tree, device)` — a param tree of numpy arrays
  (the reference's `init_fp` output, or an LM tree in fp or int mode:
  packed int8 `w_packed`, float32 `w_scale`, after ``np.asarray``) ->
  tensors of the same dtypes.
* `qnet_from_numpy(spec, device)` — a `QuantizedVisionNet` description ->
  the port's net. A dataclass instance is described as a dict with a
  ``"__type__"`` key naming the class (``"QConv2D"``,
  ``"QSegmentedConv2D"``, ``"QDepthwiseConv2D"``,
  ``"QuantizedConvParams"``, ``"SegmentMap"``, ...) and one key per
  field; lists stand for tuples; arrays become tensors on ``device``.
  A ``backend`` field that a port class does not have must name the
  device's backend or be None, and is then dropped.
* `segmented_params_from_numpy(spec, device)` — a `SegmentedLinearParams`
  description -> the port's mixed-width GEMM artifact.
* `train_state_from_numpy(state, device)` — a QAT or LM training state
  (params, optimizer state, error feedback) -> tensors, so both packages
  can start from one state.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.packing import SegmentMap
from repro_torch.core.quantize import (QuantizedLinearParams, QuantSpec,
                                       SegmentedLinearParams)
from repro_torch.deploy.policy import PlanRule, PrecisionPlan
from repro_torch.device import resolve_device
from repro_torch.kernels.api import check_backend
from repro_torch.kernels.qconv.ops import QuantizedConvParams
from repro_torch.vision import layers as vl
from repro_torch.vision.models import (LayerDef, QuantizedVisionNet,
                                       VisionConfig)

_TYPES = {cls.__name__: cls for cls in (
    QuantizedVisionNet, VisionConfig, LayerDef, QuantSpec, PrecisionPlan,
    PlanRule, QuantizedConvParams, QuantizedLinearParams, SegmentMap,
    SegmentedLinearParams, vl.QConv2D, vl.QSegmentedConv2D,
    vl.QDepthwiseConv2D, vl.QLinear, vl.QMaxPool2D, vl.QAvgPool2D,
    vl.QResidualAdd)}


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")
    if a.dtype.name == "bfloat16":     # ml_dtypes: the 2-byte words
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def fp_params_from_numpy(tree, device="cuda"):
    """Reference param tree (nested dicts of numpy arrays) -> tensors."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: fp_params_from_numpy(v, dev) for k, v in tree.items()}
    return _tensor(np.asarray(tree), dev)


def train_state_from_numpy(state: dict, device="cuda") -> dict:
    """A reference training state as numpy arrays -> the port's tree, every
    leaf's dtype and bytes as they are: a QAT state (``params``,
    ``absmax``, ``opt`` = {``step``, ``m``, ``v``}, int8 ``codes`` /
    ``scale`` / ``lmin`` / ``lrange`` leaves under 8-bit optimizer
    states) or an LM train state (``params``, ``opt``, and ``ef``, the
    bfloat16 error feedback). `train.step` and `qat.train` step it as
    they step their own."""
    missing = {"params", "opt"} - set(state)
    if missing or not {"step", "m", "v"} <= set(state["opt"]):
        raise ValueError("a training state holds 'params' and 'opt' "
                         "({'step', 'm', 'v'}); got keys "
                         f"{sorted(state)}")
    return fp_params_from_numpy(state, device)


def _build(obj, dev):
    if isinstance(obj, np.ndarray):
        return _tensor(obj, dev)
    if isinstance(obj, (list, tuple)):
        return tuple(_build(v, dev) for v in obj)
    if isinstance(obj, dict):
        if "__type__" not in obj:
            return {k: _build(v, dev) for k, v in obj.items()}
        name = obj["__type__"]
        cls = _TYPES.get(name)
        if cls is None:
            raise ValueError(f"qnet description names type {name!r}, which "
                             f"the port does not have; known: "
                             f"{sorted(_TYPES)}")
        kwargs = {k: _build(v, dev) for k, v in obj.items()
                  if k != "__type__"}
        if cls is PrecisionPlan:    # meta is a plain payload dict
            kwargs["meta"] = obj.get("meta", {})
        if "backend" in kwargs and "backend" not in {
                f.name for f in dataclasses.fields(cls)}:
            check_backend(kwargs.pop("backend"), dev)
        return cls(**kwargs)
    return obj


def qnet_from_numpy(spec: dict, device="cuda") -> QuantizedVisionNet:
    """Neutral description of a quantized vision net -> the port's
    `QuantizedVisionNet` on ``device`` (arrays copied as they are)."""
    net = _build(spec, resolve_device(device))
    if not isinstance(net, QuantizedVisionNet):
        raise ValueError("description is not a QuantizedVisionNet")
    return net


def segmented_params_from_numpy(spec: dict,
                                device="cuda") -> SegmentedLinearParams:
    """Neutral description of a `SegmentedLinearParams` -> the port's
    artifact on ``device`` (the flat buffer copied as it is)."""
    params = _build(spec, resolve_device(device))
    if not isinstance(params, SegmentedLinearParams):
        raise ValueError("description is not a SegmentedLinearParams")
    return params


def to_device(obj, device):
    """A copy of an artifact (dataclasses, tuples, dicts of tensors) with
    every tensor moved to ``device``."""
    dev = resolve_device(device)
    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: to_device(getattr(obj, f.name), dev)
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, tuple):
        return tuple(to_device(v, dev) for v in obj)
    if isinstance(obj, dict):
        return {k: to_device(v, dev) for k, v in obj.items()}
    return obj
