"""Integer-path evaluation of the deployed QAT artifact.

The number that matters is the accuracy of the packed integer artifact
the serving path runs: `vision.models.quantize_net` -> `forward_int`
(uint{a_bits} images at every edge, int32 accumulation, the eq. 3/4
epilogue; the conv and GEMM kernels on CUDA tensors, segmented plans
included).

`deploy` folds a `qat.train.QATResult` without re-calibration: the EMA
or PACT ranges are the deployment absmax, and the weight grids come from
the same `calibrate_weight` statistic the fake-quant used, so the integer
codes are the codes training simulated (`fold_check` asserts it). What is
left between training and deployment is float32 against int32
accumulation: boundary codes within ~1 LSB (`edge_agreement`).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.calibration import calibrate_weight
from repro_torch.core.quantize import QuantSpec, dequantize, quantize
from repro_torch.deploy.policy import PrecisionPlan
from repro_torch.obs import trace as obs
from repro_torch.qat import fakequant as fq
from repro_torch.qat.train import ACT_KEY, QATResult, qat_forward
from repro_torch.vision.models import (COMPUTE_KINDS, QuantizedVisionNet,
                                       forward_int, get_path, quantize_input,
                                       quantize_net)


def deploy(result: QATResult, *, plan: Optional[PrecisionPlan] = None,
           default_w_bits: Optional[int] = None,
           device="cuda") -> QuantizedVisionNet:
    """Fold a trained result into the deployable integer net on
    ``device``. By default it deploys what was trained (the result's plan
    and w_bits); ``plan`` / ``default_w_bits`` deploy the same weights
    under another quantization (the PTQ rows)."""
    if plan is None and default_w_bits is None:
        plan = result.plan
    if default_w_bits is None:
        default_w_bits = result.qc.w_bits or 8
    return quantize_net(result.cfg, result.model_params(),
                        result.deployment_absmax(), plan=plan,
                        default_w_bits=default_w_bits, device=device)


def evaluate_int(qnet: QuantizedVisionNet, batches, *, mesh=None,
                 pipeline: Optional[str] = None) -> dict:
    """Integer-path accuracy of ``qnet`` over ``batches`` of (images,
    labels), on the net's device; ``mesh`` runs the forward on the
    cluster path, ``pipeline`` forces the kernels' pipeline net-wide.
    Raw int32 logits: argmax needs no dequant."""
    correct = n = 0
    with obs.span("qat.evaluate_int", cat="qat",
                  net=qnet.cfg.name) as sp:
        for x, y in batches:
            logits = forward_int(qnet, quantize_input(qnet, x), mesh=mesh,
                                 pipeline=pipeline)
            preds = torch.argmax(logits, dim=-1).cpu().numpy()
            correct += int((preds == np.asarray(y)).sum())
            n += len(preds)
        acc = correct / max(n, 1)
        sp.set(images=n, accuracy=acc)
    return {"accuracy": acc, "correct": correct, "n": n}


def _betas(result: QATResult) -> Dict[str, torch.Tensor]:
    return (result.params[ACT_KEY] if result.qc.learned_absmax
            else result.absmax)


def _device(result: QATResult) -> torch.device:
    return get_path(result.params, next(
        L.path for L in result.cfg.layers if L.kind in COMPUTE_KINDS))[
            "w"].device


@torch.no_grad()
def evaluate_fq(result: QATResult, batches) -> dict:
    """Accuracy of the training-time fake-quant forward (the float view
    of the same grids), on the result's device."""
    correct = n = 0
    dev = _device(result)
    for x, y in batches:
        logits, _ = qat_forward(
            result.cfg, result.params,
            torch.from_numpy(np.asarray(x, np.float32)).to(dev),
            _betas(result), lquant=result.lquant, a_bits=result.qc.a_bits,
            learned=result.qc.learned_absmax)
        preds = torch.argmax(logits, dim=-1).cpu().numpy()
        correct += int((preds == np.asarray(y)).sum())
        n += len(preds)
    return {"accuracy": correct / max(n, 1), "correct": correct, "n": n}


@torch.no_grad()
def fold_check(result: QATResult) -> None:
    """Assert the grid-matching invariant on the trained weights: for
    every compute layer the fake-quant values are exactly
    dequantize(quantize(w)) on the deployment grid. Raises AssertionError
    naming the offending path."""
    if result.lquant is None:
        raise ValueError("float-trained result has no quantization to "
                         "check; train with w_bits or a plan")
    params = result.model_params()
    for L in result.cfg.layers:
        if L.kind not in COMPUTE_KINDS:
            continue
        w = get_path(params, L.path)["w"].to(torch.float32)
        lq = result.lquant[L.path]
        runs = lq.segments or ((0, int(w.shape[-1]), lq.w_bits),)
        fq_w = (fq.fake_quant_weight_segmented(w, lq.segments)
                if lq.segments is not None
                else fq.fake_quant_weight(w, lq.w_bits))
        deployed = []
        for s, e, b in runs:
            spec = calibrate_weight(w[..., s:e], b)
            deployed.append(dequantize(quantize(w[..., s:e], spec), spec))
        dep = torch.cat(deployed, dim=-1)
        if not bool(torch.all(fq_w == dep)):
            bad = int(torch.sum(fq_w != dep))
            raise AssertionError(
                f"{L.path}: fake-quant values diverge from the deployed "
                f"grid on {bad} weight(s); the grid-matching invariant "
                "is broken")


@torch.no_grad()
def edge_agreement(result: QATResult, qnet: QuantizedVisionNet,
                   x_batch) -> dict:
    """The integer forward's edge codes against the fake-quant forward's
    values on the same grids: {"within_1lsb": fraction, "max_dev": int,
    "argmax_agree": fraction}. float32 accumulation cannot reproduce
    int32 accumulation exactly, so the contract is boundary codes within
    1 LSB almost everywhere and argmax agreement."""
    dev = _device(result)
    x = torch.from_numpy(np.asarray(x_batch, np.float32)).to(dev)
    betas = result.deployment_absmax()
    fq_edges: Dict[str, torch.Tensor] = {}
    logits_fq, _ = qat_forward(
        result.cfg, result.params, x,
        {k: torch.tensor(v, dtype=torch.float32, device=dev)
         for k, v in betas.items()},
        lquant=result.lquant, a_bits=result.qc.a_bits, learned=False,
        edge_tap=lambda p, t: fq_edges.setdefault(p, t))
    int_edges: Dict[str, torch.Tensor] = {}
    logits_int = forward_int(
        qnet, quantize_input(qnet, np.asarray(x_batch, np.float32)),
        collect=lambda p, t: int_edges.setdefault(p, t))
    total = within = max_dev = 0
    for path, fq_val in fq_edges.items():
        if path not in int_edges or path == "__input__":
            continue
        spec = QuantSpec.activation(result.qc.a_bits,
                                    max(betas[path], 1e-6))
        eps = torch.tensor(spec.eps, dtype=torch.float32, device=dev)
        codes_fq = torch.round(fq_val / eps).to(torch.int64)
        dev_ = torch.abs(codes_fq - int_edges[path].to(dev).to(torch.int64))
        total += dev_.numel()
        within += int(torch.sum(dev_ <= 1))
        max_dev = max(max_dev, int(torch.max(dev_)))
    agree = float(torch.mean((torch.argmax(logits_fq, -1).cpu()
                              == torch.argmax(logits_int, -1).cpu()
                              ).to(torch.float32)))
    return {"within_1lsb": within / max(total, 1), "max_dev": max_dev,
            "argmax_agree": agree}
