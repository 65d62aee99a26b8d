"""The QAT loop for the vision nets: fake-quant forward, autograd, AdamW.

One loop serves four roles:

* **QAT uniform** (``w_bits`` in {8, 4, 2}): every compute layer's
  weights fake-quantized per tensor, every requantizing edge on the
  unsigned a_bits grid (EMA-tracked absmax; ``learned_absmax=True``
  learns PACT ranges instead).
* **QAT planned** (``plan=``): per-layer widths and per-output-channel
  run widths resolved through the deployment's own `resolve_qcfg`, so
  training quantizes exactly what deploys.
* **Float / PTQ baseline** (``w_bits=None``): float training; the EMA
  absmax tracker still runs, so the result carries its own activation
  calibration for the PTQ rows.
* **Fine-tune from a checkpoint** (``from_ckpt=``).

The forward mirrors `vision.models.forward_fp` edge for edge:
requantizing layers (conv, dwconv, global avg-pool, residual add) get an
activation fake-quant at their output, max pooling inherits its input's
grid, the head emits raw float logits. Gradients come from
`torch.autograd` (the reference's ``jax.value_and_grad``); the
optimizer is `train.optimizer`'s AdamW. ``mesh=`` splits each batch over
the mesh's ``data`` axis (`parallel.mesh.run_per_shard`): every position
differentiates its shard's share of the global mean loss, the gradients
are summed, each edge's observed absmax is the max over the shards, and
the state stays replicated.

Training is reproducible from its seed on the card as on the CPU (the
reference's is): the loop runs cuDNN's deterministic convolution
algorithms. The nondeterministic ones sum a weight gradient in another
order on each run, and 1,000 W2 steps turn that last-bit difference
into a different model (W2 test accuracy 0.12-0.38 for one seed).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.deploy.policy import PrecisionPlan, resolve_qcfg
from repro_torch.device import resolve_device
from repro_torch.nn.layers import QuantConfig
from repro_torch.obs import trace as obs
from repro_torch.qat import fakequant as fq
from repro_torch.nn.module import leaf_paths, tree_like
from repro_torch.train.optimizer import OptConfig, adamw_init, adamw_update
from repro_torch.vision import layers as vl
from repro_torch.vision.models import COMPUTE_KINDS, VisionConfig, get_path

ACT_KEY = "__act_absmax__"   # learned-range leaves live inside params


@dataclasses.dataclass(frozen=True)
class QATConfig:
    steps: int = 200
    batch: int = 64
    lr: float = 1e-2
    warmup: int = 20
    weight_decay: float = 1e-4
    clip_norm: float = 1.0
    w_bits: Optional[int] = 8     # None => float training (PTQ baseline)
    a_bits: int = 8
    ema_momentum: float = 0.9
    learned_absmax: bool = False  # PACT learned ranges instead of EMA
    seed: int = 0
    log_every: int = 20
    ckpt_every: int = 50


@dataclasses.dataclass(frozen=True)
class LayerQuant:
    """Static per-compute-layer quantization resolved from the plan."""

    w_bits: int
    segments: Optional[Tuple[Tuple[int, int, int], ...]] = None


def resolve_layer_quant(cfg: VisionConfig, plan: Optional[PrecisionPlan],
                        default_w_bits: int, a_bits: int
                        ) -> Dict[str, LayerQuant]:
    """Per-path (w_bits, segments) through the deployment's own
    `resolve_qcfg`: training and packing cannot disagree on widths."""
    base = QuantConfig(mode="int", w_bits=default_w_bits, a_bits=a_bits)
    out = {}
    for L in cfg.layers:
        if L.kind not in COMPUTE_KINDS:
            continue
        qcfg = resolve_qcfg(plan, L.path, base)
        segs = (tuple(tuple(r) for r in qcfg.segments)
                if qcfg.segments is not None else None)
        out[L.path] = LayerQuant(w_bits=qcfg.w_bits, segments=segs)
    return out


def _fq_w(w, lq: Optional[LayerQuant]):
    if lq is None:
        return w
    if lq.segments is not None:
        return fq.fake_quant_weight_segmented(w, lq.segments)
    return fq.fake_quant_weight(w, lq.w_bits)


def qat_forward(cfg: VisionConfig, params: dict, x: torch.Tensor,
                betas: Dict[str, torch.Tensor], *,
                lquant: Optional[Dict[str, LayerQuant]], a_bits: int,
                learned: bool = False,
                edge_tap: Optional[Callable] = None):
    """Fake-quant forward; returns (float logits, observed absmax).

    ``lquant=None`` turns every fake-quant off (the float forward) and
    still observes ranges: ``observed`` maps "__input__" and every
    requantizing layer's path to the batch's absmax before quantization.
    ``edge_tap(path, value)`` observes every fake-quanted edge. The
    float ReLU is ``maximum(t, 0)``, whose gradient splits an exact tie
    in halves as the reference's does."""
    quant = lquant is not None
    observed: Dict[str, torch.Tensor] = {}
    zero = torch.zeros((), dtype=x.dtype, device=x.device)

    def act(path, t, relu=False):
        observed[path] = fq.batch_absmax(t)
        if not quant:
            return torch.maximum(t, zero) if relu else t
        y = fq.fake_quant_act(t, betas[path], a_bits, learned=learned)
        if edge_tap is not None:
            edge_tap(path, y)
        return y

    stream = act("__input__", x)
    edges: Dict[str, torch.Tensor] = {}
    for L in cfg.layers:
        xin = edges[L.input_from] if L.input_from else stream
        if L.kind == "conv":
            p = get_path(params, L.path)
            w = _fq_w(p["w"], lquant.get(L.path) if quant else None)
            y = vl.conv2d_raw(xin, w, stride=L.stride, padding=L.padding)
            y = act(L.path, y * p["bn_scale"] + p["bn_bias"], relu=True)
        elif L.kind == "dwconv":
            p = get_path(params, L.path)
            w = _fq_w(p["w"], lquant.get(L.path) if quant else None)
            c = w.shape[-1]
            y = vl.conv2d_raw(xin, w.reshape(*w.shape[:2], 1, c),
                              stride=L.stride, padding=L.padding, groups=c)
            y = act(L.path, y * p["bn_scale"] + p["bn_bias"], relu=True)
        elif L.kind == "maxpool":
            y = vl.maxpool_fp(xin, L.window, L.stride)   # grid-preserving
        elif L.kind == "avgpool_global":
            y = act(L.path, vl.avgpool_global_fp(xin))
        elif L.kind == "add":
            y = act(L.path, xin + edges[L.skip_from])
        elif L.kind == "linear":
            p = get_path(params, L.path)
            w = _fq_w(p["w"], lquant.get(L.path) if quant else None)
            y = xin @ w                                  # raw logits
        else:
            raise ValueError(f"{L.path}: unknown kind {L.kind!r}")
        if L.save_as:
            edges[L.save_as] = y
        if not L.branch:
            stream = y
    return stream, observed


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  n: Optional[int] = None) -> torch.Tensor:
    """Mean cross-entropy; with ``n``, the sum over these rows divided by
    ``n`` (a shard's share of the global mean)."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    picked = torch.gather(logp, -1, labels.long()[:, None])
    if n is None:
        return -torch.mean(picked)
    return -torch.sum(picked) / n


def _shards(mesh, batch):
    """The batch's per-data-block pieces: [(pos, x, y)]."""
    from repro_torch.parallel.mesh import (NamedSharding, P, Sharded,
                                           block_entry, data_blocks,
                                           device_put)
    if mesh.shape.get("model", 1) > 1:
        raise NotImplementedError(
            "QAT on a mesh is data-parallel only (as the reference's); a "
            f"'model' axis of {mesh.shape['model']} is not supported")
    out = {}
    for k in ("x", "y"):
        v = batch[k]
        if not isinstance(v, Sharded):
            v = device_put(v, NamedSharding(mesh, P(block_entry(mesh))))
        out[k] = v
    return [(p, out["x"].shards[p], out["y"].shards[p])
            for p in data_blocks(mesh)]


def make_qat_step(cfg: VisionConfig, qc: QATConfig,
                  lquant: Optional[Dict[str, LayerQuant]],
                  opt_cfg: OptConfig, mesh=None):
    """One (state, batch) -> (state, metrics) QAT step. ``batch`` holds
    "x" (N, H, W, C) float32 and "y" (N,) labels, tensors (or `Sharded`
    over ``mesh``'s data axis)."""

    def grads_of(params, absmax, x, y, n):
        """(loss, correct, observed, grads) of these rows, on x's device."""
        paths, leaves = zip(*leaf_paths(params))
        req = [t.detach().to(x.device).requires_grad_(True) for t in leaves]
        p = tree_like(zip(paths, req))
        betas = (p[ACT_KEY] if qc.learned_absmax
                 else {k: v.to(x.device) for k, v in absmax.items()})
        with torch.enable_grad():
            logits, observed = qat_forward(
                cfg, p, x, betas, lquant=lquant, a_bits=qc.a_bits,
                learned=qc.learned_absmax)
            loss = cross_entropy(logits, y, n)
            grads = torch.autograd.grad(loss, req)
        correct = torch.sum(torch.argmax(logits.detach(), -1) == y.long())
        return loss.detach(), correct, observed, grads

    def step(state, batch):
        params, absmax = state["params"], state["absmax"]
        n = int(batch["y"].shape[0])
        if mesh is None:
            loss, correct, observed, grads = grads_of(
                params, absmax, batch["x"], batch["y"], None)
        else:
            from repro_torch.parallel.mesh import run_per_shard
            parts = _shards(mesh, batch)
            outs = run_per_shard(
                mesh, lambda pos, x, y: grads_of(params, absmax, x, y, n),
                [(x, y) for _, x, y in parts], [p for p, _, _ in parts])
            dev = leaf_paths(params)[0][1].device
            loss = sum(o[0].to(dev) for o in outs)
            correct = sum(o[1].to(dev) for o in outs)
            observed = {k: torch.amax(torch.stack(
                [o[2][k].to(dev) for o in outs])) for k in outs[0][2]}
            grads = [sum(o[3][i].to(dev) for o in outs)
                     for i in range(len(outs[0][3]))]
        grads = tree_like(zip((q for q, _ in leaf_paths(params)), grads))
        new_p, new_opt, om = adamw_update(params, grads, state["opt"],
                                          opt_cfg)
        new_absmax = {k: fq.ema_update(v, observed[k], qc.ema_momentum)
                      for k, v in absmax.items()}
        acc = correct.to(torch.float32) / n
        return ({"params": new_p, "absmax": new_absmax, "opt": new_opt},
                {"loss": loss, "acc": acc, **om})

    return step


def _absmax_paths(cfg: VisionConfig):
    """The edges with their own activation grid at deployment: the net
    input and every requantizing layer."""
    paths = ["__input__"]
    for L in cfg.layers:
        if L.kind in ("conv", "dwconv", "avgpool_global", "add"):
            paths.append(L.path)
    return paths


@dataclasses.dataclass
class QATResult:
    """Trained artifact: params, activation ranges, and the quantization
    the net was trained under (what `qat.evaluate.deploy` folds)."""

    cfg: VisionConfig
    qc: QATConfig
    params: dict                      # may carry ACT_KEY learned ranges
    absmax: Dict[str, torch.Tensor]   # EMA-tracked per-edge ranges
    lquant: Optional[Dict[str, LayerQuant]]
    plan: Optional[PrecisionPlan]
    log: list

    def model_params(self) -> dict:
        """Params without the learned-range leaves (what deploys)."""
        return {k: v for k, v in self.params.items() if k != ACT_KEY}

    def deployment_absmax(self) -> Dict[str, float]:
        """Per-edge absmax for `vision.models.quantize_net`: the trained
        ranges are the deployment calibration."""
        src = (self.params[ACT_KEY] if self.qc.learned_absmax
               else self.absmax)
        return {k: float(v) for k, v in src.items()}


def _unit_bn_init(cfg: VisionConfig, seed: int, dev) -> dict:
    """`init_fp` with every conv's bn_scale set to 1: `init_fp`'s ~0.4 is
    tuned for the deploy nets' activation headroom, and training from
    scratch through several such attenuating affines stalls."""
    from repro_torch.vision.models import init_fp

    params = init_fp(cfg, seed=seed, device=dev)
    for L in cfg.layers:
        if L.kind in ("conv", "dwconv"):
            node = get_path(params, L.path)
            node["bn_scale"] = torch.ones_like(node["bn_scale"])
    return params


@contextlib.contextmanager
def deterministic_convs():
    """cuDNN's deterministic convolution algorithms, no autotuning, for
    the block; the previous settings after it."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


@deterministic_convs()
def train_qat(cfg: VisionConfig, data, qc: QATConfig, *,
              plan: Optional[PrecisionPlan] = None,
              init_params: Optional[dict] = None, mesh=None,
              ckpt_dir=None, from_ckpt=None, device="cuda") -> QATResult:
    """Train ``cfg`` on ``data`` (the `qat.data` iterator API) on
    ``device``.

    ``plan`` resolves per-layer (segmented) widths; ``mesh`` splits each
    batch over its 'data' axis; ``ckpt_dir`` / ``from_ckpt`` save and
    resume the whole training state through `ckpt.checkpoint`."""
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.convert import to_device

    dev = resolve_device(device)
    lquant = (None if qc.w_bits is None and plan is None
              else resolve_layer_quant(cfg, plan, qc.w_bits or 8,
                                       qc.a_bits))
    opt_cfg = OptConfig(lr=qc.lr, warmup=qc.warmup, total_steps=qc.steps,
                        weight_decay=qc.weight_decay,
                        clip_norm=qc.clip_norm)

    batches = data.batches(qc.batch, qc.steps)
    start_step = 0
    if from_ckpt is not None:
        state, start_step = ckpt.restore(from_ckpt, device=dev)
    else:
        params = (to_device(init_params, dev) if init_params is not None
                  else _unit_bn_init(cfg, qc.seed, dev))
        # seed the ranges from one real batch (the float, tap-free
        # observation forward) so step 0 fake-quantizes on sane grids
        x0, _ = next(batches)
        with torch.no_grad():
            _, obs0 = qat_forward(cfg, params, torch.from_numpy(
                np.asarray(x0, np.float32)).to(dev), {}, lquant=None,
                a_bits=qc.a_bits)
        absmax = {k: torch.tensor(float(obs0[k]), dtype=torch.float32,
                                  device=dev) for k in _absmax_paths(cfg)}
        if qc.learned_absmax:
            params = dict(params)
            params[ACT_KEY] = {k: v.clone() for k, v in absmax.items()}
        state = {"params": params, "absmax": absmax,
                 "opt": adamw_init(params, opt_cfg)}

    step_fn = make_qat_step(cfg, qc, lquant, opt_cfg, mesh=mesh)
    log = []
    with obs.span("qat.train", cat="qat", net=cfg.name,
                  steps=qc.steps, w_bits=(qc.w_bits or 0),
                  a_bits=qc.a_bits, planned=plan is not None) as sp:
        for i in range(start_step, qc.steps):
            try:
                x, y = next(batches)
            except StopIteration:
                batches = data.batches(qc.batch, qc.steps)
                x, y = next(batches)
            batch = {"x": torch.from_numpy(np.asarray(x, np.float32)).to(dev),
                     "y": torch.from_numpy(np.asarray(y, np.int32)).to(dev)}
            state, metrics = step_fn(state, batch)
            if (i % qc.log_every == 0) or (i == qc.steps - 1):
                log.append({"step": i, "loss": float(metrics["loss"]),
                            "acc": float(metrics["acc"])})
            if ckpt_dir is not None and ((i + 1) % qc.ckpt_every == 0
                                         or i == qc.steps - 1):
                ckpt.save(ckpt_dir, i + 1, state)
        if log:
            sp.set(final_loss=log[-1]["loss"], final_acc=log[-1]["acc"])

    return QATResult(cfg=cfg, qc=qc, params=state["params"],
                     absmax=state["absmax"], lquant=lquant, plan=plan,
                     log=log)
