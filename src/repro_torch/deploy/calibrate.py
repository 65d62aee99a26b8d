"""Calibration: per-layer activation ranges and bit-width sensitivities
for the deploy planner.

**LMs** (`calibrate`): an eager per-depth replay of the fp model (stacked
layer params indexed per depth, the layer run by `models/lm.py::_block`,
as the forward runs it) with the `nn/layers.py::dense_tap` observer
installed. For every quantized dense path the tap records

  a_absmax   — the running max |x| over every calibration token (the
               static activation scale the int serving path uses), and
  sens[b]    — the relative output MSE of the simulated W{b}A{a_bits}
               integer GEMM against the fp matmul, per candidate w_bits b,
               summed over depth instances and batches (on at most
               ``max_rows`` rows per tap; per output channel too).

The simulation is the deployed integer dense without packing: the
serving weight grid (`quantize_dense_weights`, per output channel) and
activations symmetric on the a_bits grid, divided by a float32 tensor as
the serving quantizer divides. Families without a replay (mamba, griffin,
the enc-dec and the cross-attention LMs) fall back to weight-only
sensitivities (a unit activation second moment, the default absmax), as
the reference does. MoE archs replay: the shared expert's denses are
tapped; the router and the routed experts stay float and are no
quantized path.

**CNNs** (`calibrate_vision`): the fp net is replayed once per
calibration batch with two observers: the `vision.layers.conv_tap`
observer sees every conv's, depthwise conv's and the head's input, and
prices each candidate weight width b by the squared output error of a
simulated W{b}A{a_bits} op against the fp op on the layer's real geometry
(weights on the per-tensor symmetric grid the vision packers deploy,
activations symmetric on the a_bits grid); an edge tap records every
layer boundary's absmax, which `quantize_net` turns into the chained
activation grids.

Both give `CalibStats`, which feed `deploy.planner.plan_mixed_precision`.
The float sums are float32 torch reductions; they agree with the
reference's XLA reductions to rounding, not bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import packing
from repro_torch.core.calibration import calibrate_weight
from repro_torch.core.quantize import dequantize, quantize
from repro_torch.deploy.apply import (dense_inventory, dense_weight,
                                     quantized_dense_paths)
from repro_torch.nn.layers import dense_tap, quantize_dense_weights
from repro_torch.obs import trace as obs

CANDIDATE_BITS = (8, 4, 2)


@dataclasses.dataclass
class CalibStats:
    """Accumulated calibration record for one compute path."""

    path: str
    layers: int                 # stacked depth instances (1 for vision)
    d_in: int
    d_out: int
    a_absmax: float = 0.0
    sq_err: Dict[int, float] = dataclasses.field(default_factory=dict)
    sq_ref: float = 0.0
    taps: int = 0
    # per-output-channel squared error, (d_out,) float64 per candidate
    # width: the channel-group planner's signal; sums to sq_err[b]
    col_sq_err: Dict[int, np.ndarray] = dataclasses.field(
        default_factory=dict)

    def sens(self, bits: int) -> float:
        """Relative output MSE at w_bits=bits (the planner's cost unit)."""
        return self.sq_err.get(bits, 0.0) / (self.sq_ref + 1e-12)

    def col_sens(self, bits: int) -> Optional[np.ndarray]:
        """(d_out,) per-channel relative MSE at w_bits=bits, normalized
        as `sens`; None when no channel detail was recorded."""
        cols = self.col_sq_err.get(bits)
        if cols is None:
            return None
        return np.asarray(cols, np.float64) / (self.sq_ref + 1e-12)

    def _add_col_err(self, bits: int, err: torch.Tensor):
        """Accumulate one tap's per-channel squared error (err: (..., N))."""
        cols = (err.to(torch.float32) ** 2).sum(
            dim=tuple(range(err.dim() - 1)))
        cols = cols.cpu().numpy().astype(np.float64)
        prev = self.col_sq_err.get(bits)
        self.col_sq_err[bits] = cols if prev is None else prev + cols


# ------------------------------------------------------------------ LM ---

def _sim_int_dense(x, w, w_bits: int, a_bits: int, a_absmax: float):
    """The deployed integer dense without packing: the serving weight grid
    (`quantize_dense_weights`, shared with `apply_plan`), activations on
    the symmetric a_bits grid; float32 in and out."""
    w_hat, w_scale = quantize_dense_weights(w, w_bits)
    x_q, a_scale = _act_codes(x, a_bits, a_absmax)
    return (x_q @ w_hat.to(torch.float32)) * (w_scale * a_scale)


def _walk_dense_ids(tree, prefix: Tuple[str, ...] = ()):
    """id(w leaf) -> "/"-joined dense path, for one layer's params. The
    replay passes this very dict into the layer, so `dense_apply` sees
    these tensor objects."""
    out = {}
    if isinstance(tree, dict):
        if "w" in tree and not isinstance(tree["w"], dict):
            out[id(tree["w"])] = "/".join(prefix)
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(_walk_dense_ids(v, prefix + (k,)))
    return out


class _Collector:
    """`dense_tap` observer of the LM replay: per-path activation absmax
    over every token, and the simulated-W{b} output error on at most
    ``max_rows`` rows of each tap."""

    def __init__(self, stats: Dict[str, CalibStats], bits: Sequence[int],
                 a_bits: int, max_rows: int):
        self.stats = stats
        self.bits = tuple(bits)
        self.a_bits = a_bits
        self.max_rows = max_rows
        self.id2path: Dict[int, str] = {}

    def __call__(self, p, x):
        w = p.get("w")
        if w is None:
            return
        path = self.id2path.get(id(w))
        if path is None or path not in self.stats:
            return
        st = self.stats[path]
        x2 = x.to(torch.float32).reshape(-1, x.shape[-1])
        # the static serving scale must see every token; only the MSE
        # simulation below is subsampled
        absmax = float(torch.max(torch.abs(x2)))
        st.a_absmax = max(st.a_absmax, absmax)
        if x2.shape[0] > self.max_rows:
            stride = -(-x2.shape[0] // self.max_rows)
            x2 = x2[::stride]
        wf = w.to(torch.float32)
        y_ref = x2 @ wf
        st.sq_ref += float(torch.sum(y_ref * y_ref))
        for b in self.bits:
            err = _sim_int_dense(x2, wf, b, self.a_bits, absmax) - y_ref
            st.sq_err[b] = st.sq_err.get(b, 0.0) + float(torch.sum(err * err))
            st._add_col_err(b, err)
        st.taps += 1


def _replay_lm(model, params, tokens, collector):
    """Eager per-depth replay of `models/lm.py::forward`'s self layers (no
    cross layers) on one (B, S) token batch."""
    from repro_torch.models.lm import (_block, _compute_dtype, _embed,
                                       _layer_split, _ropes, _schedule,
                                       layer_params)
    cfg = model.cfg
    dtype = _compute_dtype(cfg)
    dev = params["embed"]["table"].device
    x = _embed(params, torch.as_tensor(np.asarray(tokens), device=dev), cfg,
               dtype)
    s = x.shape[1]
    glob, loc = _ropes(cfg, s, dtype, dev)
    sched = _schedule(cfg, s)
    for i in range(_layer_split(cfg)[0]):
        lp = layer_params(params["layers"], i)
        collector.id2path = _walk_dense_ids(lp, ("layers",))
        window, local_rope = sched[i]
        cos, sin = loc if local_rope else glob
        x, _, _ = _block(cfg, lp, x, cos, sin, window)
    return x


def _weight_only(stats: Dict[str, CalibStats], fp_params, bits,
                 a_absmax: float):
    """Fallback sensitivity: weight-quantization MSE under a unit
    activation second moment; a_absmax stays at the default. A stacked
    (L, K, N) weight is priced as one (L*K, N) matrix, one scale per
    column across the layers, as the reference prices it."""
    for path, st in stats.items():
        w = dense_weight(fp_params, path).to(torch.float32)
        w2 = w.reshape(-1, w.shape[-1]) if w.dim() == 3 else w
        st.a_absmax = a_absmax
        st.sq_ref += float(torch.sum(w2 * w2))
        for b in bits:
            w_hat, scale = quantize_dense_weights(w2, b)
            err = w_hat.to(torch.float32) * scale - w2
            st.sq_err[b] = st.sq_err.get(b, 0.0) + float(torch.sum(err * err))
            st._add_col_err(b, err)
        st.taps += 1


def calibrate(model, fp_params, token_batches: Sequence[np.ndarray], *,
              bits: Sequence[int] = CANDIDATE_BITS, a_bits: int = 8,
              max_rows: int = 512,
              default_a_absmax: float = 4.0) -> Dict[str, CalibStats]:
    """Run (B, S) integer token batches through the fp LM on its params'
    device: per quantized dense path, its `CalibStats`."""
    from repro_torch.models.api import Model
    from repro_torch.nn.layers import QuantConfig

    cfg = model.cfg
    q_defs = Model(dataclasses.replace(cfg, quant=QuantConfig(mode="int"),
                                       quant_plan=None)).defs()
    paths = quantized_dense_paths(q_defs)
    inv = dense_inventory(fp_params, paths)
    stats = {p: CalibStats(p, *inv[p]) for p in paths}

    if cfg.family == "lm" and not cfg.cross_every:
        collector = _Collector(stats, bits, a_bits, max_rows)
        with dense_tap(collector):
            for i, toks in enumerate(token_batches):
                with obs.span("calibrate.batch", cat="deploy", batch=i,
                              tokens=int(np.asarray(toks).size)):
                    _replay_lm(model, fp_params, toks, collector)
        # a path the replay never reaches falls back to weight-only, so
        # the planner always sees every path
        missed = {p: st for p, st in stats.items() if st.taps == 0}
        if missed:
            _weight_only(missed, fp_params, bits, default_a_absmax)
    else:
        _weight_only(stats, fp_params, bits, default_a_absmax)
    return stats


# -------------------------------------------------------------- vision ---

def _sim_quant_weights(w: torch.Tensor, b: int) -> torch.Tensor:
    """Quantize-dequantize ``w`` on the per-tensor symmetric grid the
    vision packers deploy (`calibrate_weight` -> `quantize`)."""
    spec = calibrate_weight(w, b)
    return dequantize(quantize(w, spec), spec)


def _act_codes(x: torch.Tensor, a_bits: int, absmax: float):
    """(codes, scale): activations on the symmetric a_bits grid, as
    floats. The divisor is a float32 tensor, as in `quantize`."""
    a_max = packing.int_range(a_bits, True)[1]
    a_scale = max(absmax, 1e-8) / a_max
    div = torch.tensor(a_scale, dtype=torch.float32, device=x.device)
    return torch.clamp(torch.round(x / div), -a_max, a_max), a_scale


def _sim_quant_acts(x: torch.Tensor, a_bits: int,
                    absmax: float) -> torch.Tensor:
    """Activations on the symmetric a_bits grid, dequantized."""
    codes, a_scale = _act_codes(x, a_bits, absmax)
    return codes * a_scale


def _hwio(w: torch.Tensor) -> torch.Tensor:
    """A conv's (fh, fw, Cin, Cout) weights as they are; a depthwise
    layer's (fh, fw, C) as (fh, fw, 1, C)."""
    return w.reshape(*w.shape[:2], 1, w.shape[-1]) if w.dim() == 3 else w


def _sim_int_conv(x, w, b: int, a_bits: int, absmax: float, *,
                  stride: int, padding: int, groups: int) -> torch.Tensor:
    """Simulated W{b}A{a_bits} conv for the sensitivity proxy: the
    quantize-dequantize image of the deployed integer conv (``groups`` =
    C for a depthwise layer)."""
    from repro_torch.vision.layers import conv2d_raw

    return conv2d_raw(_sim_quant_acts(x, a_bits, absmax),
                      _hwio(_sim_quant_weights(w, b)), stride=stride,
                      padding=padding, groups=groups)


class _ConvCollector:
    """`conv_tap` observer for the vision fp replay: per-layer input
    absmax and simulated-W{b} output-error sensitivity, priced against
    the fp op on the layer's geometry."""

    def __init__(self, stats: Dict[str, CalibStats], geom: Dict[str, dict],
                 id2path: Dict[int, str], bits: Sequence[int], a_bits: int,
                 max_images: int):
        self.stats = stats
        self.geom = geom
        self.id2path = id2path
        self.bits = tuple(bits)
        self.a_bits = a_bits
        self.max_images = max_images

    def __call__(self, p, x):
        from repro_torch.vision.layers import conv2d_raw

        w = p.get("w")
        path = self.id2path.get(id(w)) if w is not None else None
        if path is None or path not in self.stats:
            return
        st = self.stats[path]
        g = self.geom[path]
        xf = x.to(torch.float32)
        absmax = float(torch.max(torch.abs(xf)))
        st.a_absmax = max(st.a_absmax, absmax)
        if xf.dim() == 4 and xf.shape[0] > self.max_images:
            xf = xf[:self.max_images]
        wf = w.to(torch.float32)
        if g["kind"] == "linear":
            y_ref = xf @ wf
        else:
            y_ref = conv2d_raw(xf, _hwio(wf), stride=g["stride"],
                               padding=g["padding"], groups=g["groups"])
        st.sq_ref += float(torch.sum(y_ref * y_ref))
        for b in self.bits:
            if g["kind"] == "linear":
                y_q = (_sim_quant_acts(xf, self.a_bits, absmax)
                       @ _sim_quant_weights(wf, b))
            else:
                y_q = _sim_int_conv(xf, wf, b, self.a_bits, absmax,
                                    stride=g["stride"],
                                    padding=g["padding"],
                                    groups=g["groups"])
            err = y_q - y_ref
            st.sq_err[b] = st.sq_err.get(b, 0.0) + float(torch.sum(err * err))
            st._add_col_err(b, err)
        st.taps += 1


def _vision_stats_geom(cfg, fp_params):
    """Per compute path: an empty `CalibStats` with the deployable
    artifact's (d_in, d_out), the layer geometry, and the id(w) -> path
    map the conv tap needs. A depthwise layer's artifact is its
    block-diagonal GEMM, (fh*fw*C, C)."""
    from repro_torch.vision.models import (COMPUTE_KINDS, get_path,
                                           trace_shapes)

    stats: Dict[str, CalibStats] = {}
    geom: Dict[str, dict] = {}
    id2path: Dict[int, str] = {}
    for t in trace_shapes(cfg):
        L, (_, _, c) = t["layer"], t["in"]
        if L.kind not in COMPUTE_KINDS:
            continue
        if L.kind == "conv":
            d_in, d_out, groups = L.fh * L.fw * c, L.cout, 1
        elif L.kind == "dwconv":
            d_in, d_out, groups = L.fh * L.fw * c, c, c
        else:
            d_in, d_out, groups = c, L.cout, 1
        stats[L.path] = CalibStats(L.path, 1, d_in, d_out)
        geom[L.path] = {"kind": L.kind, "stride": L.stride,
                        "padding": L.padding, "groups": groups}
        id2path[id(get_path(fp_params, L.path)["w"])] = L.path
    return stats, geom, id2path


def calibrate_vision(cfg, fp_params, image_batches: Sequence[np.ndarray], *,
                     bits: Sequence[int] = CANDIDATE_BITS, a_bits: int = 8,
                     max_images: int = 64, sensitivity: str = "mse",
                     labels: Optional[Sequence[np.ndarray]] = None,
                     group_size: int = packing.CHUNK):
    """Calibrate a vision net on (B, H, W, C) float image batches, on the
    fp params' device: returns (per-layer `CalibStats`, per-edge absmax).

    ``sensitivity`` selects the per-layer cost signal:

    * ``"mse"`` (default): the output-error proxy of `_ConvCollector`,
      label-free, pricing local layer error.
    * ``"task_loss"``: the cross-entropy degradation on labeled batches
      when that layer (or one CHUNK-wide output-channel group of it)
      alone is quantized to the candidate width: sens(b) =
      max(loss_quantized(b) - loss_float, 0), sq_ref = 1. Needs
      ``labels`` (one int array per image batch). Deterministic: pure
      forwards, no sampling.
    """
    if sensitivity == "task_loss":
        return _calibrate_vision_task_loss(
            cfg, fp_params, image_batches, labels, bits=bits,
            a_bits=a_bits, group_size=group_size)
    if sensitivity != "mse":
        raise ValueError(f"unknown sensitivity {sensitivity!r}; expected "
                         "'mse' or 'task_loss'")
    from repro_torch.vision.layers import conv_tap
    from repro_torch.vision.models import forward_fp, get_path

    stats, geom, id2path = _vision_stats_geom(cfg, fp_params)
    dev = get_path(fp_params, next(iter(stats)))["w"].device
    absmax: Dict[str, float] = {}

    def edge_tap(path, tensor):
        absmax[path] = max(absmax.get(path, 0.0),
                           float(torch.max(torch.abs(tensor))))

    collector = _ConvCollector(stats, geom, id2path, bits, a_bits,
                               max_images)
    with conv_tap(collector):
        for i, imgs in enumerate(image_batches):
            imgs = np.asarray(imgs, np.float32)
            with obs.span("calibrate.batch", cat="deploy", batch=i,
                          images=int(imgs.shape[0])):
                forward_fp(cfg, fp_params, torch.from_numpy(imgs).to(dev),
                           edge_tap=edge_tap)
    return stats, absmax


def _mean_ce_loss(cfg, params, xs, ys) -> float:
    """Mean cross-entropy of the fp forward over the labeled batches (a
    host float64 sum of per-batch float32 sums)."""
    from repro_torch.vision.models import forward_fp

    total = n = 0.0
    for x, y in zip(xs, ys):
        logits = forward_fp(cfg, params, x)
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        picked = torch.gather(logp, -1, y[:, None])
        total += float(-torch.sum(picked))
        n += picked.numel()
    return total / max(n, 1.0)


def _with_quantized_path(fp_params, path: str, w_q):
    """A shallow copy of the param tree with ``path``'s weight replaced."""
    parts = path.split("/")
    out = dict(fp_params)
    node = out
    for p in parts[:-1]:
        node[p] = dict(node[p])
        node = node[p]
    leaf = dict(node[parts[-1]])
    leaf["w"] = w_q
    node[parts[-1]] = leaf
    return out


@torch.no_grad()
def _calibrate_vision_task_loss(cfg, fp_params, image_batches, labels, *,
                                bits, a_bits, group_size):
    """Task-loss sensitivity: the loss degradation per (layer, width) and
    per (channel group, width), on the deployed per-tensor / per-run
    grids. Only weights are quantized (the planner's one degree of
    freedom is weight width). A group quantizes one CHUNK-aligned
    output-channel slice on its own per-run grid, as the segmented conv
    deploys it; group sensitivities are rescaled to sum to the layer's,
    so the knapsack budget is the same at either granularity."""
    from repro_torch.vision.layers import conv_tap
    from repro_torch.vision.models import forward_fp, get_path

    if labels is None:
        raise ValueError("sensitivity='task_loss' needs labels= (one int "
                         "label array per image batch)")
    if len(labels) != len(image_batches):
        raise ValueError(f"{len(image_batches)} image batches but "
                         f"{len(labels)} label batches")
    stats, geom, _ = _vision_stats_geom(cfg, fp_params)
    dev = get_path(fp_params, next(iter(stats)))["w"].device
    xs = [torch.from_numpy(np.asarray(x, np.float32)).to(dev)
          for x in image_batches]
    ys = [torch.from_numpy(np.asarray(y).astype(np.int64)).to(dev)
          for y in labels]

    # one taped pass: the edge absmax (the activation grids) and each
    # layer's input absmax (PlanRule.a_absmax)
    absmax: Dict[str, float] = {}

    def edge_tap(path, tensor):
        absmax[path] = max(absmax.get(path, 0.0),
                           float(torch.max(torch.abs(tensor))))

    def input_tap(p, x):
        w = p.get("w")
        if w is None:
            return
        for path, st in stats.items():
            if get_path(fp_params, path)["w"] is w:
                st.a_absmax = max(st.a_absmax,
                                  float(torch.max(torch.abs(x))))

    with conv_tap(input_tap):
        for x in xs:
            forward_fp(cfg, fp_params, x, edge_tap=edge_tap)
        base_loss = _mean_ce_loss(cfg, fp_params, xs, ys)

    with obs.span("calibrate.task_loss", cat="deploy", arch=cfg.name,
                  paths=len(stats), batches=len(xs),
                  base_loss=base_loss) as sp:
        evals = 0
        for path, st in stats.items():
            st.sq_ref = 1.0
            w = get_path(fp_params, path)["w"].to(torch.float32)
            d_out = st.d_out
            n_groups = -(-d_out // group_size)
            for b in bits:
                w_q = _sim_quant_weights(w, b)
                loss_b = _mean_ce_loss(
                    cfg, _with_quantized_path(fp_params, path, w_q), xs, ys)
                evals += 1
                sens = max(loss_b - base_loss, 0.0)
                st.sq_err[b] = sens
                cols = np.zeros((d_out,), np.float64)
                if n_groups > 1 and geom[path]["kind"] == "conv":
                    for s in range(0, d_out, group_size):
                        e = min(s + group_size, d_out)
                        w_g = w.clone()
                        w_g[..., s:e] = _sim_quant_weights(w[..., s:e], b)
                        loss_g = _mean_ce_loss(
                            cfg, _with_quantized_path(fp_params, path, w_g),
                            xs, ys)
                        evals += 1
                        cols[s:e] = max(loss_g - base_loss, 0.0) / (e - s)
                    gsum = cols.sum()
                    if gsum > 0 and sens > 0:
                        cols *= sens / gsum
                    elif sens > 0:
                        cols[:] = sens / d_out
                else:
                    # one group (or depthwise / the head): channel detail
                    # adds nothing; apportion uniformly
                    cols[:] = sens / max(d_out, 1)
                st.col_sq_err[b] = cols
            st.taps = len(xs)
        sp.set(loss_evals=evals)
    return stats, absmax
