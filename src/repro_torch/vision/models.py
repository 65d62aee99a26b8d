"""Vision model graphs: one LayerDef list, interpreted twice.

A `VisionConfig` is an ordered tuple of `LayerDef`s — a flat dataflow
graph with named side edges for residual skips and branch layers. The
same graph drives `forward_fp` (the float calibration forward) and
`forward_int` (the deployed integer forward: uint{a_bits} integer images
at every boundary, int32 accumulation inside the layers, the eq. 3/4
epilogue at each output, routed through `repro_torch.kernels.api`).

`quantize_net` turns (fp params, per-edge absmax, `PrecisionPlan`) into
the deployable `QuantizedVisionNet` on one device; its arrays are
byte-identical to the reference's for the same inputs.

Spans (`repro_torch.obs`): `quantize` opens ``vision/quantize`` and
`forward_int` one ``vision/<path>`` per layer, one after another, so a
profiled forward is tiled by its layers.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.quantize import QuantizedLinearParams, QuantSpec
from repro_torch.core.quantize import quantize as _quantize
from repro_torch.deploy.policy import PrecisionPlan, resolve_qcfg
from repro_torch.device import resolve_device
from repro_torch.kernels.api import check_backend
from repro_torch.nn.layers import QuantConfig
from repro_torch.obs import trace as obs
from repro_torch.parallel.sharding import (shard_packed_conv,
                                           shard_packed_linear)
from repro_torch.vision import layers as vl

COMPUTE_KINDS = ("conv", "dwconv", "linear")    # plan-addressable layers


@dataclasses.dataclass(frozen=True)
class LayerDef:
    """One graph node. ``path`` doubles as the param/plan label."""

    path: str
    kind: str                 # conv | dwconv | linear | maxpool |
                              # avgpool_global | add
    cout: int = 0
    fh: int = 3
    fw: int = 3
    stride: int = 1
    padding: int = 1
    window: int = 2
    input_from: Optional[str] = None   # read a saved edge, not the stream
    save_as: Optional[str] = None      # save output under this edge name
    branch: bool = False               # do not advance the main stream
    skip_from: Optional[str] = None    # add: second operand edge


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    name: str
    layers: Tuple[LayerDef, ...]
    num_classes: int
    in_hw: Tuple[int, int]
    in_ch: int = 3
    a_bits: int = 8


# ------------------------------------------------------------ tracing ---

def trace_shapes(cfg: VisionConfig):
    """Per-layer (in_hwc, out_hwc); ``h == w == 0`` once the stream is flat
    (after global pooling)."""
    out = []
    stream = (*cfg.in_hw, cfg.in_ch)
    edges: Dict[str, tuple] = {}
    for L in cfg.layers:
        src = edges[L.input_from] if L.input_from else stream
        h, w, c = src
        if L.kind in ("conv", "dwconv"):
            dst = ((h + 2 * L.padding - L.fh) // L.stride + 1,
                   (w + 2 * L.padding - L.fw) // L.stride + 1,
                   L.cout if L.kind == "conv" else c)
        elif L.kind == "maxpool":
            dst = ((h - L.window) // L.stride + 1,
                   (w - L.window) // L.stride + 1, c)
        elif L.kind == "avgpool_global":
            dst = (0, 0, c)
        elif L.kind == "add":
            skip = edges[L.skip_from]
            if skip != src:
                raise ValueError(
                    f"{L.path}: add operands disagree {src} vs {skip}")
            dst = src
        elif L.kind == "linear":
            dst = (0, 0, L.cout)
        else:
            raise ValueError(f"{L.path}: unknown kind {L.kind!r}")
        if min(dst[:2]) < 0 or (dst[0] == 0) != (dst[1] == 0):
            raise ValueError(f"{L.path}: bad output geometry {dst}")
        out.append({"layer": L, "in": src, "out": dst})
        if L.save_as:
            edges[L.save_as] = dst
        if not L.branch:
            stream = dst
    return out


# --------------------------------------------------------------- init ---

def _set_path(tree: dict, path: str, node: dict):
    parts = path.split("/")
    for p in parts[:-1]:
        tree = tree.setdefault(p, {})
    tree[parts[-1]] = node


def get_path(tree: dict, path: str):
    for p in path.split("/"):
        tree = tree[p]
    return tree


def init_fp(cfg: VisionConfig, seed: int = 0, device="cuda") -> dict:
    """He-initialized fp param tree keyed by the "/"-joined layer paths,
    drawn with numpy exactly as the reference draws it."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    params: dict = {}

    def t(a):
        return torch.from_numpy(a).to(dev)

    for tr in trace_shapes(cfg):
        L, (h, w, c) = tr["layer"], tr["in"]
        if L.kind == "conv":
            fan_in = L.fh * L.fw * c
            node = {
                "w": t(rng.normal(size=(L.fh, L.fw, c, L.cout)).astype(
                    np.float32) * (2.0 / fan_in) ** 0.5),
                "bn_scale": t((rng.normal(size=(L.cout,)) * 0.05
                               + 0.4).astype(np.float32)),
                "bn_bias": t((rng.normal(size=(L.cout,)) * 0.05).astype(
                    np.float32)),
            }
        elif L.kind == "dwconv":
            node = {
                "w": t(rng.normal(size=(L.fh, L.fw, c)).astype(np.float32)
                       * (2.0 / (L.fh * L.fw)) ** 0.5),
                "bn_scale": t((rng.normal(size=(c,)) * 0.05
                               + 0.4).astype(np.float32)),
                "bn_bias": t((rng.normal(size=(c,)) * 0.05).astype(
                    np.float32)),
            }
        elif L.kind == "linear":
            node = {"w": t(rng.normal(size=(c, L.cout)).astype(np.float32)
                           / c ** 0.5)}
        else:
            continue
        _set_path(params, L.path, node)
    return params


# ----------------------------------------------------------- forwards ---

def forward_fp(cfg: VisionConfig, params: dict, x: torch.Tensor,
               edge_tap: Optional[Callable] = None) -> torch.Tensor:
    """Float forward. ``edge_tap(path, tensor)`` observes the net input
    ("__input__") and every layer output."""
    if edge_tap is not None:
        edge_tap("__input__", x)
    stream = x
    edges: Dict[str, torch.Tensor] = {}
    for L in cfg.layers:
        xin = edges[L.input_from] if L.input_from else stream
        if L.kind == "conv":
            y = vl.conv2d_fp(get_path(params, L.path), xin,
                             stride=L.stride, padding=L.padding)
        elif L.kind == "dwconv":
            y = vl.depthwise_fp(get_path(params, L.path), xin,
                                stride=L.stride, padding=L.padding)
        elif L.kind == "maxpool":
            y = vl.maxpool_fp(xin, L.window, L.stride)
        elif L.kind == "avgpool_global":
            y = vl.avgpool_global_fp(xin)
        elif L.kind == "add":
            y = xin + edges[L.skip_from]
        elif L.kind == "linear":
            y = vl.linear_fp(get_path(params, L.path), xin)
        else:
            raise ValueError(f"{L.path}: unknown kind {L.kind!r}")
        if edge_tap is not None:
            edge_tap(L.path, y)
        if L.save_as:
            edges[L.save_as] = y
        if not L.branch:
            stream = y
    return stream


def collect_absmax(cfg: VisionConfig, params: dict, batches) -> dict:
    """Per-edge running absmax over fp forwards of ``batches`` (arrays of
    (N, H, W, C) images), on the params' device."""
    dev = next(iter(_tensors(params))).device
    absmax: Dict[str, float] = {}

    def tap(path, t):
        absmax[path] = max(absmax.get(path, 0.0),
                           float(torch.max(torch.abs(t))))

    for x in batches:
        forward_fp(cfg, params, torch.as_tensor(
            np.asarray(x, np.float32)).to(dev), edge_tap=tap)
    return absmax


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)


# --------------------------------------------------------- quantizing ---

@dataclasses.dataclass(frozen=True)
class QuantizedVisionNet:
    """The deployable CNN artifact: the graph + one quantized layer per
    node + the input grid. ``eps_logits`` dequantizes the raw int32
    logits (logits_real = eps_logits * logits_hat)."""

    cfg: VisionConfig
    qlayers: Tuple[tuple, ...]          # ((LayerDef, qlayer), ...)
    input_spec: QuantSpec
    eps_logits: float
    plan: Optional[PrecisionPlan] = None

    @functools.cached_property
    def span_names(self) -> Tuple[str, ...]:
        """``vision/<path>`` of each layer, the names of `forward_int`'s
        spans (built once per net)."""
        return tuple(f"vision/{L.path}" for L, _ in self.qlayers)

    @property
    def device(self) -> torch.device:
        for L, q in self.qlayers:
            if L.kind in COMPUTE_KINDS:
                return _gemms(q)[0].w_packed.device
        raise ValueError("net has no conv or linear layer")

    def layer_bits(self) -> Dict[str, int]:
        """path -> w_bits for the plan-addressable layers; a segmented
        conv reports its widest run (the `PlanRule.w_bits` convention)."""
        return {L.path: max(g.w_bits for g in _gemms(q))
                for L, q in self.qlayers if L.kind in COMPUTE_KINDS}


def _gemms(q) -> Tuple[QuantizedLinearParams, ...]:
    """The GEMM artifacts of one compute layer: one per run of a
    segmented conv, a depthwise layer's block-diagonal GEMM."""
    if isinstance(q, vl.QSegmentedConv2D):
        return tuple(p.conv.gemm for p in q.parts)
    if isinstance(q, vl.QConv2D):
        return (q.conv.gemm,)
    return (q.gemm,)


def _to_device(tree, dev):
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    return tree


def quantize_net(cfg: VisionConfig, fp_params: dict, absmax: dict, *,
                 plan: Optional[PrecisionPlan] = None,
                 default_w_bits: int = 8,
                 device="cuda") -> QuantizedVisionNet:
    """(fp params, per-edge absmax, plan) -> integer-only deployable net
    on ``device``. Per-layer w_bits, segments and pipeline come from the
    plan's rules; a backend a rule names must be the one ``device`` runs
    (`api.check_backend`)."""
    dev = resolve_device(device)
    fp_params = _to_device(fp_params, dev)
    base = QuantConfig(mode="int", w_bits=default_w_bits, a_bits=cfg.a_bits)

    def out_spec(path):
        if path not in absmax:
            raise KeyError(
                f"no calibrated absmax for layer {path!r}; run "
                "collect_absmax over the same config")
        return QuantSpec.activation(cfg.a_bits, max(absmax[path], 1e-6))

    spec = QuantSpec.activation(cfg.a_bits, max(absmax["__input__"], 1e-6))
    input_spec = spec
    edge_specs: Dict[str, QuantSpec] = {}
    qlayers = []
    eps_logits = 1.0
    for tr in trace_shapes(cfg):
        L = tr["layer"]
        spec_x = edge_specs[L.input_from] if L.input_from else spec
        qcfg = resolve_qcfg(plan, L.path, base)
        if L.kind in COMPUTE_KINDS:
            check_backend(qcfg.backend, dev)
        if L.kind == "conv":
            spec_y = out_spec(L.path)
            if qcfg.segments is not None:
                q = vl.quantize_conv_layer_segmented(
                    get_path(fp_params, L.path), spec_x, spec_y,
                    qcfg.segments, stride=L.stride, padding=L.padding,
                    pipeline=qcfg.pipeline)
            else:
                q = vl.quantize_conv_layer(
                    get_path(fp_params, L.path), spec_x, spec_y,
                    qcfg.w_bits, stride=L.stride, padding=L.padding,
                    pipeline=qcfg.pipeline)
        elif L.kind == "dwconv":
            if qcfg.segments is not None:
                raise NotImplementedError(
                    f"{L.path}: segmented plans are not supported on "
                    "depthwise layers (per-channel grids make channel-"
                    "group demotion a per-layer width change; plan with "
                    "granularity='layer' for depthwise nets)")
            spec_y = out_spec(L.path)
            q = vl.quantize_depthwise(
                get_path(fp_params, L.path), spec_x, spec_y, qcfg.w_bits,
                stride=L.stride, padding=L.padding, pipeline=qcfg.pipeline)
        elif L.kind == "maxpool":
            spec_y = spec_x                      # grid-preserving
            q = vl.QMaxPool2D(window=L.window, stride=L.stride)
        elif L.kind == "avgpool_global":
            spec_y = out_spec(L.path)
            h, w, _ = tr["in"]
            m, d = vl.fold_avgpool_requant(h * w, spec_x.eps, spec_y.eps)
            q = vl.QAvgPool2D(window=0, stride=1, m=m, d=d,
                              out_bits=cfg.a_bits)
        elif L.kind == "add":
            spec_b = edge_specs[L.skip_from]
            spec_y = out_spec(L.path)
            m1, m2, d = vl.fold_add_requant(spec_x.eps, spec_b.eps,
                                            spec_y.eps)
            q = vl.QResidualAdd(m1=m1, m2=m2, d=d, out_bits=cfg.a_bits)
        else:  # linear
            if qcfg.segments is not None:
                raise NotImplementedError(
                    f"{L.path}: segmented plans are not supported on the "
                    "classifier head (d_out = num_classes < CHUNK, so "
                    "the planner never splits it)")
            q, eps_logits = vl.quantize_linear_head(
                get_path(fp_params, L.path), spec_x, qcfg.w_bits,
                pipeline=qcfg.pipeline)
            spec_y = spec_x                      # raw logits: no new grid
        qlayers.append((L, q))
        if L.save_as:
            edge_specs[L.save_as] = spec_y
        if not L.branch:
            spec = spec_y
    return QuantizedVisionNet(cfg=cfg, qlayers=tuple(qlayers),
                              input_spec=input_spec, eps_logits=eps_logits,
                              plan=plan)


def quantize(x: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """Real images -> integer images on the input grid ``spec``
    (`core.quantize.quantize`), inside a ``vision/quantize`` span."""
    with obs.span("vision/quantize"):
        return _quantize(x, spec)


def quantize_input(qnet: QuantizedVisionNet, x) -> torch.Tensor:
    """Real images (N, H, W, C) -> uint{a_bits} integer images on the
    net's device."""
    x = torch.as_tensor(np.asarray(x, np.float32)).to(qnet.device)
    return quantize(x, qnet.input_spec)


def forward_int(qnet: QuantizedVisionNet, x_hat: torch.Tensor, *,
                pipeline: Optional[str] = None, lowering: str = "auto",
                mesh=None, collect: Optional[Callable] = None
                ) -> torch.Tensor:
    """Integer-only forward: uint{a_bits} images in, int32 logits out, on
    the images' device (kernels on CUDA, plain versions on the CPU).
    ``pipeline`` forces one pipeline net-wide, ``lowering`` one depthwise
    lowering (`QDepthwiseConv2D.apply`). ``mesh`` runs every conv and
    linear on the cluster path (`api.qconv_sharded` / `qdot_sharded`:
    images data-parallel, output channels tensor-parallel, equal to the
    meshless forward); the pools and adds run on the gathered edges.
    ``collect(path, y_hat)`` observes every integer edge. Each layer runs
    inside its ``vision/<path>`` span."""
    stream = x_hat
    edges: Dict[str, torch.Tensor] = {}
    for (L, q), name in zip(qnet.qlayers, qnet.span_names):
        with obs.span(name, kind=L.kind, path=L.path):
            xin = edges[L.input_from] if L.input_from else stream
            if L.kind == "dwconv":
                y = q.apply(xin, pipeline=pipeline, lowering=lowering,
                            mesh=mesh)
            elif L.kind in COMPUTE_KINDS:
                y = q.apply(xin, pipeline=pipeline, mesh=mesh)
            elif L.kind == "add":
                y = q.apply(xin, edges[L.skip_from])
            else:
                y = q.apply(xin)
            if collect is not None:
                collect(L.path, y)
            if L.save_as:
                edges[L.save_as] = y
            if not L.branch:
                stream = y
    return stream


def shard_net(qnet: QuantizedVisionNet, mesh) -> QuantizedVisionNet:
    """``qnet`` with every compute layer's packed weights and epilogue
    vectors placed on ``mesh`` once (`shard_packed_conv` /
    `shard_packed_linear`), so a mesh forward reads them as they are. A
    depthwise layer's per-channel convs stay as they are: they never run
    on a mesh."""
    def one(q):
        if isinstance(q, vl.QSegmentedConv2D):
            return dataclasses.replace(q, parts=tuple(one(p)
                                                      for p in q.parts))
        if isinstance(q, vl.QConv2D):
            return dataclasses.replace(
                q, conv=shard_packed_conv(q.conv, mesh))
        return dataclasses.replace(
            q, gemm=shard_packed_linear(q.gemm, mesh))

    return dataclasses.replace(qnet, qlayers=tuple(
        (L, one(q) if L.kind in COMPUTE_KINDS else q)
        for L, q in qnet.qlayers))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def streamed_weight_bytes(qnet: QuantizedVisionNet) -> int:
    """Bytes of the weight-side arrays of the GEMM route: per compute
    layer (per run of a segmented conv), the packed weights plus the
    epilogue vectors. A depthwise layer counts its block-diagonal GEMM
    only, not its per-channel convs."""
    return sum(_nbytes(a) for L, q in qnet.qlayers
               if L.kind in COMPUTE_KINDS for g in _gemms(q)
               for a in (g.w_packed, g.kappa, g.lam, g.m))


def vision_artifact_bytes(qnet: QuantizedVisionNet) -> int:
    """Total bytes of the arrays in the deployable net (both conv weight
    layouts count, and both depthwise lowerings)."""
    seen = set()

    def walk(obj) -> int:
        if isinstance(obj, torch.Tensor):
            if id(obj) in seen:
                return 0
            seen.add(id(obj))
            return _nbytes(obj)
        if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            return sum(walk(getattr(obj, f.name))
                       for f in dataclasses.fields(obj))
        if isinstance(obj, (tuple, list)):
            return sum(walk(v) for v in obj)
        return 0

    return sum(walk(q) for _, q in qnet.qlayers)
