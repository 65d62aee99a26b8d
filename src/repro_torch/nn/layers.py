"""Core layers: the quantization-aware dense layer, embeddings, norms,
RoPE.

The dense layer is where the paper's technique enters every LM
projection: `QuantConfig` selects float ('off'), fake-quant ('fake', the
QAT forward) or integer deployment ('int'), which holds chunk-planar
packed sub-byte weights and runs the packed GEMM with a per-channel
dequant epilogue (`repro_torch.kernels.api.int_gemm`: the Hopper kernel
on CUDA tensors, its plain version on CPU tensors). Under a ``segments``
plan the flat segmented container runs the mixed-operand GEMM, all runs
in one launch.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Callable, Optional

import torch

from repro_torch.core import packing
from repro_torch.core.packing import SegmentMap
from repro_torch.core.quantize import QuantSpec, fake_quantize
from repro_torch.kernels.common import check_pipeline
from repro_torch.nn.module import ParamDef
from repro_torch.parallel import tp


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    mode: str = "off"        # off | fake | int
    w_bits: int = 8
    a_bits: int = 8
    # static activation absmax in int mode (None: dynamic per tensor)
    a_absmax: Optional[float] = 4.0
    # backend a plan names ('cuda' | 'torch', checked against the device
    # the net is placed on); None: whatever the device runs
    backend: Optional[str] = None
    # kernel pipeline ('off' | 'double_buffer'); None resolves at run time
    pipeline: Optional[str] = None
    # fine-grain (n_start, n_end, w_bits) output-channel runs, validated
    # through `SegmentMap`; None means uniform w_bits
    segments: Optional[tuple] = None

    def __post_init__(self):
        if self.pipeline is not None:
            check_pipeline(self.pipeline)
        if self.segments is not None:
            object.__setattr__(self, "segments", SegmentMap(
                tuple(tuple(r) for r in self.segments)).runs)

    @property
    def enabled(self):
        return self.mode != "off"


QOFF = QuantConfig()


# Calibration tap: when set, dense_apply calls it with (params, x) before
# the matmul (host-side inspection passes, e.g. checking every dense call
# of a decode step against the plain version).
_DENSE_TAP: Optional[Callable] = None


@contextlib.contextmanager
def dense_tap(fn: Callable):
    """Install ``fn(params_dict, x)`` as the dense-apply observer."""
    global _DENSE_TAP
    prev = _DENSE_TAP
    _DENSE_TAP = fn
    try:
        yield
    finally:
        _DENSE_TAP = prev


# ---------------------------------------------------------------- dense ---

def dense_def(d_in: int, d_out: int, axes=("embed", "mlp"), *,
              bias: bool = False, qcfg: QuantConfig = QOFF,
              dtype=torch.float32, scale: float = 1.0):
    if qcfg.mode == "int" and qcfg.segments is not None:
        segmap = SegmentMap(qcfg.segments)
        if segmap.n != d_out:
            raise ValueError(
                f"segment map covers N={segmap.n} but d_out={d_out}")
        # flat segmented container (panel-major, exact bytes)
        p = {"w_packed": ParamDef((segmap.packed_bytes(d_in),), (None,),
                                  "zeros", torch.int8),
             "w_scale": ParamDef((d_out,), (axes[1],), "ones",
                                 torch.float32)}
    elif qcfg.mode == "int":
        kp = packing.padded_size(d_in) // packing.pack_factor(qcfg.w_bits)
        p = {"w_packed": ParamDef((kp, d_out), (axes[0], axes[1]),
                                  "zeros", torch.int8),
             "w_scale": ParamDef((d_out,), (axes[1],), "ones",
                                 torch.float32)}
    else:
        p = {"w": ParamDef((d_in, d_out), axes, "normal", dtype, scale)}
    if bias:
        p["b"] = ParamDef((d_out,), (axes[1],), "zeros", dtype)
    return p


class RowSlice(dict):
    """The local params of a row-parallel dense on one model position:
    its K-slice of the weight (`repro_torch.parallel.tp`). `dense_apply`
    on it returns the partial product before any epilogue: the int32
    accumulators of the packed GEMM (the ``raw`` epilogue), or a float32
    product; `dense_finish` turns the sum of the partials into the
    output. ``k_full``: the whole K (a fake-quant weight grid reads
    it)."""

    def __init__(self, p, k_full: int):
        super().__init__(p)
        self.k_full = k_full


def dense_apply(p, x, *, qcfg: QuantConfig = QOFF):
    """x: (..., d_in) bf16/f32 -> (..., d_out) in x's dtype; on a
    `RowSlice`, the partial product (its docstring)."""
    if _DENSE_TAP is not None:
        _DENSE_TAP(p, x)
    partial = isinstance(p, RowSlice)
    if qcfg.mode == "int":
        if partial:
            return _int_matmul(p, x, qcfg, epilogue="raw")
        return _bias(p, _int_matmul(p, x, qcfg))
    if qcfg.mode == "fake":
        w = p["w"]
        k = p.k_full if partial else w.shape[0]
        sw = QuantSpec.weight(qcfg.w_bits, 3.0 / (k ** 0.5))
        sa = QuantSpec(qcfg.a_bits, True, -qcfg.a_absmax, qcfg.a_absmax)
        a, w = fake_quantize(x, sa).to(x.dtype), fake_quantize(w, sw)
    else:
        a, w = x, p["w"]
    if partial:   # operands in x's dtype, as whole; the product float32
        return torch.matmul(a.to(torch.float32),
                            w.to(x.dtype).to(torch.float32))
    return _bias(p, torch.matmul(a, w.to(x.dtype)))


def _bias(p, y):
    return y + p["b"].to(y.dtype) if "b" in p else y


def dense_finish(p, acc, *, qcfg: QuantConfig, out_dtype):
    """The output of a row-parallel dense from the sum ``acc`` of its
    partial products: int32 accumulators dequantized once with the
    whole dense's scale (the meshless epilogue's float32 product, then
    one round-to-nearest-even cast), or the float32 sum cast; then the
    bias."""
    if qcfg.mode == "int":
        acc = (acc.to(torch.float32) * dequant_scale(p, qcfg, acc.device)
               ).to(out_dtype)
    return _bias(p, acc.to(out_dtype))


def quantize_activations(x, qcfg: QuantConfig) -> torch.Tensor:
    """x (..., K) -> int8 codes (..., K_pad) on the signed a_bits grid of
    static scale absmax / a_max (A8 caps at ±127), K zero-padded to
    CHUNK: the int dense layer's input (`_int_matmul`)."""
    absmax = qcfg.a_absmax or 4.0
    a_max = packing.int_range(qcfg.a_bits, True)[1]  # A8 caps at 127
    a_scale = const(absmax / a_max, torch.float32, x.device)
    x_q = torch.clamp(torch.round(x.to(torch.float32) / a_scale), -a_max,
                      a_max).to(torch.int8)
    return packing.pad_to_chunk(x_q, axis=-1)


# ------------------------------------------- dense over the model axis ---

def dense_cuts(qcfg: QuantConfig, kind: str, runs, k_full: int):
    """The `Cut`s of a dense's leaves on the model axis: ``kind`` 'col'
    splits N (weight columns, the per-channel scale, the bias), 'row'
    splits K (weight rows; a packed container at CHUNK-aligned runs);
    a segmented container stays whole (None)."""
    if qcfg.mode == "int" and qcfg.segments is not None:
        return None
    if kind == "col":
        c = tp.Cut(-1, runs)
        return {"w": c, "w_packed": c, "w_scale": c, "b": c}
    return {"w": tp.Cut(-2, runs),
            "w_packed": tp.Cut(-2, runs, packed=True, logical=k_full)}


def dense_is_split(p) -> bool:
    return isinstance(p.get("w_packed", p.get("w")), tp.Split)


def row_parallel_ok(qcfg: QuantConfig, runs, k_full: int) -> bool:
    """Whether a dense can split K at ``runs``: a float weight anywhere,
    a uniform packed one at CHUNK boundaries (or K's end); a segmented
    container never splits, so it always can (it runs whole)."""
    if qcfg.mode != "int" or qcfg.segments is not None:
        return True
    c = packing.CHUNK
    return all(s % c == 0 and (e % c == 0 or e == k_full)
               for r in runs for s, e in r)


def dense_col(p, x, *, qcfg: QuantConfig, runs, group, k_full: int):
    """Column-parallel dense: position i computes its ``runs[i]`` output
    columns of replicated ``x`` (the dequant epilogue on its N-slice);
    returns the per-position outputs (None where a run is empty). A
    dense that is not split (a segmented container) runs once on the
    leader and its output is cut to the runs."""
    p = tp.place(p, dense_cuts(qcfg, "col", runs, k_full), group)
    if not dense_is_split(p):
        return tp.split(dense_apply(p, x, qcfg=qcfg), runs, -1)
    live = [i for i, r in enumerate(runs) if r]
    outs = group.run(
        lambda i, xi: dense_apply(tp.local(p, i, group.devices[i]), xi,
                                  qcfg=qcfg),
        [(group.to(x, i),) for i in live], live)
    res = [None] * group.m
    for i, o in zip(live, outs):
        res[i] = o
    return res


def dense_row(p, xs, *, qcfg: QuantConfig, runs, group, k_full: int):
    """Row-parallel dense: position i contracts its K-slice ``xs[i]``
    (``runs[i]`` of K) into a partial product (`RowSlice`), the partials
    are summed on the leader (exactly, for int32 accumulators) and
    finished once (`dense_finish`). A dense that is not split runs once
    on the leader over the joined input."""
    p = tp.place(p, dense_cuts(qcfg, "row", runs, k_full), group)
    live = [i for i, r in enumerate(runs) if r]
    dtype = xs[live[0]].dtype
    if not dense_is_split(p):
        x = tp.join(xs, runs, -1, k_full, group.leader)
        return dense_apply(p, x, qcfg=qcfg)
    accs = group.run(
        lambda i, xi: dense_apply(RowSlice(tp.local(p, i, group.devices[i]),
                                           k_full), xi, qcfg=qcfg),
        [(group.to(xs[i], i),) for i in live], live)
    return dense_finish(p, tp.total(accs, group.leader), qcfg=qcfg,
                        out_dtype=dtype)


@functools.lru_cache(maxsize=256)
def const(v: float, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A 0-dim constant on ``device``, made once and never written: built
    per call, each would be a host-to-device copy that waits for the
    stream."""
    return torch.tensor(v, dtype=dtype, device=device)


@functools.lru_cache(maxsize=64)
def _rounded(v: float, dtype: torch.dtype) -> float:
    """``v`` rounded to ``dtype`` (held exactly by a Python float)."""
    return float(torch.tensor(v, dtype=dtype))


def dequant_scale(p, qcfg: QuantConfig, device):
    """w_scale x a_scale in float32, a_scale first rounded to w_scale's
    dtype (`_int_matmul`)."""
    a_max = packing.int_range(qcfg.a_bits, True)[1]
    absmax = qcfg.a_absmax or 4.0
    return p["w_scale"].to(torch.float32) * const(
        _rounded(absmax / a_max, p["w_scale"].dtype), torch.float32,
        device)


def _int_matmul(p, x, qcfg: QuantConfig, epilogue: str = "dequant"):
    """W{8,4,2}A{8,4,2} integer GEMM with the per-channel dequant
    epilogue, written in x's dtype.

    Activations are quantized onto the signed a_bits grid (A8 caps at
    ±127) with the static scale absmax / a_max; the divisor is a float32
    tensor on x's device (a Python-scalar divisor would let CUDA multiply
    by its reciprocal and move codes that land on .5). The dequant scale
    is w_scale x a_scale in float32, with a_scale first rounded to
    w_scale's dtype: the reference's compiled rounding (a bfloat16 tree's
    w_scale meets a_scale as bfloat16, and XLA drops the product's round
    trip through bfloat16). A segmented container runs the mixed-operand GEMM in one launch, equal
    to the reference's per-run concatenation. ``epilogue='raw'`` returns
    the int32 accumulators (a row-parallel K-slice, `RowSlice`).
    """
    from repro_torch.core.quantize import SegmentedLinearParams
    from repro_torch.kernels.api import int_gemm

    k_logical = x.shape[-1]
    x_q = quantize_activations(x, qcfg)
    scale = (dequant_scale(p, qcfg, x.device) if epilogue == "dequant"
             else 1.0)
    if qcfg.segments is not None:
        w = SegmentedLinearParams(
            w_flat=p["w_packed"], segmap=SegmentMap(qcfg.segments),
            a_bits=qcfg.a_bits, a_signed=True, kappa=None, lam=None, m=None,
            d=0, out_bits=8, k_logical=k_logical)
        return int_gemm(x_q, w, a_bits=qcfg.a_bits, scale=scale,
                        out_dtype=x.dtype, pipeline=qcfg.pipeline)
    return int_gemm(x_q, p["w_packed"], a_bits=qcfg.a_bits,
                    w_bits=qcfg.w_bits, scale=scale, out_dtype=x.dtype,
                    pipeline=qcfg.pipeline, k_logical=k_logical,
                    epilogue=epilogue)


def quantize_dense_weights(w, w_bits: int):
    """fp weights (..., K, N) -> (w_hat int8 in-range, w_scale (..., N))
    on per-output-channel symmetric grids. Leading dims (a stacked layer
    axis) broadcast, so the whole stack is range-checked before packing.
    Divisors are tensors, so the card gives the CPU's codes."""
    red = w.ndim - 2  # K axis
    absmax = torch.maximum(w.abs().amax(dim=red),
                           torch.tensor(1e-8, dtype=w.dtype,
                                        device=w.device))
    int_max = packing.int_range(w_bits, True)[1]
    w_scale = absmax / torch.tensor(int_max, dtype=w.dtype, device=w.device)
    w_hat = torch.clamp(torch.round(w / w_scale.unsqueeze(red)), -int_max,
                        int_max).to(torch.int8)
    return w_hat, w_scale


def pack_dense_weights(w, w_bits: int, *, assert_range: bool = False):
    """fp weights (K,N) or stacked (L,K,N) -> (w_packed, w_scale) for
    int-mode params. ``assert_range`` arms the truncation guard."""
    w_hat, w_scale = quantize_dense_weights(w, w_bits)
    red = w.ndim - 2
    w_hat = packing.pad_to_chunk(w_hat, axis=red)
    return packing.pack(w_hat, w_bits, axis=red,
                        assert_range=assert_range), w_scale


def pack_dense_weights_segmented(w, segments, *, assert_range: bool = False):
    """fp weights (K,N) or stacked (L,K,N) -> (w_flat, w_scale) at
    per-run widths: each output-channel run quantizes on its own
    per-channel symmetric grid at its own w_bits, then the runs pack into
    one flat segmented container (`packing.pack_segmented`). w_scale
    spans the full N."""
    segmap = (segments if isinstance(segments, SegmentMap)
              else SegmentMap(tuple(tuple(r) for r in segments)))
    if w.shape[-1] != segmap.n:
        raise ValueError(
            f"segment map covers N={segmap.n} but weights have "
            f"d_out={w.shape[-1]}")
    hats, scales = [], []
    for s, e, b in segmap.runs:
        h, sc = quantize_dense_weights(w[..., s:e], b)
        hats.append(h)
        scales.append(sc)
    w_hat = torch.cat(hats, dim=-1)
    w_scale = torch.cat(scales, dim=-1)
    return packing.pack_segmented(w_hat, segmap,
                                  assert_range=assert_range), w_scale


# ------------------------------------------------------------ embedding ---

VOCAB_PAD = 256  # vocab rows padded to a multiple of this


def padded_vocab(vocab: int) -> int:
    return vocab + (-vocab) % VOCAB_PAD


def embedding_def(vocab: int, d: int, dtype=torch.float32):
    return {"table": ParamDef((padded_vocab(vocab), d), ("vocab", "embed"),
                              "embed", dtype, scale=1.0)}


def vocab_runs(vocab_pad: int, m: int):
    """The table rows / head columns of each model position."""
    return tp.even_runs(vocab_pad, m, VOCAB_PAD)


def embedding_cuts(p, m: int):
    """The table split over the vocab rows (None once placed)."""
    t = p["table"]
    return ({"table": tp.Cut(-2, vocab_runs(t.shape[-2], m))}
            if torch.is_tensor(t) else None)


def embedding_apply(p, ids):
    grp = tp.tp_group()
    if grp is None:
        return p["table"][ids.long()]
    # vocab-parallel: each position looks up the ids in its rows, the
    # others read zero; the sum adds exact zeros
    p = tp.place(p, embedding_cuts(p, grp.m), grp)
    ids = ids.long()
    runs = p["table"].cut.runs

    def one(i, ids_i):
        (s, e), = runs[i]
        t = p["table"].parts[i]
        hit = (ids_i >= s) & (ids_i < e)
        rows = t[torch.clamp(ids_i - s, 0, e - s - 1)]
        return rows * hit[..., None].to(rows.dtype)

    live = [i for i, r in enumerate(runs) if r]
    return tp.total(grp.run(one, [(grp.to(ids, i),) for i in live], live),
                    grp.leader)


def embedding_logits(p, x, vocab: int = 0):
    """Tied output head: (..., d) @ (vocab_pad, d)^T. Padded rows are
    masked to -1e9 so the softmax ignores them. Under tensor
    parallelism each position computes its table rows' logits, gathered
    on the leader."""
    grp = tp.tp_group()
    if grp is None:
        lg = torch.matmul(x, p["table"].to(x.dtype).T)
        vp = p["table"].shape[0]
    else:
        p = tp.place(p, embedding_cuts(p, grp.m), grp)
        runs = p["table"].cut.runs
        vp = sum(tp.run_len(r) for r in runs)
        live = [i for i, r in enumerate(runs) if r]
        parts = [None] * grp.m
        for i, o in zip(live, grp.run(
                lambda i, xi: torch.matmul(
                    xi, p["table"].parts[i].to(xi.dtype).T),
                [(grp.to(x, i),) for i in live], live)):
            parts[i] = o
        lg = tp.join(parts, runs, -1, vp, grp.leader)
    return mask_vocab(lg, vp, vocab)


def mask_vocab(lg, vp: int, vocab: int):
    if vocab and vp != vocab:
        mask = torch.arange(vp, device=lg.device) < vocab
        lg = torch.where(mask, lg, -1e9)      # -1e9 in lg's dtype
    return lg


# ---------------------------------------------------------------- norms ---

def norm_def(d: int, kind: str = "rmsnorm", dtype=torch.float32):
    if kind == "nonparam_ln":   # OLMo: non-parametric LayerNorm
        return {}
    if kind == "layernorm":
        return {"scale": ParamDef((d,), ("embed",), "ones", dtype),
                "bias": ParamDef((d,), ("embed",), "zeros", dtype)}
    # rmsnorm / gemma_rmsnorm ((1+scale) form)
    return {"scale": ParamDef((d,), ("embed",),
                              "zeros" if kind == "gemma_rmsnorm" else "ones",
                              dtype)}


def norm_apply(p, x, kind: str = "rmsnorm", eps: float = 1e-6):
    xf = x.to(torch.float32)
    if kind in ("layernorm", "nonparam_ln"):
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps)
        if kind == "layernorm":
            y = y * p["scale"].to(torch.float32) + p["bias"].to(
                torch.float32)
        return y.to(x.dtype)
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps)
    scale = p["scale"].to(torch.float32)
    if kind == "gemma_rmsnorm":
        scale = 1.0 + scale
    return (y * scale).to(x.dtype)


# ----------------------------------------------------------------- rope ---

@dataclasses.dataclass(frozen=True)
class Yarn:
    """YaRN rope scaling (arXiv:2309.00071) with the keys of a
    ``rope_scaling`` of type ``yarn``, as DeepSeek-V3's public
    ``modeling_deepseek.py`` computes it: pairs rotating fewer than
    ``beta_slow`` times over ``original_max_position`` positions are
    interpolated by ``factor``, pairs rotating more than ``beta_fast``
    times keep their frequency, a linear ramp between; cos / sin scale
    by mscale(factor, mscale) / mscale(factor, mscale_all_dim)."""
    factor: float
    original_max_position: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0

    def attention_factor(self) -> float:
        return (yarn_mscale(self.factor, self.mscale)
                / yarn_mscale(self.factor, self.mscale_all_dim))


def yarn_mscale(factor: float, mscale: float = 1.0) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_correction_range(yarn: Yarn, dim: int, theta: float):
    """(low, high) rope pairs of the ramp (``yarn_find_correction_range``)."""
    def pair(rotations):
        return (dim * math.log(yarn.original_max_position
                               / (rotations * 2 * math.pi))
                / (2 * math.log(theta)))
    return (max(math.floor(pair(yarn.beta_fast)), 0),
            min(math.ceil(pair(yarn.beta_slow)), dim - 1))


@functools.lru_cache(maxsize=64)
def _freqs(theta: float, half: int, device: torch.device,
           yarn: Optional[Yarn] = None) -> torch.Tensor:
    """theta ** (-i / half) in float32, made once per (theta, half,
    device, yarn); under ``yarn`` the pairs past the ramp divided by its
    factor."""
    base = torch.pow(torch.tensor(theta, dtype=torch.float32, device=device),
                     -torch.arange(0, half, dtype=torch.float32,
                                   device=device) / half)
    if yarn is None:
        return base
    lo, hi = yarn_correction_range(yarn, 2 * half, theta)
    if lo == hi:
        hi += 0.001
    ramp = torch.clamp((torch.arange(half, dtype=torch.float32,
                                     device=device) - lo) / (hi - lo), 0, 1)
    keep = 1.0 - ramp
    return base / yarn.factor * (1 - keep) + base * keep


def _scaled(t, yarn: Optional[Yarn]):
    """cos / sin times YaRN's attention factor (none when it is 1)."""
    f = 1.0 if yarn is None else yarn.attention_factor()
    return t if f == 1.0 else t * f


def rope_tables(seq_len: int, head_dim: int, theta: float = 10000.0,
                dtype=torch.float32, device="cpu",
                yarn: Optional[Yarn] = None):
    freqs = _freqs(float(theta), head_dim // 2, torch.device(device), yarn)
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    ang = torch.outer(t, freqs)            # (S, half)
    return (_scaled(torch.cos(ang), yarn).to(dtype),
            _scaled(torch.sin(ang), yarn).to(dtype))


def _rotate(x, c, s):
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def rope_apply(x, cos, sin):
    """x: (..., S, H, Dh); tables (S, Dh/2) broadcast over heads."""
    return _rotate(x, cos[:, None, :], sin[:, None, :])


def rope_apply_at(x, cos, sin, positions):
    """Decode-time RoPE: positions (B,) index the tables."""
    positions = positions.long()
    return _rotate(x, cos[positions][:, None, None, :],
                   sin[positions][:, None, None, :])


def rope_single(x, position, theta, yarn: Optional[Yarn] = None):
    """Table-free decode RoPE: x (B,1,H,Dh); position a scalar (wave
    decode: every row at the same step) or a (B,) vector (each slot at its
    own position). The per-element math is the same in both forms, so an
    all-equal vector gives the scalar's result bit for bit, and the
    tables' at that position."""
    half = x.shape[-1] // 2
    freqs = _freqs(float(theta), half, x.device, yarn)
    if not torch.is_tensor(position) or position.dim() == 0:
        # float32(position) * freqs, with no tensor made from the host
        ang = freqs * float(position)                          # (half,)
        c = _scaled(torch.cos(ang), yarn).to(x.dtype)[None, None, None, :]
        s = _scaled(torch.sin(ang), yarn).to(x.dtype)[None, None, None, :]
    else:
        ang = position.to(torch.float32)[:, None] * freqs      # (B, half)
        c = _scaled(torch.cos(ang), yarn).to(x.dtype)[:, None, None, :]
        s = _scaled(torch.sin(ang), yarn).to(x.dtype)[:, None, None, :]
    return _rotate(x, c, s)
