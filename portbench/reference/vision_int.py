"""Plain reference of the integer CNN that a vision configuration runs.

From the float weights, the calibration batches and the images that the
benchmark makes, it works out everything the deployed net needs on its
own: each edge's activation range from a float forward, each layer's
weight grid and integer codes, the integer batch-norm and requant fold
(kappa, lambda, m, d), the pooling and residual-add folds; then the
integer forward (paper eqs. 1-4): unsigned a_bits images at every edge,
exact integer convolutions (im2col products in float64, exact for these
integers), the int32 wrap of kappa * acc + lambda, the floor of the
requant shift, and raw int32 logits from the linear head.

It imports neither the port nor the JAX package: the folds below are
the paper's arithmetic written out again, so that nothing the program
computes reaches the reference.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from portbench.harness import work

M_BITS = 15
D_MIN, D_MAX = 16, 31


def umax(bits: int) -> int:
    """Largest unsigned activation code; 8-bit codes cap at 127 (int8
    containers)."""
    return 127 if bits == 8 else (1 << bits) - 1


def smax(bits: int) -> int:
    """Largest signed weight code on the symmetric grid."""
    return (1 << (bits - 1)) - 1


# -------------------------------------------------------------- folds ---

def pick_requant_md(ratio: float, d_min: int = D_MIN):
    ratio = float(ratio)
    if ratio <= 0:
        raise ValueError("invalid quanta")
    d = min(D_MAX, int(np.floor(np.log2((1 << M_BITS) - 1) - np.log2(ratio))))
    if d < d_min:
        raise ValueError(f"requant ratio {ratio} too large (d={d})")
    return int(np.round(ratio * (1 << d))), d


def fold_bn(eps_w, eps_x, eps_y, bn_scale, bn_bias, kappa_bits=8):
    s = bn_scale.detach().cpu().numpy().astype(np.float64)
    b = bn_bias.detach().cpu().numpy().astype(np.float64)
    eps_phi = float(eps_w) * float(eps_x)
    eps_kappa = max(np.abs(s).max(), 1e-12) / ((1 << (kappa_bits - 1)) - 1)
    kappa = np.round(s / eps_kappa).astype(np.int64)
    lam = np.round(b / (eps_phi * eps_kappa)).astype(np.int64)
    m, d = pick_requant_md(eps_phi * eps_kappa / float(eps_y))
    return kappa, lam, m, d


def wrap32(v: torch.Tensor) -> torch.Tensor:
    return ((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def shift_floor(phi: torch.Tensor, m, d: int) -> torch.Tensor:
    """floor(m * phi / 2^d) with int32 products, split hi/lo at 16 bits
    (the 32-bit MAC's requant)."""
    phi = phi.to(torch.int64)
    m = torch.as_tensor(m, device=phi.device).to(torch.int64)
    hi, lo = phi >> 16, phi & 0xFFFF
    a = wrap32(wrap32(m * hi) + (wrap32(m * lo) >> 16))
    return a >> (d - 16)


def to_grid(t: torch.Tensor, eps: float, lo: int, hi: int) -> torch.Tensor:
    """round(t / eps) clipped to [lo, hi]; the step is a float32 tensor
    (a true division, not a product with its reciprocal)."""
    e = torch.tensor(eps, dtype=torch.float32, device=t.device)
    return torch.clamp(torch.round(t.to(torch.float32) / e), lo, hi)


# ------------------------------------------------------ float forward ---

def _get(tree, path):
    for p in path.split("/"):
        tree = tree[p]
    return tree


def float_forward(cfg: dict, fp: dict, x: torch.Tensor, tap=None):
    """Float forward (conv + BN + ReLU, mean pooling, add, linear head)
    over NHWC images; ``tap(path, y)`` sees the input and every edge."""
    if tap:
        tap("__input__", x)
    stream, edges = x, {}
    for L in cfg["layers"]:
        xin = edges[L["input_from"]] if L.get("input_from") else stream
        k = L["kind"]
        if k == "conv":
            p = _get(fp, L["path"])
            y = F.conv2d(xin.permute(0, 3, 1, 2), p["w"].permute(3, 2, 0, 1),
                         stride=L.get("stride", 1),
                         padding=L.get("padding", 1)).permute(0, 2, 3, 1)
            y = torch.clamp_min(y * p["bn_scale"] + p["bn_bias"], 0.0)
        elif k == "avgpool_global":
            y = torch.mean(xin, dim=(1, 2))
        elif k == "add":
            y = xin + edges[L["skip_from"]]
        elif k == "linear":
            y = xin @ _get(fp, L["path"])["w"]
        else:
            raise ValueError(f"{L['path']}: the reference has no {k!r}")
        if tap:
            tap(L["path"], y)
        if L.get("save_as"):
            edges[L["save_as"]] = y
        if not L.get("branch", False):
            stream = y
    return stream


def absmax(cfg: dict, fp: dict, calib: List[torch.Tensor]) -> Dict[str, float]:
    out: Dict[str, float] = {}

    def tap(path, t):
        out[path] = max(out.get(path, 0.0), float(torch.max(torch.abs(t))))

    for x in calib:
        float_forward(cfg, fp, x, tap)
    return out


# ------------------------------------------------------- the integers ---

def derive(cfg: dict, fp: dict, calib: List[torch.Tensor], a_bits: int,
           w_bits: int) -> dict:
    """Every integer the deployed net needs, from the float inputs."""
    amax = absmax(cfg, fp, calib)
    amax_act = umax(a_bits)

    def eps_act(path):
        return max(amax[path], 1e-6) / amax_act

    eps_in = eps_act("__input__")
    eps, edge_eps, layers = eps_in, {}, []
    for tr in work.vision_layers(cfg):
        L, (h, w, _c) = tr["layer"], tr["in"]
        e_x = edge_eps[L["input_from"]] if L.get("input_from") else eps
        k = L["kind"]
        q = {"L": L}
        if k in ("conv", "linear"):
            wt = _get(fp, L["path"])["w"]
            e_w = max(float(torch.max(torch.abs(wt))), 1e-8) / smax(w_bits)
            q["w"] = to_grid(wt, e_w, -smax(w_bits), smax(w_bits))
        if k == "conv":
            e_y = eps_act(L["path"])
            p = _get(fp, L["path"])
            q["kappa"], q["lam"], q["m"], q["d"] = fold_bn(
                e_w, e_x, e_y, p["bn_scale"], p["bn_bias"])
        elif k == "avgpool_global":
            e_y = eps_act(L["path"])
            q["m"], q["d"] = pick_requant_md(e_x / (e_y * h * w))
        elif k == "add":
            e_y = eps_act(L["path"])
            r1, r2 = e_x / e_y, edge_eps[L["skip_from"]] / e_y
            _, d = pick_requant_md(max(r1, r2), d_min=0)
            q["m1"], q["m2"], q["d"] = (int(np.round(r1 * (1 << d))),
                                        int(np.round(r2 * (1 << d))), d)
        elif k == "linear":         # raw int32 logits
            e_y = e_x
        else:
            raise ValueError(f"{L['path']}: the reference has no {k!r}")
        layers.append(q)
        if L.get("save_as"):
            edge_eps[L["save_as"]] = e_y
        if not L.get("branch", False):
            eps = e_y
    return {"eps_in": eps_in, "a_bits": a_bits, "layers": layers}


def _conv_acc(x: torch.Tensor, w: torch.Tensor, stride: int, padding: int):
    """Exact integer convolution: NHWC codes x (fh, fw, cin, cout) codes ->
    int64 accumulators, as im2col products in float64."""
    n, h, wd, c = x.shape
    fh, fw, _, co = w.shape
    cols = F.unfold(x.permute(0, 3, 1, 2).to(torch.float64), (fh, fw),
                    padding=padding, stride=stride)       # (n, c*fh*fw, L)
    wm = w.permute(2, 0, 1, 3).reshape(c * fh * fw, co).to(torch.float64)
    ho = (h + 2 * padding - fh) // stride + 1
    wo = (wd + 2 * padding - fw) // stride + 1
    acc = torch.matmul(cols.transpose(1, 2), wm)           # (n, L, co)
    return torch.round(acc).to(torch.int64).reshape(n, ho, wo, co)


def int_forward(net: dict, images: torch.Tensor) -> torch.Tensor:
    """Real images (N, H, W, C) -> int64 logits (N, classes)."""
    hi = umax(net["a_bits"])
    stream = to_grid(images, net["eps_in"], 0, hi).to(torch.int64)
    edges = {}
    for q in net["layers"]:
        L = q["L"]
        xin = edges[L["input_from"]] if L.get("input_from") else stream
        k = L["kind"]
        if k == "conv":
            acc = _conv_acc(xin, q["w"], L.get("stride", 1),
                            L.get("padding", 1))
            dev = acc.device
            phi = wrap32(acc * torch.as_tensor(q["kappa"], device=dev)
                         + torch.as_tensor(q["lam"], device=dev))
            y = torch.clamp(shift_floor(phi, q["m"], q["d"]), 0, hi)
        elif k == "avgpool_global":
            y = torch.clamp(shift_floor(wrap32(xin.sum(dim=(1, 2))),
                                        q["m"], q["d"]), 0, hi)
        elif k == "add":
            y = torch.clamp((xin * q["m1"] + edges[L["skip_from"]] * q["m2"])
                            >> q["d"], 0, hi)
        else:                        # linear head, raw accumulators
            y = torch.round(torch.matmul(xin.to(torch.float64),
                                         q["w"].to(torch.float64))
                            ).to(torch.int64)
        if L.get("save_as"):
            edges[L["save_as"]] = y
        if not L.get("branch", False):
            stream = y
    return stream


def logits(net: dict, images: torch.Tensor, block: int = 1024):
    """`int_forward` over ``images`` in blocks of rows."""
    return torch.cat([int_forward(net, images[i:i + block])
                      for i in range(0, images.shape[0], block)])
