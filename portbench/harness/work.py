"""The work a configuration asks for, counted from its shapes alone.

These counts are the yardstick of the roofline and ``mfu`` metrics: the
same work whatever implements it. A MAC is one multiply-add (2
operations). Bytes count each input read once and each output written
once, at the sizes the configuration states (the real channel count,
not a padded one).
"""
from __future__ import annotations

import math
from typing import Dict, List


# ------------------------------------------------------------ vision ---

def vision_layers(cfg: dict) -> List[dict]:
    """Per layer of a vision config's graph: the layer and its (h, w, c)
    input and output; h = w = 0 once the stream is flat."""
    stream = (cfg["in_h"], cfg["in_w"], cfg["in_ch"])
    edges: Dict[str, tuple] = {}
    out = []
    for L in cfg["layers"]:
        src = edges[L["input_from"]] if L.get("input_from") else stream
        h, w, c = src
        k = L["kind"]
        fh, fw = L.get("fh", 3), L.get("fw", 3)
        s, p = L.get("stride", 1), L.get("padding", 1)
        if k in ("conv", "dwconv"):
            dst = ((h + 2 * p - fh) // s + 1, (w + 2 * p - fw) // s + 1,
                   L["cout"] if k == "conv" else c)
        elif k == "maxpool":
            win = L.get("window", 2)
            dst = ((h - win) // s + 1, (w - win) // s + 1, c)
        elif k == "avgpool_global":
            dst = (0, 0, c)
        elif k == "add":
            dst = src
        elif k == "linear":
            dst = (0, 0, L["cout"])
        else:
            raise ValueError(f"{L['path']}: unknown kind {k!r}")
        out.append({"layer": L, "in": src, "out": dst})
        if L.get("save_as"):
            edges[L["save_as"]] = dst
        if not L.get("branch", False):
            stream = dst
    return out


def layer_macs(tr: dict) -> int:
    """MACs of one layer for one image."""
    L, (h, w, c), (ho, wo, co) = tr["layer"], tr["in"], tr["out"]
    fh, fw = L.get("fh", 3), L.get("fw", 3)
    if L["kind"] == "conv":
        return ho * wo * co * fh * fw * c
    if L["kind"] == "dwconv":
        return ho * wo * c * fh * fw
    if L["kind"] == "linear":
        return (h * w or 1) * c * co
    return 0


def vision_macs_per_image(cfg: dict) -> int:
    return sum(layer_macs(tr) for tr in vision_layers(cfg))


def conv_work(cfg: dict, images: int) -> List[dict]:
    """Per standard conv of the graph: MACs and the least bytes of one
    call over ``images`` images (int8 input at the real Cin, the packed
    weights at w_bits, three int32 epilogue vectors, int8 output)."""
    out = []
    wb = cfg["w_bits"]
    for tr in vision_layers(cfg):
        L = tr["layer"]
        if L["kind"] != "conv":
            continue
        (h, w, c), (ho, wo, co) = tr["in"], tr["out"]
        fh, fw = L.get("fh", 3), L.get("fw", 3)
        out.append({
            "path": L["path"],
            "macs": images * layer_macs(tr),
            "bytes": (images * h * w * c
                      + math.ceil(fh * fw * c * co * wb / 8)
                      + 3 * 4 * co
                      + images * ho * wo * co)})
    return out


# ------------------------------------------------------- decoder LMs ---

def lm_dims(cfg: dict) -> dict:
    d = cfg["hidden_size"]
    h = cfg["num_attention_heads"]
    hk = cfg.get("num_key_value_heads", h)
    dh = cfg.get("head_dim") or d // h
    return {"d": d, "h": h, "hk": hk, "dh": dh,
            "ff": cfg["intermediate_size"], "layers":
            cfg["num_hidden_layers"], "vocab": cfg["vocab_size"]}


def lm_dense_gemms(cfg: dict) -> List[tuple]:
    """(name, K, N) of one layer's packed dense GEMMs (SwiGLU MLP)."""
    m = lm_dims(cfg)
    d, q, kv, ff = m["d"], m["h"] * m["dh"], m["hk"] * m["dh"], m["ff"]
    return [("wq", d, q), ("wk", d, kv), ("wv", d, kv), ("wo", q, d),
            ("wi", d, ff), ("wg", d, ff), ("mlp_wo", ff, d)]


def lm_dense_macs_per_token(cfg: dict) -> int:
    return lm_dims(cfg)["layers"] * sum(k * n for _, k, n
                                        in lm_dense_gemms(cfg))


def dense_gemm_work(cfg: dict, tokens: int) -> List[dict]:
    """Per dense GEMM of one layer at M = ``tokens``: MACs and least
    bytes (int8 activations, packed weights at w_bits, a float32 scale
    per column, output in the compute dtype)."""
    out_bytes = 2 if cfg.get("compute_dtype", "bfloat16") == "bfloat16" \
        else 4
    wb = cfg["w_bits"]
    return [{"name": name, "macs": tokens * k * n,
             "bytes": (tokens * k + math.ceil(k * n * wb / 8) + 4 * n
                       + tokens * n * out_bytes)}
            for name, k, n in lm_dense_gemms(cfg)]


def attention_pairs(seq: int, window: int = 0) -> int:
    """Causal (query, key) pairs of one sequence; with a sliding
    ``window``, only keys fewer than ``window`` positions back."""
    if not window or window >= seq:
        return seq * (seq + 1) // 2
    w = window
    return w * (w + 1) // 2 + (seq - w) * w


def lm_attention_flops(cfg: dict, batch: int, seq: int) -> int:
    """Operations of the two attention products (scores, values) over
    the causal pairs of every head and layer."""
    m = lm_dims(cfg)
    pairs = attention_pairs(seq, cfg.get("sliding_window") or 0)
    return 2 * 2 * pairs * m["dh"] * m["h"] * batch * m["layers"]


def lm_head_flops(cfg: dict, rows: int) -> int:
    m = lm_dims(cfg)
    return 2 * rows * m["d"] * m["vocab"]
