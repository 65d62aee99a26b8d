"""The work of a DeepSeek-V3-block configuration (Kimi-K2-Instruct: latent
attention, leading dense layers, routed and shared experts), counted
from its shapes alone: the yardstick of ``mfu.moe-prefill`` and
``qmatmul_roofline.moe-prefill``, whatever implements it.

A MAC is one multiply-add (2 operations). The held experts' rows are
the expected ones: every token's top-k choices spread evenly over the
router's experts, so a card holding ``n_routed_experts`` of the
router's ``published.n_routed_experts`` computes tokens x top-k x held
/ routed rows, each held expert tokens x top-k / routed of them. Bytes
count each input read once and each output written once: int8
activations, packed weights at w_bits, a float32 scale per column, the
output in the compute dtype.
"""
from __future__ import annotations

import math
from typing import List

from portbench.harness import work


def dims(cfg: dict) -> dict:
    h = cfg["num_attention_heads"]
    nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    routed = cfg.get("published", {}).get("n_routed_experts",
                                          cfg["n_routed_experts"])
    n_dense = cfg["first_k_dense_replace"]
    return {"d": cfg["hidden_size"], "h": h, "rq": cfg["q_lora_rank"],
            "rkv": cfg["kv_lora_rank"], "nope": nope, "rope": rope,
            "qk": nope + rope, "dv": cfg["v_head_dim"],
            "dense_ff": cfg["intermediate_size"],
            "f": cfg["moe_intermediate_size"], "top_k":
            cfg["num_experts_per_tok"], "routed": routed,
            "held": cfg["n_routed_experts"],
            "shared": cfg.get("n_shared_experts", 0),
            "layers": cfg["num_hidden_layers"], "n_dense": n_dense,
            "n_moe": cfg["num_hidden_layers"] - n_dense,
            "vocab": cfg["vocab_size"]}


def mla_gemms(cfg: dict) -> List[tuple]:
    """(name, K, N) of one layer's latent-attention projections."""
    m = dims(cfg)
    return [("wq_a", m["d"], m["rq"]), ("wq_b", m["rq"], m["h"] * m["qk"]),
            ("wkv_a", m["d"], m["rkv"] + m["rope"]),
            ("wkv_b", m["rkv"], m["h"] * (m["nope"] + m["dv"])),
            ("wo", m["h"] * m["dv"], m["d"])]


def swiglu_gemms(d: int, ff: int) -> List[tuple]:
    return [("wi", d, ff), ("wg", d, ff), ("wo", ff, d)]


def expert_rows(cfg: dict, tokens: int) -> float:
    """Expected rows of one held expert in a call of ``tokens``."""
    m = dims(cfg)
    return tokens * m["top_k"] / m["routed"]


def gemm_work(cfg: dict, tokens: int) -> List[dict]:
    """Every packed GEMM of a call of ``tokens`` tokens: M, K, N, how
    many such GEMMs the call runs, MACs and least bytes of one."""
    m = dims(cfg)
    wb = cfg["w_bits"]
    out_b = 2 if cfg.get("compute_dtype", "bfloat16") == "bfloat16" else 4
    rows = expert_rows(cfg, tokens)
    groups = [(tokens, mla_gemms(cfg), m["layers"]),
              (tokens, swiglu_gemms(m["d"], m["dense_ff"]), m["n_dense"]),
              (tokens, swiglu_gemms(m["d"], m["f"]),
               m["n_moe"] * m["shared"]),
              (rows, swiglu_gemms(m["d"], m["f"]), m["n_moe"] * m["held"])]
    out = []
    for rows_m, gemms, count in groups:
        for name, k, n in gemms:
            out.append({"name": name, "m": rows_m, "k": k, "n": n,
                        "count": count, "macs": rows_m * k * n,
                        "bytes": (rows_m * k + math.ceil(k * n * wb / 8)
                                  + 4 * n + rows_m * n * out_b)})
    return out


def packed_macs(cfg: dict, tokens: int) -> float:
    return sum(g["macs"] * g["count"] for g in gemm_work(cfg, tokens))


def attention_flops(cfg: dict, batch: int, seq: int) -> int:
    """Operations of the two attention products over the causal pairs
    of every head and layer: scores qk_nope + qk_rope wide, values
    v_head_dim wide."""
    m = dims(cfg)
    return (2 * work.attention_pairs(seq) * m["h"] * (m["qk"] + m["dv"])
            * batch * m["layers"])


def head_flops(cfg: dict, rows: int) -> int:
    m = dims(cfg)
    return 2 * rows * m["d"] * m["vocab"]
