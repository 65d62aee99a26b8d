"""mfu.moe-prefill: the whole prefill's share of the card's peak for a
DeepSeek-V3-block configuration (`harness/work_mla_moe.py`): per call,
the least time of its packed MACs at the int8 peak (latent attention's
five projections a layer, the dense FFN, the shared expert, the held
experts at their expected rows: tokens x top-k x held / routed), its
attention products over the causal pairs (scores qk_nope + qk_rope
wide, values v_head_dim wide, every head and layer) at the bf16 peak,
and the last position's head at the bf16 peak, over the traced window's
measured time. Logits at other positions, routing, padding and
elementwise work count nothing."""
from portbench.harness import work_mla_moe


def read(ctx):
    if ctx["peaks"] is None:
        return None
    cfg, p = ctx["config"], ctx["peaks"]
    least = 0.0
    for _, _, u in ctx["steps"]:
        least += (2 * work_mla_moe.packed_macs(cfg, u["tokens"])
                  / p["int8_ops"]
                  + work_mla_moe.attention_flops(cfg, u["rows"], u["seq"])
                  / p["bf16_flops"]
                  + work_mla_moe.head_flops(cfg, u["rows"])
                  / p["bf16_flops"])
    return 100.0 * least / ctx["window_s"]
