"""mfu.prefill: the whole prefill's share of the card's peak: per call,
the least time of its packed dense MACs at the int8 peak, its attention
products over the causal (windowed) pairs at the bf16 peak (a bf16
product is exact in float32, so a bf16 tensor-core product with float32
accumulation does this work), and the last position's head at the bf16
peak, over the traced window's measured time. Logits at other
positions, padding and elementwise work count nothing."""
from portbench.harness import work


def read(ctx):
    if ctx["peaks"] is None:
        return None
    cfg, p = ctx["config"], ctx["peaks"]
    least = 0.0
    for _, _, u in ctx["steps"]:
        least += (2 * work.lm_dense_macs_per_token(cfg) * u["tokens"]
                  / p["int8_ops"]
                  + work.lm_attention_flops(cfg, u["rows"], u["seq"])
                  / p["bf16_flops"]
                  + work.lm_head_flops(cfg, u["rows"]) / p["bf16_flops"])
    return 100.0 * least / ctx["window_s"]
