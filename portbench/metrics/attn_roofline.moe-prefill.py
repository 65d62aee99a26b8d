"""attn_roofline.moe-prefill: the fused attention kernel's share of its
roofline in a DeepSeek-V3-block call: per call latent attention's two
products over the causal pairs of every head and layer, scores
qk_nope + qk_rope wide and values v_head_dim wide
(`harness/work_mla_moe.py::attention_flops`), at the bf16 peak, over
the device time of the kernel named below, over the traced calls that
hold the usual number of its launches. The count takes the allowed pairs
only, so the masked part of the kernel's diagonal tiles can only lower
the share. None where the trace holds no record of the kernel (a
program that runs attention without it)."""
from portbench.harness import trace as trace_mod
from portbench.harness import work_mla_moe

KERNELS = ("attn_fwd_kernel",)


def read(ctx):
    tr = ctx["trace"]
    if tr is None or ctx["peaks"] is None:
        return None
    n, dev_s, _ = trace_mod.matching_steps(tr, KERNELS)
    if n == 0:
        return None
    u = ctx["steps"][0][2]
    least = (work_mla_moe.attention_flops(ctx["config"], u["rows"],
                                          u["seq"])
             / ctx["peaks"]["bf16_flops"])
    return 100.0 * n * least / dev_s
