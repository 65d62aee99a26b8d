"""qmatmul_roofline.moe-prefill: the packed GEMM kernel's share of its
roofline over every packed GEMM of a DeepSeek-V3-block call
(`harness/work_mla_moe.py::gemm_work`: latent attention's five a layer,
the dense FFN's three, the shared expert's three a MoE layer, each held
expert's three at its expected rows tokens x top-k / routed, its weights
read once): per GEMM the larger of 2 x MACs at the int8 peak and its
least bytes at the HBM peak, summed, over the device time of the
kernels named below, over the traced calls that hold the usual number
of them."""
from portbench.harness import trace as trace_mod
from portbench.harness import work_mla_moe

KERNELS = ("qmatmul_kernel",)


def read(ctx):
    tr = ctx["trace"]
    if tr is None or ctx["peaks"] is None:
        return None
    n, dev_s, _ = trace_mod.matching_steps(tr, KERNELS)
    if n == 0:
        raise RuntimeError("qmatmul_roofline.moe-prefill: the trace holds "
                           f"no record of {KERNELS} in any call")
    cfg, p = ctx["config"], ctx["peaks"]
    tokens = ctx["steps"][0][2]["tokens"]
    bound = sum(g["count"] * max(2 * g["macs"] / p["int8_ops"],
                                 g["bytes"] / p["hbm_bytes"])
                for g in work_mla_moe.gemm_work(cfg, tokens))
    return 100.0 * n * bound / dev_s
