"""qmatmul_roofline.prefill: the packed GEMM kernel's share of its
roofline over every layer's dense GEMMs at M = the call's tokens: per
GEMM the larger of 2 x MACs at the int8 peak and its least bytes (int8
activations, packed weights, a float32 scale per column, the output in
the compute dtype) at the HBM peak, summed over the layers, over the
device time of the kernels named below, over the traced calls that hold
all of them."""
from portbench.harness import trace as trace_mod
from portbench.harness import work

KERNELS = ("qmatmul_kernel",)


def read(ctx):
    tr = ctx["trace"]
    if tr is None or ctx["peaks"] is None:
        return None
    n, dev_s, _ = trace_mod.matching_steps(tr, KERNELS)
    if n == 0:
        raise RuntimeError("qmatmul_roofline.prefill: the trace holds no "
                           f"record of {KERNELS} in any call")
    cfg, p = ctx["config"], ctx["peaks"]
    tokens = ctx["steps"][0][2]["tokens"]
    layers = work.lm_dims(cfg)["layers"]
    bound = layers * sum(max(2 * g["macs"] / p["int8_ops"],
                             g["bytes"] / p["hbm_bytes"])
                         for g in work.dense_gemm_work(cfg, tokens))
    return 100.0 * n * bound / dev_s
