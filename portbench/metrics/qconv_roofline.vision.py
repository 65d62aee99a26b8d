"""qconv_roofline.vision: the conv kernels' share of their roofline.
Per wave, each standard conv's least time is the larger of 2 x MACs at
the int8 peak and its least bytes (int8 input at the real Cin read once,
packed weights, epilogue vectors, int8 output written once) at the HBM
peak; the share is their sum over the device time of the kernels named
below, over the traced waves that hold all of them."""
from portbench.harness import trace as trace_mod
from portbench.harness import work

KERNELS = ("qconv_kernel",)


def read(ctx):
    tr = ctx["trace"]
    if tr is None or ctx["peaks"] is None:
        return None
    n, dev_s, _ = trace_mod.matching_steps(tr, KERNELS)
    if n == 0:
        raise RuntimeError("qconv_roofline.vision: the trace holds no "
                           f"record of {KERNELS} in any wave")
    p = ctx["peaks"]
    images = ctx["steps"][0][2]["images"]
    bound = sum(max(2 * c["macs"] / p["int8_ops"],
                    c["bytes"] / p["hbm_bytes"])
                for c in work.conv_work(ctx["config"], images))
    return 100.0 * n * bound / dev_s
