"""wave_p95_ms: the 95th percentile of every wave of the window, each
from the start of its input quantization to its int32 logits on the
host."""
import statistics


def read(ctx):
    ms = [(t1 - t0) * 1e3 for t0, t1, _ in ctx["steps"]]
    if len(ms) < 2:
        return ms[0]
    return statistics.quantiles(ms, n=100, method="inclusive")[94]
