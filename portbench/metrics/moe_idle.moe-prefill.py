"""moe_idle.moe-prefill: the share of the traced window in which the
card was idle while the host was inside the program's dropless MoE
blocks, the union of their ``lm/moe.`` spans (``lm/moe.route``: ln2,
router, selection, grouping and the read of the held experts' row
counts to the host; ``lm/moe.experts``; ``lm/moe.shared``), over the
window. Left out (None) where the trace holds no such span."""
from portbench.harness import span_idle


def read(ctx):
    tr = ctx["trace"]
    idle = None if tr is None else span_idle.idle_inside(tr, "lm/moe.")
    return None if idle is None else 100.0 * idle / tr.window_s
