"""forward_idle.prefill: the share of the traced window in which the
card was idle while the host was inside the program's LM prefill, the
union of its ``lm/`` spans (``lm/embed``; per layer ``lm/attn.qkv``,
``lm/attn.core``, ``lm/attn.out``, ``lm/mlp``; ``lm/head``), over the
window. Left out (None) where the trace holds no such span."""
from portbench.harness import span_idle


def read(ctx):
    tr = ctx["trace"]
    idle = None if tr is None else span_idle.idle_inside(tr, "lm/")
    return None if idle is None else 100.0 * idle / tr.window_s
