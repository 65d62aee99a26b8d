"""forward_idle.vision: the share of the traced window in which the card
was idle while the host was inside the program's vision step, the union
of its ``vision/`` spans (``vision/quantize``, then one ``vision/<path>``
per layer of `forward_int`), over the window. The rest of
``idle_share.vision`` lies outside these spans: the readback, between
waves. Left out (None) where the trace holds no such span."""
from portbench.harness import span_idle


def read(ctx):
    tr = ctx["trace"]
    idle = None if tr is None else span_idle.idle_inside(tr, "vision/")
    return None if idle is None else 100.0 * idle / tr.window_s
