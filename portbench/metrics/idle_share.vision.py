"""idle_share.vision: the share of the traced window (first wave's
start to last wave's end) in which the card ran neither a kernel nor a
copy: the union of the trace's device intervals, not summed self
times."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
