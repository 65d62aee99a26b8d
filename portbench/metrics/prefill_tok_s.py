"""prefill_tok_s: prompt tokens of every prefill call of the window (a
call ends with its last-position logits and every layer's K/V ready on
the device, after a synchronize), over the window's length."""


def read(ctx):
    return sum(u["tokens"] for _, _, u in ctx["steps"]) / ctx["window_s"]
