"""images_per_s: images whose int32 logits reached the host in the
window, over the window's length (the closed loop's first start to its
last unit's end)."""


def read(ctx):
    return sum(u["images"] for _, _, u in ctx["steps"]) / ctx["window_s"]
