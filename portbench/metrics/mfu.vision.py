"""mfu.vision: the whole integer forward's share of the card's int8
peak: the least time its MACs take at that peak (2 operations each;
MACs counted from the configuration's layer shapes at the real channel
counts) over the traced window's measured time."""
from portbench.harness import work


def read(ctx):
    if ctx["peaks"] is None:
        return None
    images = sum(u["images"] for _, _, u in ctx["steps"])
    least = (2 * work.vision_macs_per_image(ctx["config"]) * images
             / ctx["peaks"]["int8_ops"])
    return 100.0 * least / ctx["window_s"]
