"""Named vision network configs (full + smoke variants)."""
from __future__ import annotations

from repro_torch.vision.configs.qat_cnn import qat_cnn
from repro_torch.vision.configs.resnet8 import resnet8

VISION_CONFIGS = {
    "qat-cnn": qat_cnn,
    "resnet8": resnet8,
}

# Configs of the reference that need layers this port does not have yet.
NOT_PORTED = {
    "mobilenet-tiny": "needs QDepthwiseConv2D; see ROADMAP Queue 1, item 4",
}


def get_vision_config(name: str, *, smoke: bool = False, a_bits: int = 8):
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"vision config {name!r} is not ported yet: {NOT_PORTED[name]}")
    builder = VISION_CONFIGS.get(name)
    if builder is None:
        raise KeyError(f"unknown vision config {name!r}; "
                       f"available: {sorted(VISION_CONFIGS)}")
    return builder(smoke=smoke, a_bits=a_bits)
