"""Named vision network configs (full + smoke variants)."""
from __future__ import annotations

from repro_torch.vision.configs.mobilenet_v1 import mobilenet_v1_tiny
from repro_torch.vision.configs.qat_cnn import qat_cnn
from repro_torch.vision.configs.resnet8 import resnet8

VISION_CONFIGS = {
    "mobilenet-tiny": mobilenet_v1_tiny,
    "qat-cnn": qat_cnn,
    "resnet8": resnet8,
}


def get_vision_config(name: str, *, smoke: bool = False, a_bits: int = 8):
    builder = VISION_CONFIGS.get(name)
    if builder is None:
        raise KeyError(f"unknown vision config {name!r}; "
                       f"available: {sorted(VISION_CONFIGS)}")
    return builder(smoke=smoke, a_bits=a_bits)
