"""MobileNetV1-style depthwise-separable QNN (CIFAR/MLPerf-Tiny scale).

A strided conv stem and a 2x2 max pool, then [3x3 depthwise + 1x1
pointwise] blocks doubling channels as the spatial extent halves, global
average pooling and a linear classifier; the same graph as the
reference's `mobilenet_v1_tiny`.
"""
from __future__ import annotations

from repro_torch.vision.models import LayerDef, VisionConfig


def mobilenet_v1_tiny(smoke: bool = False, a_bits: int = 8) -> VisionConfig:
    width = 8 if smoke else 16
    in_hw = (16, 16) if smoke else (32, 32)
    n_blocks = 2 if smoke else 3
    layers = [
        LayerDef(path="stem", kind="conv", cout=width, fh=3, fw=3,
                 stride=2, padding=1),
        LayerDef(path="pool0", kind="maxpool", window=2, stride=2),
    ]
    c = width
    for b in range(n_blocks):
        stride = 2 if (b and b % 2 == 0) else 1
        cout = c * 2 if b < n_blocks - 1 else c
        layers += [
            LayerDef(path=f"block{b}/dw", kind="dwconv", fh=3, fw=3,
                     stride=stride, padding=1),
            LayerDef(path=f"block{b}/pw", kind="conv", cout=cout, fh=1,
                     fw=1, stride=1, padding=0),
        ]
        c = cout
    layers += [
        LayerDef(path="pool", kind="avgpool_global"),
        LayerDef(path="head", kind="linear", cout=10),
    ]
    return VisionConfig(
        name="mobilenet-tiny" + ("-smoke" if smoke else ""),
        layers=tuple(layers), num_classes=10, in_hw=in_hw, in_ch=3,
        a_bits=a_bits)
