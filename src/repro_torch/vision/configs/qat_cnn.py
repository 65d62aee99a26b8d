"""The QAT digit CNN: 16x16x1 in, three convs, a 256-channel last conv.

The reference's accuracy network. Its 256-channel ``c3`` is wider than one
`packing.CHUNK` (128), so a channel-group plan can give ``c3`` two runs
of different widths (`PlanRule.segments`); every other layer fits in one
group. The smoke variant narrows the widths.
"""
from __future__ import annotations

from repro_torch.vision.models import LayerDef, VisionConfig


def qat_cnn(smoke: bool = False, a_bits: int = 8) -> VisionConfig:
    c1, c2, c3 = (8, 16, 32) if smoke else (16, 32, 256)
    layers = (
        LayerDef(path="c1", kind="conv", cout=c1),
        LayerDef(path="p1", kind="maxpool"),              # 16 -> 8
        LayerDef(path="c2", kind="conv", cout=c2),
        LayerDef(path="p2", kind="maxpool"),              # 8 -> 4
        LayerDef(path="c3", kind="conv", cout=c3),
        LayerDef(path="pool", kind="avgpool_global"),
        LayerDef(path="head", kind="linear", cout=10),
    )
    return VisionConfig(
        name="qat-cnn" + ("-smoke" if smoke else ""),
        layers=layers, num_classes=10, in_hw=(16, 16), in_ch=1,
        a_bits=a_bits)
