"""ResNet-8 (MLPerf-Tiny image-classification class) as a QNN graph.

Three residual stages over a conv stem: stage 1 with an identity skip,
stages 2/3 stride-2 with 1x1 projection convs on the skip path, global
average pooling, linear head. Every conv output is requantized onto the
unsigned activation grid, and each residual add is the two-scale integer
add (`repro_torch.vision.layers.QResidualAdd`).
"""
from __future__ import annotations

from repro_torch.vision.models import LayerDef, VisionConfig


def _stage(name: str, cin_edge: str, cout: int, stride: int,
           out_edge: str):
    """One residual stage reading edge ``cin_edge``: two 3x3 convs on the
    main stream + (projection or identity) skip + requantizing add."""
    layers = [
        LayerDef(path=f"{name}/c1", kind="conv", cout=cout, stride=stride),
        LayerDef(path=f"{name}/c2", kind="conv", cout=cout),
    ]
    if stride != 1:
        layers.append(LayerDef(
            path=f"{name}/skip", kind="conv", cout=cout, fh=1, fw=1,
            stride=stride, padding=0, input_from=cin_edge,
            save_as=f"{name}_skip", branch=True))
        skip_edge = f"{name}_skip"
    else:
        skip_edge = cin_edge
    layers.append(LayerDef(path=f"{name}/add", kind="add",
                           skip_from=skip_edge, save_as=out_edge))
    return layers


def resnet8(smoke: bool = False, a_bits: int = 8) -> VisionConfig:
    width = 8 if smoke else 16
    in_hw = (16, 16) if smoke else (32, 32)
    layers = [
        LayerDef(path="stem", kind="conv", cout=width, save_as="s1_in"),
        *_stage("s1", "s1_in", width, 1, "s2_in"),
        *_stage("s2", "s2_in", 2 * width, 2, "s3_in"),
        *_stage("s3", "s3_in", 4 * width, 2, "feat"),
        LayerDef(path="pool", kind="avgpool_global"),
        LayerDef(path="head", kind="linear", cout=10),
    ]
    return VisionConfig(
        name="resnet8" + ("-smoke" if smoke else ""),
        layers=tuple(layers), num_classes=10, in_hw=in_hw, in_ch=3,
        a_bits=a_bits)
