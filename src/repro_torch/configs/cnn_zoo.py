"""Layer-shape tables for the paper's four evaluation CNNs (port of
``repro/configs/cnn_zoo.py``; Section V-A3)
at CIFAR-10 resolution (32x32, B=1 edge inference) — feeds the Figs 12-13
system-level benchmark through the dataflow/tiling engine.

Depthwise convolutions are modeled as K=channels, C=1 (no channel
reduction); pointwise as FY=FX=1.
"""

from __future__ import annotations

from typing import List

from repro_torch.core.dataflow import LayerShape


def _conv(name, k, c, hw, f=3, b=1):
    return LayerShape(name, B=b, K=k, C=c, OY=hw, OX=hw, FY=f, FX=f)


def _fc(name, k, c, b=1):
    return LayerShape(name, B=b, K=k, C=c, OY=1, OX=1)


def resnet18() -> List[LayerShape]:
    layers = [_conv("conv1", 64, 3, 32)]
    spec = [(64, 32, 2), (128, 16, 2), (256, 8, 2), (512, 4, 2)]
    in_c = 64
    for k, hw, n_blocks in spec:
        for b in range(n_blocks):
            layers.append(_conv(f"l{k}b{b}a", k, in_c, hw))
            layers.append(_conv(f"l{k}b{b}b", k, k, hw))
            if in_c != k:
                layers.append(LayerShape(f"l{k}b{b}s", 1, k, in_c, hw, hw,
                                         1, 1))
            in_c = k
    layers.append(_fc("fc", 10, 512))
    return layers


def vgg16() -> List[LayerShape]:
    cfg = [(64, 32, 2), (128, 16, 2), (256, 8, 3), (512, 4, 3), (512, 2, 3)]
    layers = []
    in_c = 3
    for k, hw, reps in cfg:
        for r in range(reps):
            layers.append(_conv(f"c{k}_{r}@{hw}", k, in_c, hw))
            in_c = k
    layers += [_fc("fc1", 4096, 512 * 1 * 1), _fc("fc2", 4096, 4096),
               _fc("fc3", 10, 4096)]
    return layers


def alexnet() -> List[LayerShape]:
    return [
        _conv("conv1", 64, 3, 16, f=5),
        _conv("conv2", 192, 64, 8, f=5),
        _conv("conv3", 384, 192, 4),
        _conv("conv4", 256, 384, 4),
        _conv("conv5", 256, 256, 4),
        _fc("fc1", 4096, 256 * 2 * 2),
        _fc("fc2", 4096, 4096),
        _fc("fc3", 10, 4096),
    ]


def mobilenet_v2() -> List[LayerShape]:
    """Inverted residuals: expand (1x1) -> depthwise 3x3 -> project (1x1)."""
    layers = [_conv("conv1", 32, 3, 32)]
    # (expansion t, out c, repeats, spatial)
    spec = [(1, 16, 1, 32), (6, 24, 2, 16), (6, 32, 3, 16), (6, 64, 4, 8),
            (6, 96, 3, 8), (6, 160, 3, 4), (6, 320, 1, 4)]
    in_c = 32
    for t, c_out, reps, hw in spec:
        for r in range(reps):
            mid = in_c * t
            if t != 1:
                layers.append(LayerShape(f"exp{c_out}_{r}", 1, mid, in_c,
                                         hw, hw, 1, 1))
            layers.append(LayerShape(f"dw{c_out}_{r}", 1, mid, 1, hw, hw,
                                     3, 3))
            layers.append(LayerShape(f"prj{c_out}_{r}", 1, c_out, mid,
                                     hw, hw, 1, 1))
            in_c = c_out
    layers.append(LayerShape("head", 1, 1280, 320, 4, 4, 1, 1))
    layers.append(_fc("fc", 10, 1280))
    return layers


NETWORKS = {
    "resnet18": resnet18,
    "mobilenet_v2": mobilenet_v2,
    "vgg16": vgg16,
    "alexnet": alexnet,
}

# measured value sparsity of activations per network (paper Section IV-B3:
# MobileNetV2 has near-zero value sparsity; others significant)
ACT_VALUE_SPARSITY = {"resnet18": 0.45, "mobilenet_v2": 0.05,
                      "vgg16": 0.55, "alexnet": 0.6}
BIT_SPARSITY = {"resnet18": 0.65, "mobilenet_v2": 0.62,
                "vgg16": 0.66, "alexnet": 0.67}
