"""Private copy of ``repro.core.cnn_workloads`` for the PyTorch port (``import
repro_torch`` loads nothing of ``repro``); only intra-package imports
differ.

CNN workloads evaluated by the paper (§V-B): GoogleNet, ResNet50,
MobileNetV2, ShuffleNetV2 — batch 1, 224x224 inputs, 8-bit quantized.

Each conv layer is expressed as its im2col GEMM (paper Fig. 1):
rows = output spatial positions, k = C_in*kh*kw (dot-product length),
cols = C_out.  Depthwise convs set groups=C (each output channel is an
independent k=kh*kw dot product).  FC layers are rows=1 GEMMs.
"""

from __future__ import annotations

import dataclasses
from typing import List


@dataclasses.dataclass(frozen=True)
class GemmLayer:
    name: str
    rows: int      # output spatial positions (im2col rows) x batch
    k: int         # dot-product length per group
    cols: int      # output channels per group
    groups: int = 1

    @property
    def dots(self) -> int:
        """Total dot products (each of length k)."""
        return self.rows * self.cols * self.groups

    @property
    def macs(self) -> int:
        return self.dots * self.k


def _conv(name, hw, cin, cout, kernel=1, stride=1, groups=1) -> GemmLayer:
    out = hw // stride
    if groups == 1:
        return GemmLayer(name, out * out, cin * kernel * kernel, cout)
    # depthwise: per-channel k*k dot
    assert groups == cin == cout
    return GemmLayer(name, out * out, kernel * kernel, 1, groups=cin)


# ---------------------------------------------------------------------------
# ResNet50 (He et al., CVPR 2016) — exact
# ---------------------------------------------------------------------------
def resnet50() -> List[GemmLayer]:
    layers = [_conv("conv1", 224, 3, 64, 7, 2)]
    cfg = [  # (blocks, c_mid, c_out, hw_in, first_stride)
        (3, 64, 256, 56, 1),
        (4, 128, 512, 56, 2),
        (6, 256, 1024, 28, 2),
        (3, 512, 2048, 14, 2),
    ]
    c_in = 64
    for si, (blocks, cm, co, hw, s0) in enumerate(cfg):
        for b in range(blocks):
            s = s0 if b == 0 else 1
            hw_b = hw if b == 0 else hw // s0
            pre = f"res{si+2}{chr(97+b)}"
            layers.append(_conv(f"{pre}_1x1a", hw_b, c_in, cm, 1, s))
            layers.append(_conv(f"{pre}_3x3", hw_b // s, cm, cm, 3, 1))
            layers.append(_conv(f"{pre}_1x1b", hw_b // s, cm, co, 1, 1))
            if b == 0:
                layers.append(_conv(f"{pre}_down", hw_b, c_in, co, 1, s))
            c_in = co
    layers.append(GemmLayer("fc", 1, 2048, 1000))
    return layers


# ---------------------------------------------------------------------------
# GoogleNet / Inception-v1 (Szegedy et al., CVPR 2015)
# ---------------------------------------------------------------------------
_INCEPTION = [  # (name, hw, cin, 1x1, 3x3red, 3x3, 5x5red, 5x5, pool_proj)
    ("3a", 28, 192, 64, 96, 128, 16, 32, 32),
    ("3b", 28, 256, 128, 128, 192, 32, 96, 64),
    ("4a", 14, 480, 192, 96, 208, 16, 48, 64),
    ("4b", 14, 512, 160, 112, 224, 24, 64, 64),
    ("4c", 14, 512, 128, 128, 256, 24, 64, 64),
    ("4d", 14, 512, 112, 144, 288, 32, 64, 64),
    ("4e", 14, 528, 256, 160, 320, 32, 128, 128),
    ("5a", 7, 832, 256, 160, 320, 32, 128, 128),
    ("5b", 7, 832, 384, 192, 384, 48, 128, 128),
]


def googlenet() -> List[GemmLayer]:
    layers = [
        _conv("conv1", 224, 3, 64, 7, 2),
        _conv("conv2_red", 56, 64, 64, 1, 1),
        _conv("conv2", 56, 64, 192, 3, 1),
    ]
    for name, hw, cin, c1, c3r, c3, c5r, c5, cp in _INCEPTION:
        layers += [
            _conv(f"inc{name}_1x1", hw, cin, c1),
            _conv(f"inc{name}_3x3r", hw, cin, c3r),
            _conv(f"inc{name}_3x3", hw, c3r, c3, 3),
            _conv(f"inc{name}_5x5r", hw, cin, c5r),
            _conv(f"inc{name}_5x5", hw, c5r, c5, 5),
            _conv(f"inc{name}_pool", hw, cin, cp),
        ]
    layers.append(GemmLayer("fc", 1, 1024, 1000))
    return layers


# ---------------------------------------------------------------------------
# MobileNetV2 (Sandler et al., CVPR 2018)
# ---------------------------------------------------------------------------
_MBV2 = [  # (expansion t, c_out, n_blocks, stride)
    (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
    (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
]


def mobilenet_v2() -> List[GemmLayer]:
    layers = [_conv("conv1", 224, 3, 32, 3, 2)]
    c_in, hw = 32, 112
    for bi, (t, c, n, s) in enumerate(_MBV2):
        for i in range(n):
            stride = s if i == 0 else 1
            mid = c_in * t
            pre = f"ir{bi}_{i}"
            if t != 1:
                layers.append(_conv(f"{pre}_exp", hw, c_in, mid, 1, 1))
            layers.append(_conv(f"{pre}_dw", hw, mid, mid, 3, stride, groups=mid))
            hw = hw // stride
            layers.append(_conv(f"{pre}_proj", hw, mid, c, 1, 1))
            c_in = c
    layers.append(_conv("conv_last", hw, c_in, 1280, 1, 1))
    layers.append(GemmLayer("fc", 1, 1280, 1000))
    return layers


# ---------------------------------------------------------------------------
# ShuffleNetV2 1x (Ma et al., ECCV 2018)
# ---------------------------------------------------------------------------
_SHUFFLE = [(116, 4, 28), (232, 8, 14), (464, 4, 7)]  # (c_out, units, hw_out)


def shufflenet_v2() -> List[GemmLayer]:
    layers = [_conv("conv1", 224, 3, 24, 3, 2)]
    c_in = 24
    for si, (c, n, hw_out) in enumerate(_SHUFFLE):
        hw_in = hw_out * 2
        half = c // 2
        # downsample unit: two branches
        layers += [
            _conv(f"st{si}_d_b1dw", hw_in, c_in, c_in, 3, 2, groups=c_in),
            _conv(f"st{si}_d_b1pw", hw_out, c_in, half, 1, 1),
            _conv(f"st{si}_d_b2pw1", hw_in, c_in, half, 1, 1),
            _conv(f"st{si}_d_b2dw", hw_in, half, half, 3, 2, groups=half),
            _conv(f"st{si}_d_b2pw2", hw_out, half, half, 1, 1),
        ]
        for u in range(1, n):
            layers += [
                _conv(f"st{si}_u{u}_pw1", hw_out, half, half, 1, 1),
                _conv(f"st{si}_u{u}_dw", hw_out, half, half, 3, 1, groups=half),
                _conv(f"st{si}_u{u}_pw2", hw_out, half, half, 1, 1),
            ]
        c_in = c
    layers.append(_conv("conv5", 7, 464, 1024, 1, 1))
    layers.append(GemmLayer("fc", 1, 1024, 1000))
    return layers


WORKLOADS = {
    "googlenet": googlenet,
    "resnet50": resnet50,
    "mobilenet_v2": mobilenet_v2,
    "shufflenet_v2": shufflenet_v2,
}


def total_macs(name: str) -> int:
    return sum(l.macs for l in WORKLOADS[name]())
