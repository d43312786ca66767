"""The paper's four CNN workloads as IMC layer tables.

A *workload* is a list of layer descriptors; each descriptor is the 6-tuple

    (M, K, N, A_in, A_out, groups)

where  M      = # weight-stationary vector presentations (output positions),
       K      = fan-in per group (crossbar rows needed),
       N      = output channels per group (crossbar cols / cells_per_weight),
       A_in   = unique input activations (bytes at 8-bit),
       A_out  = unique output activations,
       groups = convolution groups (depthwise: groups == channels).

Tables are *derived* from real architecture specs (kernel/stride/channels per
layer), not hand-copied: ``_trace`` walks the net and does the conv
arithmetic.  Sources: VGG16 [18], ResNet18 [19], AlexNet [35],
MobileNetV3-Large [36] (table 1 of the paper, incl. SE blocks).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

Layer = Tuple[int, int, int, int, int, int]


@dataclasses.dataclass
class _St:
    h: int
    w: int
    c: int
    layers: List[Layer]

    def conv(self, cout: int, k: int, s: int = 1, p: int = None, groups: int = 1):
        if p is None:
            p = k // 2
        ho = (self.h + 2 * p - k) // s + 1
        wo = (self.w + 2 * p - k) // s + 1
        m = ho * wo
        kin = (self.c // groups) * k * k
        n = cout // groups
        self.layers.append(
            (m, kin, n, self.h * self.w * self.c, ho * wo * cout, groups)
        )
        self.h, self.w, self.c = ho, wo, cout
        return self

    def dwconv(self, k: int, s: int = 1):
        return self.conv(self.c, k, s, groups=self.c)

    def pool(self, k: int = 2, s: int = None):
        s = s or k
        self.h = (self.h - k) // s + 1
        self.w = (self.w - k) // s + 1
        return self

    def gap(self):  # global average pool
        self.h = self.w = 1
        return self

    def fc(self, cout: int):
        cin = self.h * self.w * self.c
        self.layers.append((1, cin, cout, cin, cout, 1))
        self.h = self.w = 1
        self.c = cout
        return self


def _vgg16() -> List[Layer]:
    s = _St(224, 224, 3, [])
    for blk in ([64, 64], [128, 128], [256, 256, 256], [512, 512, 512], [512, 512, 512]):
        for c in blk:
            s.conv(c, 3)
        s.pool()
    s.fc(4096).fc(4096).fc(1000)
    return s.layers


def _resnet18() -> List[Layer]:
    s = _St(224, 224, 3, [])
    s.conv(64, 7, 2, 3).pool(3, 2)
    for stage, (c, n_blocks, stride) in enumerate(
        [(64, 2, 1), (128, 2, 2), (256, 2, 2), (512, 2, 2)]
    ):
        for b in range(n_blocks):
            st = stride if b == 0 else 1
            if st != 1 or s.c != c:
                # downsample shortcut 1x1 (counted once per stage entry)
                hs, ws, cs = s.h, s.w, s.c
                ho = (hs - 1) // st + 1
                s.layers.append(
                    (ho * ho, cs, c, hs * ws * cs, ho * ho * c, 1)
                )
            s.conv(c, 3, st)
            s.conv(c, 3, 1)
    s.gap().fc(1000)
    return s.layers


def _alexnet() -> List[Layer]:
    s = _St(227, 227, 3, [])
    s.conv(96, 11, 4, 0).pool(3, 2)
    s.conv(256, 5, 1, 2).pool(3, 2)
    s.conv(384, 3).conv(384, 3).conv(256, 3).pool(3, 2)
    s.fc(4096).fc(4096).fc(1000)
    return s.layers


# MobileNetV3-Large bneck table [36]: (k, exp, out, SE, stride)
_MBV3 = [
    (3, 16, 16, False, 1),
    (3, 64, 24, False, 2),
    (3, 72, 24, False, 1),
    (5, 72, 40, True, 2),
    (5, 120, 40, True, 1),
    (5, 120, 40, True, 1),
    (3, 240, 80, False, 2),
    (3, 200, 80, False, 1),
    (3, 184, 80, False, 1),
    (3, 184, 80, False, 1),
    (3, 480, 112, True, 1),
    (3, 672, 112, True, 1),
    (5, 672, 160, True, 2),
    (5, 960, 160, True, 1),
    (5, 960, 160, True, 1),
]


def _mobilenetv3() -> List[Layer]:
    s = _St(224, 224, 3, [])
    s.conv(16, 3, 2)
    for k, exp, out, se, stride in _MBV3:
        if exp != s.c:
            s.conv(exp, 1)  # expand
        s.dwconv(k, stride)  # depthwise — maps terribly onto crossbars
        if se:  # squeeze-excite: two tiny FCs on pooled features
            cin = s.c
            red = max(8, int(np.ceil(cin / 4 / 8) * 8))
            s.layers.append((1, cin, red, cin, red, 1))
            s.layers.append((1, red, cin, red, cin, 1))
        s.conv(out, 1)  # project
    s.conv(960, 1)
    s.gap()
    s.fc(1280).fc(1000)
    return s.layers


CNN_WORKLOADS: Dict[str, List[Layer]] = {}


def cnn_workload(name: str) -> List[Layer]:
    if not CNN_WORKLOADS:
        CNN_WORKLOADS.update(
            vgg16=_vgg16(),
            resnet18=_resnet18(),
            alexnet=_alexnet(),
            mobilenetv3=_mobilenetv3(),
        )
    return CNN_WORKLOADS[name]


PAPER_WORKLOADS = ("vgg16", "resnet18", "alexnet", "mobilenetv3")
