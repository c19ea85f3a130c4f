"""Stride-1-stem ResNet encoders (18/34/50/101/152) as ``nn.Module``s.

Counterpart of ``cerberus_tpu/models/backbones/resnet.py:28-128`` and the
reference's modified torchvision ResNet (``models/backbone/resnet.py``):
the 7x7 stem conv has stride 1, so forward returns the 5-scale pyramid
``[x0..x4]`` at [1, 1/2, 1/4, 1/8, 1/16]. Module names follow torchvision
(``layer2.0.downsample.0``) so the reference state_dict loads as is.
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import batch_norm, conv2d, max_pool_3x3_s2

# arch -> (block kind, per-stage block counts)
RESNET_SPECS = {
    "resnet18": ("basic", [2, 2, 2, 2]),
    "resnet34": ("basic", [3, 4, 6, 3]),
    "resnet50": ("bottleneck", [3, 4, 6, 3]),
    "resnet101": ("bottleneck", [3, 4, 23, 3]),
    "resnet152": ("bottleneck", [3, 8, 36, 3]),
}
STAGE_PLANES = [64, 128, 256, 512]
EXPANSION = {"basic": 1, "bottleneck": 4}


class _Block(nn.Module):
    def __init__(self, kind: str, inplanes: int, planes: int, stride: int):
        super().__init__()
        exp = EXPANSION[kind]
        if kind == "basic":
            shapes = [(3, inplanes, planes, stride), (3, planes, planes, 1)]
        else:  # torchvision bottleneck: stride on the 3x3
            shapes = [(1, inplanes, planes, 1), (3, planes, planes, stride),
                      (1, planes, planes * exp, 1)]
        self.n_convs = len(shapes)
        for i, (k, cin, cout, s) in enumerate(shapes):
            setattr(self, "conv%d" % (i + 1),
                    nn.Conv2d(cin, cout, k, stride=s, padding=k // 2,
                              bias=False))
            setattr(self, "bn%d" % (i + 1), batch_norm(cout))
        self.downsample = None
        if stride != 1 or inplanes != planes * exp:
            self.downsample = nn.Sequential(
                conv2d(inplanes, planes * exp, 1, stride=stride, bias=False),
                batch_norm(planes * exp))

    def forward(self, x):
        out = x
        for i in range(1, self.n_convs + 1):
            out = getattr(self, "bn%d" % i)(getattr(self, "conv%d" % i)(out))
            if i < self.n_convs:
                out = F.relu(out)
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNet(nn.Module):
    def __init__(self, arch: str):
        super().__init__()
        kind, counts = RESNET_SPECS[arch]
        self.conv1 = nn.Conv2d(3, 64, 7, stride=1, padding=3, bias=False)
        self.bn1 = batch_norm(64)
        self.maxpool = max_pool_3x3_s2()
        inplanes = 64
        for stage, (planes, n_blocks) in enumerate(zip(STAGE_PLANES, counts)):
            blocks = []
            for b in range(n_blocks):
                stride = 2 if stage > 0 and b == 0 else 1
                blocks.append(_Block(kind, inplanes, planes, stride))
                inplanes = planes * EXPANSION[kind]
            setattr(self, "layer%d" % (stage + 1), nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x0 = F.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x0)
        feats = [x0]
        for stage in range(1, 5):
            x = getattr(self, "layer%d" % stage)(x)
            feats.append(x)
        return feats
