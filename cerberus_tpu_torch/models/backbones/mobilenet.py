"""MobileNetV2 encoder with a stride-1 stem.

Counterpart of ``cerberus_tpu/models/backbones/mobilenet.py`` and the
reference's ``models/backbone/mobilenet.py``: the stem at stride 1 (:143),
torchvision's inverted-residual stack, and the reference's capture quirk
(:132-157, 189-210): the stride-2 blocks' indices are counted over the
blocks, but forward enumerates ``features`` with the stem at index 0, so
the pyramid is the INPUT of ``features[i]`` for those indices: [stem 32 ch
at 1x, 24 ch at 1/2, 32 ch at 1/4, 96 ch at 1/8 (after two of the three
96-channel blocks), the last 1x1 conv's 1280 ch at 1/16]. Module names are
torchvision's (``features.{i}.conv.{j}``); the depthwise 3x3 convs have
``groups`` equal to their channels.
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn as nn

from ..layers import batch_norm

# t (expand), c (out ch), n (repeats), s (first-block stride)
IR_SETTING = [
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
]
STEM_CH = 32
LAST_CH = 1280


def block_plan():
    """[(features index, cin, cout, stride, expand)] and the capture
    indices (block counters of the stride-2 blocks, the reference's
    off-by-one kept)."""
    plan, ds_idx_list = [], []
    cin = STEM_CH
    for layer_idx, (t, c, stride) in enumerate(
            (t, c, s if i == 0 else 1)
            for t, c, n, s in IR_SETTING for i in range(n)):
        plan.append((layer_idx + 1, cin, c, stride, t))
        if stride != 1:
            ds_idx_list.append(layer_idx)
        cin = c
    return plan, ds_idx_list


def _conv_bn_relu6(cin, cout, ksize, stride=1, groups=1) -> nn.Sequential:
    return nn.Sequential(
        nn.Conv2d(cin, cout, ksize, stride=stride, padding=ksize // 2,
                  groups=groups, bias=False),
        batch_norm(cout), nn.ReLU6())


class _InvertedResidual(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, expand: int):
        super().__init__()
        hidden = int(round(cin * expand))
        layers = []
        if expand != 1:
            layers.append(_conv_bn_relu6(cin, hidden, 1))
        layers += [_conv_bn_relu6(hidden, hidden, 3, stride, groups=hidden),
                   nn.Conv2d(hidden, cout, 1, bias=False), batch_norm(cout)]
        self.conv = nn.Sequential(*layers)
        self.residual = stride == 1 and cin == cout

    def forward(self, x):
        y = self.conv(x)
        return x + y if self.residual else y


class MobileNetV2(nn.Module):
    def __init__(self):
        super().__init__()
        plan, self.ds_idx_list = block_plan()
        self.features = nn.Sequential(
            _conv_bn_relu6(3, STEM_CH, 3),
            *[_InvertedResidual(cin, cout, stride, t)
              for _fi, cin, cout, stride, t in plan],
            _conv_bn_relu6(plan[-1][2], LAST_CH, 1))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        for fi, layer in enumerate(self.features):
            if fi in self.ds_idx_list:
                feats.append(x)
            x = layer(x)
        feats.append(x)
        return feats
