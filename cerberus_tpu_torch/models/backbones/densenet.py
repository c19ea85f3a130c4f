"""DenseNet-121 encoder with a stride-1 stem.

Counterpart of ``cerberus_tpu/models/backbones/densenet.py`` and the
reference's ``models/backbone/densenet.py`` (torchvision's densenet121 with
the 7x7 stem at stride 1, :202-210). Forward returns the 5-scale pyramid
[x0 (stem), x1 (block 1), x2, x3, x4 (norm5 of block 4)] (:257-279); x4
passes the last batch norm but no ReLU. Module names are torchvision's
(``features.denseblock1.denselayer1.conv1``), so the reference state_dict
loads as is.
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import batch_norm

GROWTH = 32
BLOCK_CONFIG = (6, 12, 24, 16)
BN_SIZE = 4
INIT_FEATURES = 64


class _DenseLayer(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.norm1 = batch_norm(cin)
        self.conv1 = nn.Conv2d(cin, BN_SIZE * GROWTH, 1, bias=False)
        self.norm2 = batch_norm(BN_SIZE * GROWTH)
        self.conv2 = nn.Conv2d(BN_SIZE * GROWTH, GROWTH, 3, padding=1,
                               bias=False)

    def forward(self, x):
        y = self.conv1(F.relu(self.norm1(x)))
        y = self.conv2(F.relu(self.norm2(y)))
        return torch.cat([x, y], dim=1)


class _Transition(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.norm = batch_norm(cin)
        self.conv = nn.Conv2d(cin, cin // 2, 1, bias=False)

    def forward(self, x):
        return F.avg_pool2d(self.conv(F.relu(self.norm(x))), 2)


class DenseNet121(nn.Module):
    def __init__(self):
        super().__init__()
        features = nn.Module()
        features.conv0 = nn.Conv2d(3, INIT_FEATURES, 7, padding=3,
                                   bias=False)
        features.norm0 = batch_norm(INIT_FEATURES)
        n = INIT_FEATURES
        for bi, n_layers in enumerate(BLOCK_CONFIG, start=1):
            block = nn.Module()
            for li in range(1, n_layers + 1):
                block.add_module("denselayer%d" % li,
                                 _DenseLayer(n + (li - 1) * GROWTH))
            features.add_module("denseblock%d" % bi, block)
            n += n_layers * GROWTH
            if bi != len(BLOCK_CONFIG):
                features.add_module("transition%d" % bi, _Transition(n))
                n //= 2
        features.norm5 = batch_norm(n)
        self.features = features

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        f = self.features
        x0 = F.relu(f.norm0(f.conv0(x)))
        x = F.max_pool2d(x0, 3, 2, 1)
        feats = [x0]
        for bi in range(1, 5):
            if bi > 1:
                x = getattr(f, "transition%d" % (bi - 1))(x)
            for layer in getattr(f, "denseblock%d" % bi).children():
                x = layer(x)
            feats.append(f.norm5(x) if bi == 4 else x)
        return feats
