"""Plain 5-stage double-conv U-Net encoder (64..1024 channels).

Counterpart of ``cerberus_tpu/models/backbones/unet_encoder.py`` (reference
``models/backbone/unet_encoder.py:4-62``): stage 1 has no downsampling,
stages 2-5 start with a 2x2 max pool, each stage is 2 x (3x3 conv with
bias + BN + ReLU); forward returns the five stages' outputs.
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import batch_norm

STAGE_CH = [(3, 64), (64, 128), (128, 256), (256, 512), (512, 1024)]


class _Stage(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.bn1 = batch_norm(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.bn2 = batch_norm(cout)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(x)))


class UNetEncoder(nn.Module):
    def __init__(self):
        super().__init__()
        for stage, (cin, cout) in enumerate(STAGE_CH, start=1):
            self.add_module("module%d" % stage, _Stage(cin, cout))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        for stage in range(1, 6):
            if stage > 1:
                x = F.max_pool2d(x, 2)
            x = getattr(self, "module%d" % stage)(x)
            feats.append(x)
        return feats
