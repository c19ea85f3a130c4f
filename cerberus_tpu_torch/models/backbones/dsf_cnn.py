"""DSF-CNN: the rotation-equivariant steerable-filter encoder (4, 8 or 12
orientations), NCHW.

Counterpart of ``cerberus_tpu/models/backbones/dsf_cnn.py`` (reference
``models/backbone/dsf_cnn.py:6-35``, ``gconv_layers.py:113-306``): the input
pair (a Z2->G k7 G-conv 3->10, then a pre-activation G-conv block
``i2``), then four G-dense blocks, each after a 2x2 stride-2 max-pool.
Returns [x1..x5] at scales [1, 1/2, 1/4, 1/8, 1/16] with [10, 16, 32, 32,
32] channels per orientation.

A dense unit is GBN-ReLU-GConv(k7, 14) -> GBN-ReLU-GConv(k5, 6), its input
the unit inputs so far concatenated inside each orientation; a
GBN-ReLU-GConv(k5) transition maps the block to its output width. Module
names are the reference's (``backbone.d1.units.0.norm1.norm.weight``).
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..gconv import GBatchNorm2d, GConv2d, group_concat_channels

# G-dense blocks: (name, in_ch, out_ch, unit count)
DENSE_BLOCKS = [("d1", 10, 16, 3), ("d2", 16, 32, 4), ("d3", 32, 32, 5),
                ("d4", 32, 32, 6)]
UNIT_KSIZE = [7, 5]
UNIT_CH = [14, 6]


class PreActGConv(nn.Module):
    """GBN -> ReLU -> G-conv (G->G), the reference's ``pre_bn`` / ``conv``."""

    def __init__(self, in_ch: int, out_ch: int, ksize: int, nr_orients: int):
        super().__init__()
        self.pre_bn = GBatchNorm2d(in_ch, nr_orients)
        self.conv = GConv2d(in_ch, out_ch, ksize, nr_orients, nr_orients)

    def forward(self, x):
        return self.conv(F.relu(self.pre_bn(x)))


class GConvBlock(nn.Module):
    """A sequence of pre-activation G-conv layers under ``block.<i>``."""

    def __init__(self, in_ch: int, unit_ch, ksize: int, nr_orients: int):
        super().__init__()
        layers = []
        for out_ch in unit_ch:
            layers.append(PreActGConv(in_ch, out_ch, ksize, nr_orients))
            in_ch = out_ch
        self.block = nn.ModuleList(layers)

    def forward(self, x):
        for layer in self.block:
            x = layer(x)
        return x


class _DenseUnit(nn.Module):
    def __init__(self, in_ch: int, nr_orients: int):
        super().__init__()
        self.norm1 = GBatchNorm2d(in_ch, nr_orients)
        self.conv1 = GConv2d(in_ch, UNIT_CH[0], UNIT_KSIZE[0], nr_orients,
                             nr_orients)
        self.norm2 = GBatchNorm2d(UNIT_CH[0], nr_orients)
        self.conv2 = GConv2d(UNIT_CH[0], UNIT_CH[1], UNIT_KSIZE[1],
                             nr_orients, nr_orients)

    def forward(self, x):
        x = self.conv1(F.relu(self.norm1(x)))
        return self.conv2(F.relu(self.norm2(x)))


class _Transition(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, nr_orients: int):
        super().__init__()
        self.bn = GBatchNorm2d(in_ch, nr_orients)
        self.conv = GConv2d(in_ch, out_ch, 5, nr_orients, nr_orients)

    def forward(self, x):
        return self.conv(F.relu(self.bn(x)))


class GDenseBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, n_units: int,
                 nr_orients: int):
        super().__init__()
        self.nr_orients = nr_orients
        self.units = nn.ModuleList(
            [_DenseUnit(in_ch + UNIT_CH[1] * u, nr_orients)
             for u in range(n_units)])
        self.transition = _Transition(in_ch + UNIT_CH[1] * n_units, out_ch,
                                      nr_orients)

    def forward(self, x):
        feats = [x]
        for unit in self.units:
            feats.append(unit(group_concat_channels(feats, self.nr_orients)))
        return self.transition(group_concat_channels(feats, self.nr_orients))


class DSF_CNN(nn.Module):
    """``forward(x)``: (N, 3, H, W) -> [x1..x5], each (N, O*C_i, ...)."""

    def __init__(self, nr_orients: int):
        super().__init__()
        self.i1 = GConv2d(3, 10, 7, 1, nr_orients)
        self.i2 = GConvBlock(10, [10], 7, nr_orients)
        for name, in_ch, out_ch, n_units in DENSE_BLOCKS:
            setattr(self, name, GDenseBlock(in_ch, out_ch, n_units,
                                            nr_orients))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.i2(self.i1(x))
        feats = [x]
        for name, *_ in DENSE_BLOCKS:
            x = getattr(self, name)(F.max_pool2d(x, 2, 2))
            feats.append(x)
        return feats
