"""Layer helpers with the reference's torch semantics (NCHW inside the port).

Counterpart of ``cerberus_tpu/models/layers.py:28-133``: convolutions pad
``k // 2`` on each side (torch style), batch norm runs in eval mode with
``BN_EPS``, ``MaxPool2d(3, 2, 1)``, bilinear 2x upsampling with half-pixel
centres (``F.interpolate(..., align_corners=False)``, the same function as
the JAX separable formulation) and a floor-offset centre crop.

``ConvBNReLU.forward_valid`` / ``ConvBlock.forward_valid`` apply the same
modules with padding 0 (the counterpart of
``cerberus_tpu/models/valid_decode.py:94-99``): the interior values of the
padded convolution, on the module's own weights, so one ``state_dict``
drives both the full-tower and the valid-region path.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-5


def conv2d(cin: int, cout: int, ksize: int, stride: int = 1,
           bias: bool = True) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, ksize, stride=stride, padding=ksize // 2,
                     bias=bias)


def batch_norm(channels: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=BN_EPS)


def max_pool_3x3_s2() -> nn.MaxPool2d:
    return nn.MaxPool2d(kernel_size=3, stride=2, padding=1)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Bilinear 2x upsample, half-pixel centres, edge-clamped (the
    reference's ``upsample2x``, models/utils/net_layers.py:45-46)."""
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=False)


def center_crop(x: torch.Tensor, crop_h: int, crop_w: int) -> torch.Tensor:
    """Crop the last two (H, W) dims around the centre, floor offset
    (reference ``models/utils/misc_utils.py:6-25``)."""
    h0 = int((x.shape[-2] - crop_h) * 0.5)
    w0 = int((x.shape[-1] - crop_w) * 0.5)
    return x[..., h0:h0 + crop_h, w0:w0 + crop_w]


class ConvBNReLU(nn.Module):
    """One ``ConvBlock`` layer: conv + eval BN + ReLU, with the reference's
    ``block.<i>.conv`` / ``block.<i>.bn`` parameter names."""

    def __init__(self, cin: int, cout: int, ksize: int):
        super().__init__()
        self.conv = conv2d(cin, cout, ksize)
        self.bn = batch_norm(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))

    def forward_valid(self, x):
        """The same layer with padding 0: each side shrinks by ``k // 2``."""
        return F.relu(self.bn(F.conv2d(x, self.conv.weight, self.conv.bias)))


class ConvBlock(nn.Module):
    """Sequence of conv+BN+ReLU layers (reference conv_layers.py:63-103)."""

    def __init__(self, cin: int, unit_ch, ksize: int):
        super().__init__()
        layers = []
        for cout in unit_ch:
            layers.append(ConvBNReLU(cin, cout, ksize))
            cin = cout
        self.block = nn.ModuleList(layers)

    def forward(self, x):
        for layer in self.block:
            x = layer(x)
        return x

    def forward_valid(self, x):
        for layer in self.block:
            x = layer.forward_valid(x)
        return x
